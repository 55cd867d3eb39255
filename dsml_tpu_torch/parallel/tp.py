"""Megatron tensor parallelism over a ``tp`` group — the counterparts of the
``lax.psum`` calls ``dsml_tpu/models/gpt2.py`` and ``models/llama.py`` make
under ``shard_map`` with ``tp_axis``.

The JAX step differentiates OUTSIDE ``shard_map``, so each psum's transpose
assigns its cotangent. Here each tp rank is a process that differentiates
its own program, so the pair of conjugate operations is placed by hand
(Megatron-LM's ``f`` and ``g``):

- :func:`copy_to_tp` — identity forward, all-reduce backward: in front of
  every column-parallel projection (``wqkv``/``w_in``, Llama's ``wq``/
  ``wk``/``wv``/``w_gate``/``w_up``, and the vocab-parallel unembedding).
  The replicated activation feeds a rank-local shard, so its cotangent is a
  per-rank partial that the backward sums.
- :func:`reduce_from_tp` — all-reduce forward, identity backward: after
  every row-parallel projection (``wo``/``w_out``/``w_down``) and after the
  vocab-sharded embedding's masked gather (Megatron psums #1, #2 and the
  embedding psum).

With every rank seeding its (identical) loss with 1, the replicated leaves
(norms, ``bo``, ``b_out``, ``wpe``) come out with the single-device
gradient on every rank and the sharded leaves with its slice, as the JAX
step's outer gradient gives them.

:func:`vocab_parallel_xent` is ``_head_loss_spmd``'s tp > 1 branch: the
distributed logsumexp (a max-shift carrying no gradient, the summed
exponentials and the target logit each all-reduced) with a backward of its
own, ``softmax − onehot`` on the rank's vocab shard, that needs no
communication. :func:`vocab_parallel_embed` is ``_embed_spmd``'s masked
gather.

The expert-parallel MoE block (``models/gpt2.py::GPT2._moe_block``) routes
each rank's 1/tp slice of the replicated tokens, so it adds three pairs
over a token axis: :func:`split_to_tp` (the rank's slice forward, an
all-gather of the slices' cotangents backward: each rank's block input
gets every rank's share), :func:`gather_from_tp` (an all-gather forward,
the rank's slice of the replicated cotangent backward, never a sum) and
:func:`all_gather_tp` (an all-gather forward whose uses differ by rank, so
its backward is the JAX transpose, a reduce-scatter of the partial
cotangents). Serving gathers the vocab-sharded logits with it too.

Routing follows the tensors' device: CPU tensors reduce through gloo
(``all_reduce(..., "xla")``), CUDA tensors through the group's CUDA IPC
ring (``"auto"``: the gather-and-sum at tp ≤ 3, the ring above). bf16 sums
round once, as ``lax.psum`` does. :data:`STATS` counts the all-reduces and
their payload bytes, and the :func:`all_gather_tp` calls and the bytes of
the shards they gather (the serving logits' all-gather among them); the
chip check reads them per step and per tick.
"""

from __future__ import annotations

import torch

from dsml_tpu_torch.ops.collectives import ReduceOp, all_gather, all_reduce, reduce_scatter

__all__ = ["STATS", "all_gather_tp", "copy_to_tp", "gather_from_tp", "reduce_from_tp",
           "reset_stats", "split_to_tp", "tp_all_reduce", "vocab_parallel_embed",
           "vocab_parallel_xent", "tp_size", "tp_rank"]

STATS = {"all_reduce": 0, "bytes": 0, "all_gather": 0, "gather_bytes": 0}


def reset_stats() -> None:
    STATS.update(all_reduce=0, bytes=0, all_gather=0, gather_bytes=0)


def tp_size(group) -> int:
    return 1 if group is None else group.size


def tp_rank(group) -> int:
    return 0 if group is None else group.rank


def tp_all_reduce(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the tp group (a new tensor; ``x`` itself when the group
    has one rank): gloo for CPU tensors, the CUDA IPC ring for CUDA ones."""
    if tp_size(group) == 1:
        return x
    STATS["all_reduce"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    return all_reduce(x.contiguous(), group, op, "xla" if x.device.type == "cpu" else "auto")


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron ``f``: identity forward, all-reduce backward."""
    return x if tp_size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron ``g``: all-reduce forward, identity backward."""
    return x if tp_size(group) == 1 else _ReduceFromTP.apply(x, group)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


class _SplitToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return all_gather(g.contiguous(), group, axis=dim), None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return all_gather(x.contiguous(), group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _slice(g, group, dim), None, None


class _AllGatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return all_gather(x.contiguous(), group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return reduce_scatter(g.movedim(dim, 0).contiguous(), group).movedim(0, dim), None, None


def split_to_tp(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous 1/tp slice of the replicated ``x`` along
    ``dim``; backward all-gathers the slices' cotangents (each rank's
    share of the replicated input's gradient)."""
    return x if tp_size(group) == 1 else _SplitToTP.apply(x, group, dim)


def gather_from_tp(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` into a replicated
    tensor; backward hands each rank its own slice of the (replicated)
    cotangent."""
    return x if tp_size(group) == 1 else _GatherFromTP.apply(x, group, dim)


def all_gather_tp(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, for uses that differ
    by rank: backward reduce-scatters the per-rank partial cotangents (the
    JAX ``all_gather``'s transpose, ``psum_scatter``)."""
    if tp_size(group) == 1:
        return x
    STATS["all_gather"] += 1
    STATS["gather_bytes"] += x.numel() * x.element_size()
    return _AllGatherTP.apply(x, group, dim)


def vocab_parallel_embed(wte_shard: torch.Tensor, tokens: torch.Tensor, group) -> torch.Tensor:
    """Rows of the vocab-sharded embedding: each token's row lives on the
    one rank whose shard holds its id, so every rank gathers its own rows,
    zeroes the others and the all-reduce assembles them (``_embed_spmd``)."""
    if tp_size(group) == 1:
        return wte_shard[tokens]
    shard = wte_shard.shape[0]
    local = tokens - tp_rank(group) * shard
    inside = (local >= 0) & (local < shard)
    rows = wte_shard[local.clamp(0, shard - 1)] * inside[..., None].to(wte_shard.dtype)
    return reduce_from_tp(rows, group)


class _VocabParallelXent(torch.autograd.Function):
    """Mean cross-entropy of f32 vocab-shard logits ``[n, v/tp]``."""

    @staticmethod
    def forward(ctx, logits, targets, group):
        shard = logits.shape[-1]
        # the max-shift carries no gradient (the JAX stop_gradient)
        gmax = tp_all_reduce(logits.max(-1, keepdim=True).values, group, ReduceOp.MAX)
        e = torch.exp(logits - gmax)
        sumexp = tp_all_reduce(e.sum(-1, keepdim=True), group)
        local = targets - tp_rank(group) * shard
        inside = (local >= 0) & (local < shard)
        safe = local.clamp(0, shard - 1)
        tgt = logits.gather(-1, safe[:, None])
        tgt = tp_all_reduce(torch.where(inside[:, None], tgt, torch.zeros_like(tgt)), group)
        loss = (torch.log(sumexp) + gmax - tgt).mean()
        ctx.save_for_backward(e, sumexp, inside, safe)
        return loss

    @staticmethod
    def backward(ctx, g):
        e, sumexp, inside, safe = ctx.saved_tensors
        scale = g / e.shape[0]
        grad = e / sumexp * scale
        grad.scatter_add_(-1, safe[:, None], -(inside[:, None].to(grad.dtype) * scale))
        return grad, None, None


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor, group) -> torch.Tensor:
    """Mean next-token cross-entropy of vocab-sharded f32 ``logits`` [...,
    v/tp] against global ``targets`` [...] — ``_head_loss_spmd`` at tp > 1.
    The value is the same on every rank."""
    return _VocabParallelXent.apply(logits.reshape(-1, logits.shape[-1]),
                                    targets.reshape(-1).long(), group)
