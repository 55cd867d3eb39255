"""The hybrid train step on the meshes the port serves — the cp and the dp
slices of ``dsml_tpu/parallel/hybrid.py``.

The JAX step is one jitted SPMD program over the mesh: parameters
replicated, the batch sharded over dp and the sequence over cp, the loss
``pmean``-ed over the batch and sequence axes, and the shard_map transpose
summing each replicated parameter's gradient over the ranks. Here each
rank is one process running :func:`make_hybrid_train_step`'s ``step``:

1. it takes its share of the global batch: its contiguous sequence shard
   on a cp mesh, its contiguous rows on a dp mesh;
2. on cp, the per-rank loss (``GPT2.loss`` with ``sp_group``: ring
   attention, the rank's own cross-entropy) is scaled by 1/cp and
   differentiated, so the ring attention's backward carries every rank's
   cotangents of this rank's K/V home; the gradients are then summed over
   the cp group (one flat buffer through the ring all-reduce: gloo for
   CPU tensors, the CUDA IPC transport for CUDA tensors), the global mean
   loss likewise;
3. on dp, the microbatch gradients of the rank's rows are summed and
   divided by ``grad_accum``, then averaged over the dp group once per
   step: ``dp_sync="xla"`` through the process group's own ``all_reduce``
   of one flat buffer, any explicit algorithm, the quantized ones
   included, through ``parallel.bucketing.bucketed_all_reduce`` (the JAX
   step's explicit sync, ``dsml_tpu/parallel/hybrid.py:281-345``), so
   quantization noise enters once per step, not once per microbatch;
4. clip by global norm (optax's rule) and the optimizer run on every rank
   on identical gradients, so the replicas stay identical.

Pipeline schedules and microbatched pipelines raise and name their ROADMAP
item; an explicit ``dp_sync`` on a mesh with another sized axis raises, as
in the JAX package.

Observability, as the JAX step writes it: every step lands a memory-ledger
peak watermark (``note_step_peak``, an allocator statistic read on the
host: no device sync); an explicit ``dp_sync`` records its bucket plan
(``obs.record_collective_plan``) once per batch signature, where the JAX
step records it once per compilation; the first step, which allocates
``torch.optim``'s state, claims the parameters and that state in the
ledger (the JAX ``init_hybrid`` claims them at initialisation: optax's
state exists before the first update, torch's after it).
"""

from __future__ import annotations

import torch

from dsml_tpu_torch.obs import record_collective_plan
from dsml_tpu_torch.obs.memory import get_memory_ledger
from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce
from dsml_tpu_torch.parallel.bucketing import (bucketed_all_reduce, default_bucket_mb,
                                               is_quantized_algorithm)
from dsml_tpu_torch.parallel.dp import named_params, rank_rows
from dsml_tpu_torch.parallel.mesh import _NOT_PORTED, Mesh

__all__ = ["default_attn_impl", "hybrid_eval_loss", "hybrid_loss_fn", "init_hybrid",
           "make_hybrid_train_step"]


def default_attn_impl(mesh: Mesh) -> str:
    """What ``attn_impl=None`` resolves to on this mesh, as in the JAX
    package: the flash ring ``"ring2"`` when cp is sized, else the XLA ring
    ``"ring"`` (on an unsharded sequence the JAX model routes that to plain
    attention, and so does :func:`hybrid_loss_fn`)."""
    return "ring2" if mesh.shape.get("cp", 1) > 1 else "ring"


def _seq_group(mesh: Mesh):
    return mesh.group("cp") if mesh.spec.seq_axis() == "cp" else None


def hybrid_loss_fn(model, attn_impl: str = "ring", seq_group=None):
    """Per-rank loss closure ``loss_fn(x, y)`` over this rank's sequence
    shard: positions offset by the shard origin and the rank's own
    cross-entropy, as the JAX ``hybrid_loss_fn`` with ``seq_axis``. On an
    unsharded sequence the XLA ring ``"ring"`` is plain attention
    (``"xla"``), as the JAX model's ``_route_attention`` routes a ring of
    one."""
    if attn_impl == "ring" and (seq_group is None or seq_group.size == 1):
        attn_impl = "xla"

    def loss_fn(x, y):
        return model.loss(x, y, attn_impl=attn_impl, sp_group=seq_group)

    return loss_fn


def init_hybrid(model, optimizer, mesh: Mesh, seed: int = 0):
    """Fill the weights from ``seed`` on every rank: parameters are
    replicated over cp, and the same seed gives the same weights
    (``GPT2.init`` draws them from numpy). Returns ``(model, optimizer)``."""
    del mesh  # every rank holds the whole model
    model.init(seed)
    return model, optimizer


def _shard(t, group):
    """This rank's contiguous share of the sequence axis of ``t`` [b, S]."""
    t = torch.as_tensor(t)
    if group is None:
        return t
    s = t.shape[1]
    if s % group.size:
        raise ValueError(f"sequence {s} not divisible by cp={group.size}")
    n = s // group.size
    return t[:, group.rank * n:(group.rank + 1) * n]


def make_hybrid_train_step(model, optimizer, mesh: Mesh, attn_impl: str | None = None,
                           grad_accum: int = 1, n_microbatches: int = 1,
                           schedule: str = "gpipe", dp_sync: str = "xla",
                           clip_norm: float = 0.0, bucket_size_mb: float | None | str = "auto"):
    """Build ``step(x, y, lr=None) -> loss`` for a cp or a dp mesh. ``x``/``y``
    are the GLOBAL batch [batch, seq] (every rank passes the same); each
    rank trains on its sequence shard (cp) or its rows (dp). With
    ``grad_accum > 1`` the rank's batch splits into that many microbatches
    whose gradients are summed and divided by ``grad_accum`` (as the JAX
    step). ``dp_sync`` picks the dp gradient sync: ``"xla"``, the process
    group's own ``all_reduce``, or an explicit algorithm (``"ring"``,
    ``"ring2"``, ``"naive"``, ``"auto"``, or a quantized one: ``"q8"``,
    ``"q8_ring"``, ``"q8_ring2"``, ``"q4_ring"``, ``"q4_ring2"``,
    ``"quant"``) through ``bucketed_all_reduce`` with ``bucket_size_mb``
    (``"auto"`` = the ``DSML_BUCKET_MB`` default, ``None`` = one buffer),
    once per step. Error feedback is the dp step's option
    (``parallel.dp.make_dp_train_step``), as in the JAX package.
    ``clip_norm > 0`` clips the synced gradients by global norm (the JAX
    example's ``optax.chain`` puts the clip in the optimizer); ``lr`` sets
    every group's learning rate before the update. Returns the global mean
    loss (a device scalar, identical on every rank)."""
    if schedule != "gpipe" or n_microbatches != 1 or mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError("pipeline schedules (pp, n_microbatches) " + _NOT_PORTED.format(11))
    if dp_sync != "xla":
        busy = {a: s for a in ("pp", "fsdp", "sp", "cp", "tp") if (s := mesh.shape.get(a, 1)) > 1}
        if busy:
            raise ValueError(f"dp_sync={dp_sync!r} requires a dp-only mesh; got {busy} — "
                             "use dp_sync='xla' on multi-axis meshes")
    # the loss mean is exact: a quantized name is no all_reduce algorithm
    loss_sync = "ring" if is_quantized_algorithm(dp_sync) else dp_sync
    mb = default_bucket_mb() if bucket_size_mb == "auto" else bucket_size_mb
    seq_group, dp_group = _seq_group(mesh), mesh.group("dp")
    if attn_impl is None:
        attn_impl = default_attn_impl(mesh)
    loss_fn = hybrid_loss_fn(model, attn_impl, seq_group)
    n_seq = 1 if seq_group is None else seq_group.size
    params = [p for _, p in named_params(model, optimizer)]
    ledger = get_memory_ledger()
    signatures = set()  # the batch signatures seen: where jit would trace

    def step(x, y, lr: float | None = None):
        x = rank_rows(_shard(x, seq_group), dp_group).to(model.device).long()
        y = rank_rows(_shard(y, seq_group), dp_group).to(model.device).long()
        sig = (tuple(x.shape), tuple(y.shape))
        first = sig not in signatures
        if first:
            signatures.add(sig)
            if dp_sync != "xla":
                record_collective_plan(dp_sync, params, mb, "dp")
        if x.shape[0] % grad_accum:
            raise ValueError(f"per-rank batch {x.shape[0]} not divisible by grad_accum={grad_accum}")
        micro = x.shape[0] // grad_accum
        optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for m in range(grad_accum):
            rows = slice(m * micro, (m + 1) * micro)
            micro_loss = loss_fn(x[rows], y[rows])
            # the gradient of the global mean: every rank seeds 1/cp, and the
            # ring's backward carries each rank's share home
            (micro_loss / n_seq).backward()
            loss += micro_loss.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if seq_group is not None:
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), seq_group,
                              ReduceOp.SUM, "ring")
            torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
                flat.split([g.numel() for g in grads]), grads)])
            loss = all_reduce(loss, seq_group, ReduceOp.SUM, "ring")
        if grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
        loss = loss / (n_seq * grad_accum)
        if dp_group is not None:
            grads = bucketed_all_reduce(grads, dp_group, ReduceOp.AVG, dp_sync,
                                        None if dp_sync == "xla" else mb)
            loss = all_reduce(loss, dp_group, ReduceOp.AVG, loss_sync)
        for p, g in zip(params, grads):
            p.grad = g
        if clip_norm > 0:
            from dsml_tpu_torch.cli.train_gpt2 import clip_by_global_norm

            clip_by_global_norm(grads, clip_norm)
        if lr is not None:
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.step()
        if first and ledger.enabled:
            ledger.claim_tree("params", model, detail="hybrid")
            ledger.claim_tree("optimizer", optimizer.state, detail="hybrid")
        ledger.note_step_peak()
        return loss

    return step


@torch.no_grad()
def hybrid_eval_loss(model, mesh: Mesh, attn_impl: str, x, y) -> torch.Tensor:
    """The global mean loss of the batch ``x``/``y`` [batch, seq] with no
    update: every rank's loss over its share, averaged over the group (the
    JAX example's eval ``pmean``, through the process group)."""
    seq_group, dp_group = _seq_group(mesh), mesh.group("dp")
    x = rank_rows(_shard(x, seq_group), dp_group).to(model.device).long()
    y = rank_rows(_shard(y, seq_group), dp_group).to(model.device).long()
    loss = hybrid_loss_fn(model, attn_impl, seq_group)(x, y).float()
    group = seq_group or dp_group
    if group is not None:
        loss = all_reduce(loss, group, ReduceOp.AVG, "xla")
    return loss
