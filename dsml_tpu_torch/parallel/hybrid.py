"""The context-parallel train step — the cp slice of
``dsml_tpu/parallel/hybrid.py``.

The JAX step is one jitted SPMD program over the mesh: parameters
replicated over cp, the sequence sharded over it, the loss ``pmean``-ed
over the batch and sequence axes, and the shard_map transpose summing each
replicated parameter's gradient over the ranks. Here each rank is one
process running :func:`make_hybrid_train_step`'s ``step``:

1. it takes its contiguous shard of the global batch's sequence;
2. the per-rank loss (``GPT2.loss`` with ``sp_group``: ring attention, the
   rank's own chunked or dense cross-entropy) is scaled by 1/cp and
   differentiated, so the ring attention's backward carries every rank's
   cotangents of this rank's K/V home;
3. the gradients are summed over the cp group (gloo ``all_reduce`` of one
   flat buffer; gloo takes CUDA tensors), the global mean loss likewise;
4. clip by global norm (optax's rule) and the optimizer run on every rank
   on identical gradients, so the replicas stay identical.

Only cp (with dp = 1) is served; pipeline schedules, microbatched
pipelines and explicit ``dp_sync`` algorithms raise and name their
ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dsml_tpu_torch.parallel.mesh import _NOT_PORTED, Mesh

__all__ = ["default_attn_impl", "hybrid_eval_loss", "hybrid_loss_fn", "init_hybrid",
           "make_hybrid_train_step"]


def default_attn_impl(mesh: Mesh) -> str:
    """What ``attn_impl=None`` resolves to on this mesh, as in the JAX
    package: the flash ring ``"ring2"`` when cp is sized, else the XLA ring
    ``"ring"`` (which the port does not serve yet)."""
    return "ring2" if mesh.shape.get("cp", 1) > 1 else "ring"


def _seq_group(mesh: Mesh):
    return mesh.group("cp") if mesh.spec.seq_axis() == "cp" else None


def hybrid_loss_fn(model, attn_impl: str = "ring", seq_group=None):
    """Per-rank loss closure ``loss_fn(x, y)`` over this rank's sequence
    shard: positions offset by the shard origin and the rank's own
    cross-entropy, as the JAX ``hybrid_loss_fn`` with ``seq_axis``."""

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
                           clip_norm: float = 0.0):
    """Build ``step(x, y, lr=None) -> loss`` for a cp mesh. ``x``/``y`` are
    the GLOBAL batch [batch, seq] (every rank passes the same); each rank
    trains on its sequence shard. With ``grad_accum > 1`` the batch splits
    into that many microbatches whose gradients are summed and divided by
    ``grad_accum`` (as the JAX step). ``clip_norm > 0`` clips the summed
    gradients by global norm (the JAX example's ``optax.chain`` puts the
    clip in the optimizer); ``lr`` sets every group's learning rate before
    the update. Returns the global mean loss (a device scalar, identical on
    every rank)."""
    if schedule != "gpipe" or n_microbatches != 1 or mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError("pipeline schedules (pp, n_microbatches) " + _NOT_PORTED.format(11))
    if dp_sync != "xla":
        raise NotImplementedError(f"dp_sync={dp_sync!r} " + _NOT_PORTED.format(6))
    group = _seq_group(mesh)
    if attn_impl is None:
        attn_impl = default_attn_impl(mesh)
    loss_fn = hybrid_loss_fn(model, attn_impl, group)
    n = 1 if group is None else group.size
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(x, y, lr: float | None = None):
        x = _shard(x, group).to(model.device).long()
        y = _shard(y, group).to(model.device).long()
        if x.shape[0] % grad_accum:
            raise ValueError(f"global batch {x.shape[0]} not divisible by grad_accum={grad_accum}")
        micro = x.shape[0] // grad_accum
        optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for m in range(grad_accum):
            rows = slice(m * micro, (m + 1) * micro)
            micro_loss = loss_fn(x[rows], y[rows])
            # the gradient of the global mean: every rank seeds 1/cp, and the
            # ring's backward carries each rank's share home
            (micro_loss / n).backward()
            loss += micro_loss.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group.pg)
            torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
                flat.split([g.numel() for g in grads]), grads)])
            dist.all_reduce(loss, group=group.pg)
        for p, g in zip(params, grads):
            p.grad = g
        if grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
        if clip_norm > 0:
            from dsml_tpu_torch.cli.train_gpt2 import clip_by_global_norm

            clip_by_global_norm(grads, clip_norm)
        if lr is not None:
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.step()
        return loss / (n * grad_accum)

    return step


@torch.no_grad()
def hybrid_eval_loss(model, mesh: Mesh, attn_impl: str, x, y) -> torch.Tensor:
    """The global mean loss of the batch ``x``/``y`` [batch, seq] with no
    update: every rank's loss over its sequence shard, averaged over the
    group (the JAX example's eval ``pmean``)."""
    group = _seq_group(mesh)
    loss = hybrid_loss_fn(model, attn_impl, group)(
        _shard(x, group).to(model.device).long(), _shard(y, group).to(model.device).long()).float()
    if group is not None:
        dist.all_reduce(loss, group=group.pg)
        loss = loss / group.size
    return loss
