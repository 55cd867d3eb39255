"""Data parallelism: the sharded-batch train step with real gradient sync —
the counterpart of ``dsml_tpu/parallel/dp.py``.

The JAX step is one jitted SPMD program: the global batch enters sharded
``P('dp')``, each shard's gradients sync over the dp axis and the
replicated parameters take the same update. Here each rank is one process
running ``step(x, y, lr=None) -> loss``:

1. it takes its contiguous rows of the global batch (what ``P('dp')``
   gives rank r);
2. its mean loss goes through ``backward()``;
3. the gradients are averaged over the dp group by
   ``parallel.bucketing.bucketed_all_reduce`` with the step's algorithm
   (``"xla"``: one flat buffer through the process group's own
   ``all_reduce``; ``"ring"``/``"ring2"``/``"naive"``/``"auto"``: per-bucket
   collectives over ``ops.collectives``, CUDA payloads on the ring's CUDA
   IPC transport; ``"q8"``: each float bucket quantized by kernel 8 and
   gathered; ``"q8_ring"``/``"q8_ring2"``/``"q4_ring"``/``"q4_ring2"``:
   int8/int4 inside the ring; ``"quant"``: the scheme per dtype from
   ``DSML_QUANT``), and the loss is averaged by the same algorithm, or by
   the full-precision ``"ring"`` under a quantized one, so an explicit
   algorithm on CUDA tensors never touches gloo (a gloo op on a CUDA
   scalar would sync the host every step);
4. the optimizer runs on every rank on identical gradients, so the
   replicas stay identical.

``error_feedback=True`` (the quantized ring family and ``"quant"``) keeps
this rank's f32 residuals in the step (``step.error_feedback``, one per
trainable parameter in ``named_params`` order): each sync runs on
``grads + residual`` with deterministic rounding and leaves the new
residual there.

Observability, as the JAX step writes it: a ``train_step_build``
flight-recorder event when the step is built; the sync's bucket plan
(``obs.record_collective_plan``) once per batch signature, where the JAX
step records it once per compilation (an explicit algorithm only: the
``"xla"`` sync has no plan there); the cumulative wire bytes of a
quantized sync (``obs.record_quant_sync_bytes``) after every step.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from dsml_tpu_torch.models.common import count_correct
from dsml_tpu_torch.obs import flight_recorder, record_collective_plan, record_quant_sync_bytes
from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce
from dsml_tpu_torch.parallel.bucketing import (bucketed_all_reduce, default_bucket_mb,
                                               init_error_feedback, is_quantized_algorithm,
                                               plan_buckets, plan_quant_wire_bytes,
                                               supports_error_feedback, tree_order)

__all__ = ["make_dp_train_step", "make_eval_step", "named_params", "rank_rows"]


def rank_rows(t, group):
    """This rank's contiguous rows of the global batch ``t`` (axis 0), as
    ``P('dp')`` shards it; all of ``t`` without a group."""
    t = torch.as_tensor(t)
    if group is None:
        return t
    if t.shape[0] % group.size:
        raise ValueError(f"global batch {t.shape[0]} not divisible by dp={group.size}")
    n = t.shape[0] // group.size
    return t[group.rank * n:(group.rank + 1) * n]


def named_params(model, optimizer=None) -> list[tuple[str, torch.Tensor]]:
    """``model``'s trainable parameters (those ``optimizer`` updates, when
    given) in the JAX parameter tree's order (``bucketing.tree_order``):
    the order the buckets are planned in."""
    named = dict(model.named_parameters())
    if optimizer is not None:
        ids = {id(p) for g in optimizer.param_groups for p in g["params"]}
        named = {k: p for k, p in named.items() if id(p) in ids}
    return [(k, named[k]) for k in tree_order(k for k, p in named.items() if p.requires_grad)]


def make_dp_train_step(model, optimizer, mesh=None, algorithm: str = "xla", axis: str = "dp",
                       bucket_size_mb: float | None | str = "auto", error_feedback: bool = False,
                       loss_fn: Callable | None = None):
    """Build ``step(x, y, lr=None) -> loss`` for ``model`` (an
    ``nn.Module`` whose ``loss(x, y)`` is the mean loss of its rows;
    ``loss_fn`` replaces it) on ``mesh``'s ``axis`` group (``mesh=None``
    or a group of one: a single-device step).

    ``x``/``y`` are the GLOBAL batch; every rank passes the same and trains
    on its rows. ``bucket_size_mb`` (explicit algorithms): ``"auto"`` = the
    ``DSML_BUCKET_MB`` default (4 MiB), a number = that many MiB per
    bucket, ``None`` = one flat buffer. ``lr`` sets every group's learning
    rate before the update. Returns the mean loss over the global batch (a
    device scalar, identical on every rank).

    ``error_feedback=True`` needs a ring-family algorithm or ``"quant"``
    (else ``ValueError``, as in the JAX package); the residuals start at
    zero and live in ``step.error_feedback`` (readable and settable, e.g.
    to restore them from a checkpoint). ``step.quant_wire_bytes`` is the
    plan's per-rank wire bytes a sync by scheme
    (``bucketing.plan_quant_wire_bytes``; empty for a full-precision
    algorithm or without a group)."""
    if algorithm not in ("xla", "ring", "ring2", "naive", "auto") and \
            not is_quantized_algorithm(algorithm):
        raise ValueError(f"unknown gradient sync algorithm {algorithm!r}")
    if error_feedback and not supports_error_feedback(algorithm):
        raise ValueError(f"error_feedback=True requires a quantized ring algorithm "
                         f"(q8_ring/q8_ring2/q4_ring/q4_ring2/quant), got {algorithm!r}")
    if bucket_size_mb == "auto":
        bucket_size_mb = default_bucket_mb()
    # build-time breadcrumb: a postmortem names the sync the dying run was built with
    flight_recorder.record("train_step_build", algorithm=algorithm, axis=axis,
                           bucket_mb=bucket_size_mb,
                           devices=1 if mesh is None else math.prod(mesh.shape.values()),
                           error_feedback=error_feedback)
    if algorithm == "xla":
        bucket_size_mb = None  # the process group's one all_reduce of every gradient
    group = None if mesh is None else mesh.group(axis)
    loss_fn = loss_fn or model.loss
    params = [p for _, p in named_params(model, optimizer)]
    device = params[0].device
    quantized = is_quantized_algorithm(algorithm)
    # the loss mean is exact: a quantized name is no all_reduce algorithm
    loss_algorithm = "ring" if quantized else algorithm
    # the batch signatures seen: where jit would trace (and the JAX step
    # record its plan) on a new one; None = the "xla" sync, which has none
    signatures = None if algorithm == "xla" else set()
    # EF syncs are plan-shaped even at None (per-dtype buckets)
    plan_mb = bucket_size_mb if bucket_size_mb is not None or not error_feedback else float("inf")

    def step(x, y, lr: float | None = None):
        x = rank_rows(x, group).to(device)
        y = rank_rows(y, group).to(device)
        if signatures is not None:
            sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
            if sig not in signatures:
                signatures.add(sig)
                record_collective_plan(algorithm, params, plan_mb, axis)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        loss = loss.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if group is not None:
            if error_feedback:
                grads, step.error_feedback = bucketed_all_reduce(
                    grads, group, ReduceOp.AVG, algorithm, bucket_size_mb,
                    error_feedback=step.error_feedback)
            else:
                grads = bucketed_all_reduce(grads, group, ReduceOp.AVG, algorithm, bucket_size_mb)
            loss = all_reduce(loss, group, ReduceOp.AVG, loss_algorithm)
        for p, g in zip(params, grads):
            p.grad = g
        if lr is not None:
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.step()
        if quantized:
            record_quant_sync_bytes(step.quant_wire_bytes, algorithm, axis)
        return loss

    step.error_feedback = init_error_feedback(params) if error_feedback else None
    step.quant_wire_bytes = {}
    if group is not None and quantized:
        plan = plan_buckets(params, bucket_size_mb if bucket_size_mb is not None else float("inf"))
        step.quant_wire_bytes = plan_quant_wire_bytes(plan, group.size, algorithm)
    return step


def make_eval_step(model, mesh=None, axis: str = "dp"):
    """``eval(x, y) -> correct count`` over the global batch: each rank
    counts its rows' correct argmax logits, the counts summed over the
    group (a tensor)."""
    group = None if mesh is None else mesh.group(axis)
    device = next(model.parameters()).device

    @torch.no_grad()
    def correct(x, y):
        x, y = rank_rows(x, group).to(device), rank_rows(y, group).to(device)
        count = count_correct(model.apply(x), y)
        return count if group is None else all_reduce(count, group, ReduceOp.SUM, "xla")

    return correct
