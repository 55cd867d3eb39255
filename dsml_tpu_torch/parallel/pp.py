"""Pipeline parallelism over a ``pp`` group — the counterpart of
``dsml_tpu/parallel/pp.py``.

The JAX schedules are one ``lax.scan`` of ticks inside ``shard_map``: at
tick t every stage runs its work unit (or computes and discards in a
bubble), then every stage's output hops one rank on with ``ppermute``, and
``jax.grad`` of the scan is the mirrored backward. Here each stage is a
process, and the schedules keep that tick structure exactly: the same
(tick, rank) → (microbatch, chunk) tables, and one ring hop per direction
per tick on every rank (``ops.collectives.ring_pass``: gloo for CPU
tensors, the pp group's CUDA IPC ring for CUDA ones), so every rank posts
its hops in the same order and the transport's two parities per direction
never see two payloads in flight. Bubble ticks skip the compute and hop
zeros. A rank that waits on its neighbour longer than ``peer.TIMEOUT_S``
raises.

The backward is written out, not left to autograd across processes: each
tick's stage input is a leaf of its own graph, and the backward walks the
ticks in reverse, hopping each input's cotangent one rank back (−1) to
become the cotangent of the output that fed it.

- :func:`pipeline_train` with ``v = 1`` is GPipe (``pipeline_apply`` +
  ``jax.grad``): every forward tick, the head over all microbatches on the
  last stage, then every backward tick. Activations of all M microbatches
  are held (``remat`` trades them for recompute, as in the JAX package).
- ``v > 1`` is Megatron's interleaved schedule
  (``pipeline_apply_interleaved``): rank r holds chunks r, r+S, …; a
  microbatch goes round the ring v times (the S−1 → 0 hop carries chunk
  k → k+1); M·v + S − 1 ticks.
- :func:`pipeline_train_1f1b` is PipeDream-flush (``pipeline_train_1f1b``):
  at tick t rank r runs the forward of microbatch t − r and the backward of
  microbatch t − 2(S−1) + r, activations on +1 and cotangents on −1 each
  tick. At most 2(S−1)+1 microbatches are in flight on a rank (one on the
  last stage), whatever M: the schedule's flatter activation memory. The
  JAX schedule recomputes each stage forward from a stashed input (a scan
  carry cannot hold residuals); here each in-flight microbatch keeps its
  graph until its backward, so no forward is recomputed.

:func:`pipeline_apply` / :func:`pipeline_apply_interleaved` are the forward
schedules alone (no gradient), returning every microbatch's output on every
rank, as the JAX functions do.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce, ring_pass

__all__ = [
    "interleave_layer_order",
    "pipeline_apply",
    "pipeline_apply_interleaved",
    "pipeline_specs",
    "pipeline_train",
    "pipeline_train_1f1b",
    "stack_layer_params",
    "stage_layer_ids",
]


def stack_layer_params(layer_params: Sequence[dict]) -> dict:
    """[per-layer ``{name: tensor}``] → one dict with a leading layer axis
    (the JAX stacked form)."""
    return {k: torch.stack([lp[k] for lp in layer_params]) for k in layer_params[0]}


def pipeline_specs(layer_spec: dict, axis: str = "pp") -> dict:
    """Specs of stacked layer params: the layer axis → ``axis``."""
    return {k: (axis, *spec) for k, spec in layer_spec.items()}


def interleave_layer_order(n_layer: int, n_stage: int, v: int) -> list[int]:
    """The JAX layer permutation for the interleaved schedule: rank r owns
    virtual chunks r, r+S, …, r+(v−1)S, so position ``r·(n_layer/S) +
    j·(n_layer/(vS)) + i`` of the stacked axis holds original layer
    ``(r + jS)·(n_layer/(vS)) + i``."""
    if n_layer % (n_stage * v):
        raise ValueError(f"n_layer={n_layer} not divisible by stages×interleave={n_stage * v}")
    per_chunk = n_layer // (n_stage * v)
    order = []
    for r in range(n_stage):
        for j in range(v):
            chunk = r + j * n_stage
            order.extend(range(chunk * per_chunk, (chunk + 1) * per_chunk))
    return order


def stage_layer_ids(n_layer: int, n_stage: int, rank: int, v: int = 1) -> list[int]:
    """The global layers stage ``rank`` holds, in the order it runs them
    (its ``P('pp')`` block of the interleave-permuted stacked axis: chunk 0
    first)."""
    if n_layer % n_stage:
        raise ValueError(f"n_layer={n_layer} not divisible by pp={n_stage}")
    order = interleave_layer_order(n_layer, n_stage, v) if v > 1 else list(range(n_layer))
    per_stage = n_layer // n_stage
    return order[rank * per_stage:(rank + 1) * per_stage]


def _unit(n_stage: int, n_micro: int, v: int, rank: int, t: int):
    """(active, microbatch, chunk, ingests, writes) of stage ``rank`` at
    tick ``t``: the JAX schedules' closed forms (GPipe at v = 1)."""
    if v == 1:
        m = t - rank
        return 0 <= m < n_micro, m, 0, rank == 0, rank == n_stage - 1
    rel = t - rank
    mmod = rel % n_stage
    q = (rel - mmod) // n_stage
    j, g = q % v, q // v
    m = mmod + n_stage * g
    active = rel >= 0 and 0 <= g < n_micro // n_stage
    return active, m, j, rank == 0 and j == 0, rank == n_stage - 1 and j == v - 1


def _check(n_stage: int, n_micro: int, v: int) -> None:
    if v > 1 and n_micro % n_stage:
        raise ValueError(
            f"interleaved schedule needs microbatches divisible by stages: {n_micro} % {n_stage}")


def _forward_ticks(chunks, micros_like, micros, group, v, keep_graph: bool):
    """Run the forward ticks; returns (per-tick records, outputs by micro).
    A record is (tick, stage input leaf, output) for the active ticks."""
    n_stage, rank = group.size, group.rank
    n_micro, shape, dtype, device = micros_like
    ticks = n_micro * v + n_stage - 1
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    buf, records, outputs = zeros, [], {}
    for t in range(ticks):
        active, m, j, ingest, write = _unit(n_stage, n_micro, v, rank, t)
        send = zeros
        if active:
            x_in = (micros[m] if ingest else buf).detach()
            if keep_graph:
                x_in.requires_grad_(True)
            y = chunks[j](x_in)
            records.append((t, x_in, y))
            send = y.detach()
            if write:
                outputs[m] = y
        if t < ticks - 1:
            buf = ring_pass(send, group, +1)
    return records, outputs


def pipeline_train(chunks: Sequence[Callable], head_fn: Callable, micros, targets, group,
                   micros_like=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """GPipe (``len(chunks) == 1``) or the interleaved schedule (``v =
    len(chunks)`` chunks a rank), forward and backward. Call on every
    stage of ``group``.

    ``chunks[j](x) -> y`` is this rank's chunk j (the whole stage at v = 1);
    ``head_fn(y, targets) -> mean loss`` runs on the last stage over all
    microbatch outputs concatenated on the batch axis (the JAX head over
    the pipeline's replicated outputs, masked to the last stage).
    ``micros`` [M, mb, ...] are stage 0's inputs (other ranks may pass
    None with ``micros_like = (M, shape of one microbatch, dtype,
    device)``); ``targets`` [M, mb, ...] the last stage's.

    Parameter gradients accumulate in ``.grad`` of whatever the chunks and
    the head use. Returns ``(loss, d_micros)``: the loss on the last stage
    (0 elsewhere: the caller sums it over the group), and on stage 0 the
    cotangent of ``micros`` (None elsewhere) for the embedding's backward."""
    n_stage, rank, v = group.size, group.rank, len(chunks)
    if micros_like is None:
        micros_like = (micros.shape[0], micros.shape[1:], micros.dtype, micros.device)
    n_micro, shape, dtype, device = micros_like
    _check(n_stage, n_micro, v)
    records, outputs = _forward_ticks(chunks, micros_like, micros, group, v, True)
    out_grads = {}
    loss = torch.zeros((), dtype=torch.float32, device=device)
    if rank == n_stage - 1:
        leaves = [outputs[m].detach().requires_grad_(True) for m in range(n_micro)]
        tgt = targets.reshape(-1, *targets.shape[2:])
        head_loss = head_fn(torch.cat(leaves), tgt)
        head_loss.backward()
        loss = head_loss.detach().float()
        out_grads = {m: leaf.grad for m, leaf in enumerate(leaves)}
    d_micros = torch.zeros((n_micro, *shape), dtype=dtype, device=device) if rank == 0 else None
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    by_tick = {t: (x_in, y) for t, x_in, y in records}
    ticks = n_micro * v + n_stage - 1
    g_send = zeros
    for t in reversed(range(ticks)):
        g_hop = ring_pass(g_send, group, -1) if t < ticks - 1 else None
        active, m, j, ingest, write = _unit(n_stage, n_micro, v, rank, t)
        g_send = zeros
        if not active:
            continue
        x_in, y = by_tick.pop(t)
        g = out_grads.get(m) if write else None
        if g_hop is not None:
            g = g_hop if g is None else g + g_hop
        if g is None:
            continue
        torch.autograd.backward(y, g.to(y.dtype))
        if ingest:
            d_micros[m] += x_in.grad
        else:
            g_send = x_in.grad
    return loss, d_micros


def pipeline_train_1f1b(stage: Callable, head_fn: Callable, micros, targets, group,
                        micros_like=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The 1F1B schedule (see the module docstring), forward and backward,
    with :func:`pipeline_train`'s arguments and returns; ``stage(x) -> y``
    is this rank's whole stage and ``head_fn(y_m, targets_m)`` the mean loss
    of one microbatch, seeded with 1/M (the loss is the mean over the M
    microbatches)."""
    n_stage, rank = group.size, group.rank
    if micros_like is None:
        micros_like = (micros.shape[0], micros.shape[1:], micros.dtype, micros.device)
    n_micro, shape, dtype, device = micros_like
    last = rank == n_stage - 1
    ticks = n_micro + 2 * (n_stage - 1)
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    buf_f = buf_b = zeros
    stash: dict = {}
    loss = torch.zeros((), dtype=torch.float32, device=device)
    d_micros = torch.zeros((n_micro, *shape), dtype=dtype, device=device) if rank == 0 else None
    for t in range(ticks):
        m_f, m_b = t - rank, t - 2 * (n_stage - 1) + rank
        send_f = send_b = zeros
        if 0 <= m_f < n_micro:
            x_in = (micros[m_f] if rank == 0 else buf_f).detach().requires_grad_(True)
            y = stage(x_in)
            stash[m_f] = (x_in, y)
            send_f = y.detach()
        if 0 <= m_b < n_micro:
            x_in, y = stash.pop(m_b)
            if last:  # m_f == m_b: the head's cotangent starts this backward
                loss_m = head_fn(y, targets[m_b])
                (loss_m / n_micro).backward()
                loss = loss + loss_m.detach().float() / n_micro
            else:
                torch.autograd.backward(y, buf_b.to(y.dtype))
            if rank == 0:
                d_micros[m_b] += x_in.grad
            else:
                send_b = x_in.grad
        if t < ticks - 1:
            buf_f = ring_pass(send_f, group, +1)
            buf_b = ring_pass(send_b, group, -1)
    return loss, d_micros


@torch.no_grad()
def _apply(chunks, microbatches, group):
    n_stage, rank, v = group.size, group.rank, len(chunks)
    n_micro = microbatches.shape[0]
    _check(n_stage, n_micro, v)
    like = (n_micro, microbatches.shape[1:], microbatches.dtype, microbatches.device)
    _, outputs = _forward_ticks(chunks, like, microbatches, group, v, False)
    out = torch.zeros_like(microbatches)
    if rank == n_stage - 1:
        for m, y in outputs.items():
            out[m] = y
    # resident on the last stage only: replicate (the JAX masked psum)
    return all_reduce(out, group, ReduceOp.SUM, "xla" if out.is_cpu else "ring")


def pipeline_apply(layer_fn: Callable, stage_layers: Sequence, microbatches, group):
    """GPipe forward of ``microbatches`` [M, mb, ...] through every stage's
    layers (``layer_fn(layer, x) -> x`` over this rank's ``stage_layers``);
    the outputs [M, mb, ...] come back on every rank. No gradient."""

    def stage(x):
        for layer in stage_layers:
            x = layer_fn(layer, x)
        return x

    return _apply([stage], microbatches, group)


def pipeline_apply_interleaved(layer_fn: Callable, stage_chunks: Sequence[Sequence],
                               microbatches, group):
    """The interleaved forward: ``stage_chunks[j]`` are the layers of this
    rank's chunk j (chunk r + jS of the model); M must divide by S. The
    outputs come back on every rank. No gradient."""

    def chunk_fn(layers):
        def run(x):
            for layer in layers:
                x = layer_fn(layer, x)
            return x

        return run

    return _apply([chunk_fn(c) for c in stage_chunks], microbatches, group)
