"""Ring collectives over ``torch.distributed`` — the counterpart of
``dsml_tpu/ops/collectives.py``.

- :func:`ring_pass` (and :func:`ring_pass_start`) is the one rotate step
  every schedule here moves its payloads through, and so do the ring
  attentions (``ops/ring_attention.py``, ``ops/attention.py``,
  ``ops/flash.py``). Under autograd :func:`ring_pass` is differentiable
  as the JAX ``ppermute``: the cotangents ride one hop back.
- :func:`ring_all_reduce` / :func:`ring2_all_reduce` run the 2(n−1)-step
  ring schedule (scatter-reduce, then all-gather) of
  ``_ring_all_reduce_impl``, one or two directions; :func:`naive_all_reduce`
  gathers over n−1 ring passes and reduces; :func:`all_reduce` dispatches,
  ``"xla"`` being the process group's own ``all_reduce``.
- :func:`reduce_scatter`, :func:`flat_reduce_scatter`, :func:`all_gather`
  and :func:`flat_all_gather` are the ring's two halves on their own, so
  the schedule has one definition.
- :func:`all_to_all` is the JAX ``lax.all_to_all(tiled=True)``: each rank's
  chunks relayed around the ring (n − 1 passes, one at n = 2), with the
  inverse exchange as its backward. The expert-parallel MoE block
  dispatches and returns its token payloads through it.

A group is a :class:`~dsml_tpu_torch.parallel.peer.RingGroup` where the
JAX code takes an ``axis_name``. CPU tensors hop over gloo point-to-point;
CUDA tensors through the group's CUDA IPC transport (``parallel/peer.py``).
The route is chosen by the tensors' device, and a payload that mixes
devices raises: a ring algorithm never reaches gloo with a CUDA tensor.
``"xla"`` is gloo for both (on a one-card host gloo moves CUDA tensors
through host memory; an NCCL route waits for a host with several cards).

The combine order is the JAX ring's, so ring results equal the JAX
package's bit for bit: the same segment indices, ``combine(resident,
received)``, integers accumulated in ``promote_types(dtype, int32)``,
floats (bf16 included) in their own type. XLA sums ``lax.psum`` and
``lax.psum_scatter`` over ranks in rank order, ``((x0 + x1) + x2) + x3``:
on CPU tensors the ``"xla"`` all-reduce of floats and :func:`reduce_scatter`
SUM/AVG gather the ranks' rows and sum them in that order (bf16 in f32,
rounded once), so they equal the JAX package's bit for bit at any n; CUDA
tensors keep gloo and the IPC ring.

:func:`local_all_reduce`, :func:`device_buffers_all_reduce` and
:func:`make_stacked_all_reduce` are the in-process all-reduces of the wire
coordinator: one process holds every rank's tensor, each on its own
device, and the same schedules run over them (the JAX package runs them
as one program over a device mesh).
"""

from __future__ import annotations

import enum
import functools
import json
import os

import torch
import torch.distributed as dist

from dsml_tpu_torch.utils.dtypes import TORCH_DTYPES

__all__ = [
    "ReduceOp",
    "ring_perm_tables",
    "ring_pass",
    "ring_pass_start",
    "ppermute_ring",
    "ring_all_reduce",
    "ring2_all_reduce",
    "naive_all_reduce",
    "all_reduce",
    "auto_all_reduce_algorithm",
    "reduce_scatter",
    "flat_reduce_scatter",
    "flat_all_gather",
    "all_gather",
    "all_to_all",
    "STATS",
    "reset_stats",
    "ring_wire_bytes",
    "local_all_reduce",
    "device_buffers_all_reduce",
    "make_stacked_all_reduce",
]

# all_to_all calls (the backward's inverse exchanges included) and the
# bytes each rank sends to the others (the chip check reads them per step)
STATS = {"all_to_all": 0, "all_to_all_bytes": 0}


def reset_stats() -> None:
    STATS.update(all_to_all=0, all_to_all_bytes=0)


class ReduceOp(enum.IntEnum):
    """Reduction operator, with the JAX package's values (the wire enum
    ``gpu_sim.ReduceOp``)."""

    SUM = 0
    PROD = 1
    MIN = 2
    MAX = 3
    AVG = 4

    @property
    def combine(self):
        """``combine(resident, received, out=resident)``."""
        return _COMBINE[self]


_COMBINE = {
    ReduceOp.SUM: torch.add,
    ReduceOp.AVG: torch.add,
    ReduceOp.PROD: torch.mul,
    ReduceOp.MIN: torch.minimum,
    ReduceOp.MAX: torch.maximum,
}

_TAG_CPU = {+1: 1, -1: 2}  # gloo tags of a CPU payload, per direction


def ring_perm_tables(n: int) -> dict[int, list[tuple[int, int]]]:
    """(source, destination) pairs for BOTH ring directions: ``+1`` sends
    rank i → i+1, ``-1`` the mirror — the one definition of the ring
    neighbourhood, as in the JAX package."""
    return {
        +1: [(i, (i + 1) % n) for i in range(n)],
        -1: [(i, (i - 1) % n) for i in range(n)],
    }


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x], lambda outs: outs[0]
    if isinstance(x, (tuple, list)) and all(isinstance(t, torch.Tensor) for t in x):
        return list(x), lambda outs: type(x)(outs)
    raise TypeError(f"ring_pass takes a tensor or a tuple/list of tensors, got {type(x).__name__}")


class _Pass:
    """A hop in flight; :meth:`wait` returns what arrived."""

    def __init__(self, finish):
        self._finish = finish
        self._result = None

    def wait(self):
        if self._finish is not None:
            self._result = self._finish()
            self._finish = None
        return self._result


def ring_pass_start(x, group, sign: int = +1, overlap: bool = True) -> _Pass:
    """Start one rotate step: every tensor of ``x`` (a tensor or a
    tuple/list of them) hops to the ``sign``-direction neighbour of
    ``group`` (``+1`` = rank i → i+1). Returns a handle whose ``wait()``
    gives the tensors received from the opposite neighbour, in ``x``'s
    structure. With ``overlap`` the hop runs ahead of the caller's next
    work: gloo's asynchronous point-to-point for CPU tensors, a side
    stream for CUDA tensors (``wait()`` makes the current stream wait
    for it)."""
    if sign not in (+1, -1):
        raise ValueError(f"ring_pass sign must be +1 or -1, got {sign!r}")
    leaves, rebuild = _leaves(x)
    if group.size == 1:
        return _Pass(lambda: rebuild(leaves))
    leaves = [t.contiguous() for t in leaves]
    kinds = {t.device.type for t in leaves}
    if kinds == {"cpu"}:
        outs = [torch.empty_like(t) for t in leaves]
        tag = _TAG_CPU[sign]
        ops = []
        for t, o in zip(leaves, outs):
            ops.append(dist.P2POp(dist.isend, t, group.global_rank(group.dst(sign)), group.pg, tag))
            ops.append(dist.P2POp(dist.irecv, o, group.global_rank(group.src(sign)), group.pg, tag))
        works = dist.batch_isend_irecv(ops)

        def finish():
            for w in works:
                w.wait()
            return rebuild(outs)

        return _Pass(finish)
    if kinds != {"cuda"} or any(t.device != group.device for t in leaves):
        raise ValueError(f"ring_pass takes tensors all on the CPU or all on the group's device "
                         f"{group.device}, got {[str(t.device) for t in leaves]}")
    ipc = group.ipc()
    if not overlap:
        outs = ipc.exchange(leaves, sign)
        return _Pass(lambda: rebuild(outs))
    current = torch.cuda.current_stream(group.device)
    side = group.side_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        outs = ipc.exchange(leaves, sign)
    for t in leaves:
        t.record_stream(side)  # not reused before the side stream has sent it

    def finish():
        current.wait_stream(side)
        for o in outs:
            o.record_stream(current)
        return rebuild(outs)

    return _Pass(finish)


class _RingPass(torch.autograd.Function):
    """One hop whose backward is the JAX transpose of ``ppermute``: the
    cotangents ride one hop the opposite way, every leaf in one pass."""

    @staticmethod
    def forward(ctx, group, sign, *leaves):
        ctx.group, ctx.sign = group, sign
        return tuple(ring_pass_start(list(leaves), group, sign, overlap=False).wait())

    @staticmethod
    def backward(ctx, *grads):
        back = ring_pass_start(list(grads), ctx.group, -ctx.sign, overlap=False).wait()
        return (None, None, *back)


def ring_pass(x, group, sign: int = +1):
    """One rotate step of the ring schedule (:func:`ring_pass_start`,
    waited for at once): the counterpart of the JAX ``ring_pass``, and
    differentiable as it is. When grad mode is on and a tensor of ``x``
    requires grad, the hop runs through an autograd function whose
    backward sends the cotangents of every tensor of ``x`` one hop in the
    opposite direction (the transpose of ``ppermute``; a cotangent autograd
    leaves unset hops as zeros, so every rank posts the same hop). The
    pipelines and the all-reduce family pass tensors that need no grad."""
    leaves, rebuild = _leaves(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves) and group.size > 1:
        return rebuild(list(_RingPass.apply(group, sign, *leaves)))
    return ring_pass_start(x, group, sign, overlap=False).wait()


def ppermute_ring(x, group, shift: int = 1):
    """Rotate ``x`` ``shift`` hops around the ring (rank i's value lands on
    rank i + shift), the JAX ``ppermute_ring``: ``|shift|`` ring passes in
    the direction of its sign. The pipeline schedules move activations on
    +1 and cotangents on −1 (``parallel/pp.py``)."""
    sign = 1 if shift >= 0 else -1
    for _ in range(abs(shift) % max(group.size, 1)):
        x = ring_pass(x, group, sign)
    return x


# ---------------------------------------------------------------------------
# The ring schedule and the collectives built on it
# ---------------------------------------------------------------------------


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Integers accumulate in ``promote_types(dtype, int32)`` (a uint8 SUM
    wraps only on the final cast back); floats in their own type."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.promote_types(dtype, torch.int32)


def _avg(total: torch.Tensor, n: int) -> torch.Tensor:
    """AVG's finish: ``total`` times the f32 reciprocal of ``n`` (an
    integer total in f32). XLA compiles the JAX ring's ``/ n`` to that
    multiply, so at n = 3 a true division would differ in the last bit;
    PyTorch on CUDA multiplies by the reciprocal too."""
    return total * (1.0 / n)


def _hops(chunks, signs, group):
    """One ring step: every direction's hop issued back to back, then each
    waited for (its values are final on return)."""
    started = [ring_pass_start(c, group, s, overlap=False) for c, s in zip(chunks, signs)]
    return [p.wait() for p in started]


def _scatter_reduce(bufs, signs, group, combine, shift: int) -> None:
    """The scatter-reduce half in place: ``bufs[i]`` is ``[n, seg]`` running
    in direction ``signs[i]``. Step t sends segment (rank − s·(t+shift))
    and combines the received one into segment (rank − s·(t+1+shift)), so
    after n − 1 steps segment (rank − s·(n−1+shift)) holds the reduction of
    every rank's: rank + s for the all-reduce (``shift`` 0), the rank's own
    for :func:`reduce_scatter` (``shift`` 1)."""
    n, rank = group.size, group.rank
    for step in range(n - 1):
        recvs = _hops([b[(rank - s * (step + shift)) % n] for b, s in zip(bufs, signs)],
                      signs, group)
        for b, s, r in zip(bufs, signs, recvs):
            resident = b[(rank - s * (step + 1 + shift)) % n]
            combine(resident, r, out=resident)


def _gather(bufs, signs, group, shift: int) -> None:
    """The all-gather half in place: step t passes on segment
    (rank − s·(t−1+shift)) and stores the received one at (rank −
    s·(t+shift)); the rank starts from the segment the scatter-reduce left
    it (``shift`` 0) or its own (``shift`` 1)."""
    n, rank = group.size, group.rank
    for step in range(n - 1):
        recvs = _hops([b[(rank - s * (step - 1 + shift)) % n] for b, s in zip(bufs, signs)],
                      signs, group)
        for b, s, r in zip(bufs, signs, recvs):
            b[(rank - s * (step + shift)) % n].copy_(r)


def _ring_all_reduce_impl(x: torch.Tensor, group, op: ReduceOp, signs: tuple) -> torch.Tensor:
    """The ring schedule over ``len(signs)`` directions (``dsml_tpu/ops/
    collectives.py::_ring_all_reduce_impl``): the flat payload, in the
    accumulation type, zero-padded to a multiple of ``k·n`` and split into
    ``k`` parts, each part running scatter-reduce then all-gather in its
    own direction. AVG scales the finished sum by 1/n (:func:`_avg`); the
    result is cast back to ``x``'s type (an integer AVG truncates toward
    zero there)."""
    op = ReduceOp(op)
    n = group.size
    if n == 1:
        return x
    size = x.numel()
    k = len(signs)
    padded = -(-size // (k * n)) * (k * n)
    flat = torch.zeros(padded, dtype=_acc_dtype(x.dtype), device=x.device)
    flat[:size].copy_(x.reshape(-1))
    part = padded // k
    bufs = [flat[i * part:(i + 1) * part].view(n, part // n) for i in range(k)]
    _scatter_reduce(bufs, signs, group, op.combine, shift=0)
    _gather(bufs, signs, group, shift=0)
    out = flat[:size]
    if op == ReduceOp.AVG:
        out = _avg(out, n)
    return out.reshape(x.shape).to(x.dtype)


def ring_all_reduce(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Ring all-reduce of ``x`` (same shape on every rank of ``group``):
    the reference's forward 2(n−1)-step schedule over :func:`ring_pass`."""
    return _ring_all_reduce_impl(x, group, op, (+1,))


def ring2_all_reduce(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Bidirectional ring all-reduce: two half-payloads run the schedule in
    opposite directions, each step's two hops issued back to back."""
    return _ring_all_reduce_impl(x, group, op, (+1, -1))


_REDUCE = {
    ReduceOp.SUM: lambda t: t.sum(0),
    ReduceOp.AVG: lambda t: t.sum(0),
    ReduceOp.PROD: lambda t: t.prod(0),
    ReduceOp.MIN: lambda t: t.amin(0),
    ReduceOp.MAX: lambda t: t.amax(0),
}


def naive_all_reduce(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Gather everything, then reduce (the reference's ``NaiveAllReduce``):
    every rank's ``x`` over n − 1 ring passes, reduced over ranks in the
    accumulation type. Each rank receives n − 1 whole payloads where the
    ring receives ~2 in segments, in n − 1 hops where the ring takes
    2(n − 1)."""
    op = ReduceOp(op)
    n = group.size
    if n == 1:
        return x
    gathered = all_gather(x.to(_acc_dtype(x.dtype)), group, tiled=False)
    out = _REDUCE[op](gathered)
    if op == ReduceOp.AVG:
        out = _avg(out, n)
    return out.to(x.dtype)


def ring_wire_bytes(n_elems: int, n_ranks: int, itemsize: int = 4,
                    bidirectional: bool = False) -> int:
    """Per-rank wire bytes of one full-precision ring all-reduce: 2(n−1)
    hops × one segment of the (padded) payload, at ``itemsize`` bytes an
    element; the bidirectional ring moves the same volume."""
    if n_ranks <= 1:
        return 0
    k = 2 if bidirectional else 1
    quantum = k * n_ranks
    padded = -(-n_elems // quantum) * quantum
    return 2 * (n_ranks - 1) * (padded // n_ranks) * itemsize


@functools.lru_cache(maxsize=8)
def _measured_alpha_beta(path: str) -> tuple[float, float] | None:
    """(α ms/round, β ms/byte) solved from a calibrated collective profile
    (``DSML_COLLECTIVE_PROFILE``): the measured ring and naive p50 at one
    (payload, rank count) give two equations,

        naive = α + (n−1)·S·β          (one round, n−1 shards received)
        ring  = 2(n−1)·α + 2·S·β       (2(n−1) rounds, ~2S bytes)

    None (→ the analytic default) when the profile is missing a constant,
    is malformed, or solves to α or β ≤ 0."""
    try:
        with open(path) as f:
            constants = json.load(f)["constants"]

        def med(name: str) -> float:
            entry = constants[name]
            return float(entry["median"] if "median" in entry else entry["fresh"])

        naive_ms = med("allreduce_naive_p50_ms")
        ring_ms = med("allreduce_ring_p50_ms")
        payload_b = med("allreduce_payload_mb") * (1 << 20)
        n = int(med("allreduce_devices"))
    except (OSError, ValueError, KeyError, TypeError):
        return None
    denom = payload_b * (2 * (n - 1) ** 2 - 2)
    if n < 2 or denom <= 0:
        return None
    beta = (2 * (n - 1) * naive_ms - ring_ms) / denom
    alpha = naive_ms - (n - 1) * payload_b * beta
    if alpha <= 0 or beta <= 0:
        return None
    return alpha, beta


def auto_all_reduce_algorithm(nbytes: int, n_devices: int, latency_bytes: int = 32768) -> str:
    """Ring or naive by payload, on the alpha-beta model: naive costs
    α + (n−1)·S·β, the ring 2(n−1)·α + ~2S·β, so naive wins below the
    crossover ``latency_bytes·(2n−3)/(n−3)`` (always at n ≤ 3).
    ``DSML_COLLECTIVE_PROFILE=<path>`` replaces the prior α/β by measured
    ones (:func:`_measured_alpha_beta`); a bad profile keeps the prior."""
    if n_devices <= 3:
        return "naive"
    profile = os.environ.get("DSML_COLLECTIVE_PROFILE")
    if profile:
        ab = _measured_alpha_beta(profile)
        if ab is not None:
            alpha, beta = ab
            naive_ms = alpha + (n_devices - 1) * nbytes * beta
            ring_ms = 2 * (n_devices - 1) * alpha + 2 * nbytes * beta
            return "naive" if naive_ms <= ring_ms else "ring"
    crossover = latency_bytes * (2 * n_devices - 3) / (n_devices - 3)
    return "naive" if nbytes <= crossover else "ring"


_PG_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
           ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM,
               algorithm: str = "xla") -> torch.Tensor:
    """All-reduce with a selectable algorithm, returning a new tensor:

    - ``xla``   — the process group's own ``all_reduce`` (gloo; AVG is its
      SUM times 1/n and, as ``lax.pmean``, float32 for an integer input;
      bf16 and f16 reduce in f32 and round once, as ``lax.psum`` does; PROD
      takes the ring, as the JAX package's);
    - ``ring``  — the explicit 2(n−1)-step ring;
    - ``ring2`` — the bidirectional ring;
    - ``naive`` — gather + reduce;
    - ``auto``  — ring or naive by payload (:func:`auto_all_reduce_algorithm`).
    """
    op = ReduceOp(op)
    if algorithm == "auto":
        algorithm = auto_all_reduce_algorithm(x.numel() * x.element_size(), group.size)
    if algorithm == "ring":
        return ring_all_reduce(x, group, op)
    if algorithm == "ring2":
        return ring2_all_reduce(x, group, op)
    if algorithm == "naive":
        return naive_all_reduce(x, group, op)
    if algorithm != "xla":
        raise ValueError(f"unknown all-reduce algorithm {algorithm!r}")
    if op == ReduceOp.PROD:
        return ring_all_reduce(x, group, op)
    # gloo sums a bf16 or f16 tensor in its own type, rounding every partial
    # sum; the JAX package's psum rounds once
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = x.float() if low else x
    if group.size > 1 and _rank_order_sum(out, op):
        # gloo's summation order is not XLA's: the ranks' rows in rank order
        out = all_gather(out, group, tiled=False).sum(0)
    elif group.size > 1:
        out = out.clone() if out is x else out
        dist.all_reduce(out, _PG_OPS[op], group=group.pg)
    if low:
        out = out.to(x.dtype)
    if op != ReduceOp.AVG:
        return out
    # lax.pmean: the sum times the f32 reciprocal of n, in f32 for a bf16 or
    # f16 sum (then rounded again) and for an integer one (float32 out, at
    # n = 1 too)
    mean = _avg(out.float() if low or not out.is_floating_point() else out, group.size)
    return mean.to(x.dtype) if low else mean


def _identity_pad_value(op: ReduceOp, dtype: torch.dtype):
    """The reduction identity of ``op`` on ``dtype``: what padding holds so
    pad lanes cannot perturb real lanes."""
    op = ReduceOp(op)
    if op == ReduceOp.PROD:
        return 1
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        if dtype.is_floating_point:
            hi, lo = float("inf"), float("-inf")
        else:
            info = torch.iinfo(dtype)
            hi, lo = info.max, info.min
        return hi if op == ReduceOp.MIN else lo
    return 0


def _rank_order_sum(x: torch.Tensor, op: ReduceOp) -> bool:
    """Whether ``op`` over ``x`` takes the rank-order sum of XLA's psum: a
    SUM or AVG of a floating CPU tensor (integer sums are exact in any
    order; CUDA tensors keep their transports)."""
    return x.device.type == "cpu" and x.dtype.is_floating_point and op in (ReduceOp.SUM,
                                                                           ReduceOp.AVG)


def reduce_scatter(x: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Reduce across ranks, leaving rank i with shard i along axis 0 (every
    :class:`ReduceOp`; AVG scales by 1/n). A float SUM or AVG on the CPU
    sums every rank's segment i in rank order, as ``lax.psum_scatter``
    (bf16 in f32, rounded once); otherwise the ring's scatter-reduce half,
    shifted one segment so each rank ends on its own."""
    op = ReduceOp(op)
    n = group.size
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} not divisible by axis size {n}")
    if n == 1:
        return x
    if _rank_order_sum(x, op):
        # every rank's segment for this rank, summed in rank order (XLA's)
        acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
        rows = _all_to_all(x.to(acc).reshape(n, -1), group, 0, 0)
        out = rows.sum(0, dtype=acc)
    else:
        buf = x.to(_acc_dtype(x.dtype), copy=True).reshape(n, -1)
        _scatter_reduce([buf], (+1,), group, op.combine, shift=1)
        out = buf[group.rank]
    if op == ReduceOp.AVG:
        out = _avg(out, n)
    return out.reshape(x.shape[0] // n, *x.shape[1:]).to(x.dtype)


def flat_reduce_scatter(flat: torch.Tensor, group, op: ReduceOp = ReduceOp.SUM):
    """Reduce-scatter a flat vector: rank i keeps contiguous segment i of the
    reduction. Returns ``(shard, padded_size)``; the vector is padded with
    ``op``'s identity to a multiple of the group size."""
    op = ReduceOp(op)
    n = group.size
    size = flat.shape[0]
    padded = -(-size // n) * n
    if padded != size:
        pad = torch.full((padded - size,), _identity_pad_value(op, flat.dtype),
                         dtype=flat.dtype, device=flat.device)
        flat = torch.cat([flat, pad])
    shard = reduce_scatter(flat.reshape(n, padded // n), group, op)
    return shard.reshape(-1), padded


def flat_all_gather(shard: torch.Tensor, group, size: int) -> torch.Tensor:
    """Inverse of :func:`flat_reduce_scatter`'s layout: every rank's flat
    segment in rank order, the padding dropped."""
    return all_gather(shard, group).reshape(-1)[:size]


def all_gather(x: torch.Tensor, group, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` in rank order (``tiled``:
    concatenated; else stacked on a new axis): the ring's all-gather half
    over n − 1 passes."""
    n = group.size
    stacked = x.new_empty((n, *x.shape))
    stacked[group.rank].copy_(x)
    if n > 1:
        _gather([stacked.view(n, -1)], (+1,), group, shift=1)
    if tiled:
        return torch.cat(list(stacked.unbind(0)), dim=axis)
    return stacked.movedim(0, axis)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The exchange of :func:`all_to_all`: rank r's chunk for rank r + d
    rides d ring passes. Step t sends the chunks still on their way (the
    first for the neighbour, the rest for ranks beyond it) one hop on +1;
    the rank keeps the first chunk it receives (from rank r − t) and
    passes the others on."""
    n, r = group.size, group.rank
    chunks = [c.contiguous() for c in x.chunk(n, split_axis)]
    recv = [None] * n
    recv[r] = chunks[r]
    carry = [chunks[(r + d) % n] for d in range(1, n)]
    for t in range(1, n):
        carry = list(ring_pass(carry, group, +1))
        recv[(r - t) % n] = carry[0]
        carry = carry[1:]
    return torch.cat(recv, dim=concat_axis)


def _counted_all_to_all(x, group, split_axis, concat_axis):
    STATS["all_to_all"] += 1
    STATS["all_to_all_bytes"] += x.numel() * x.element_size() * (group.size - 1) // group.size
    return _all_to_all(x, group, split_axis, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _counted_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _counted_all_to_all(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` split into ``group.size`` equal chunks along ``split_axis``, chunk
    i sent to rank i, the chunks received concatenated along
    ``concat_axis`` in source-rank order. Through the ring transport (gloo
    for CPU tensors, the CUDA IPC slots for CUDA ones; one exchange at n =
    2); differentiable, its backward the inverse exchange. Counted in
    :data:`STATS`."""
    if group is None or group.size == 1:
        return x
    if x.shape[split_axis] % group.size:
        raise ValueError(f"all_to_all: dim {split_axis} of size {x.shape[split_axis]} not "
                         f"divisible by axis size {group.size}")
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# In-process all-reduces over a list of per-device tensors (the coordinator's)
# ---------------------------------------------------------------------------


def _local_ring(xs: list, op: ReduceOp, signs: tuple) -> list:
    """:func:`_ring_all_reduce_impl` over ``n`` tensors held by one process,
    rank r's on its own device: the same segments, hops and ``combine``
    order, so the results equal the JAX ring's bit for bit."""
    n = len(xs)
    size = xs[0].numel()
    k = len(signs)
    padded = -(-size // (k * n)) * (k * n)
    part = padded // k
    flats, bufs = [], []
    for x in xs:
        flat = torch.zeros(padded, dtype=_acc_dtype(x.dtype), device=x.device)
        flat[:size].copy_(x.reshape(-1))
        flats.append(flat)
        bufs.append([flat[i * part:(i + 1) * part].view(n, part // n) for i in range(k)])

    def step(idx_send, idx_recv, combine):
        # every rank's hop of this step leaves before any lands
        sent = [[bufs[r][i][idx_send(r, s)].clone() for i, s in enumerate(signs)]
                for r in range(n)]
        for r in range(n):
            for i, s in enumerate(signs):
                dst = (r + s) % n
                resident = bufs[dst][i][idx_recv(dst, s)]
                recv = sent[r][i].to(resident.device)
                if combine is None:
                    resident.copy_(recv)
                else:
                    combine(resident, recv, out=resident)

    for t in range(n - 1):
        step(lambda r, s: (r - s * t) % n, lambda r, s: (r - s * (t + 1)) % n, op.combine)
    for t in range(n - 1):
        step(lambda r, s: (r - s * (t - 1)) % n, lambda r, s: (r - s * t) % n, None)
    outs = []
    for x, flat in zip(xs, flats):
        out = flat[:size]
        if op == ReduceOp.AVG:
            out = _avg(out, n)
        outs.append(out.reshape(x.shape).to(x.dtype))
    return outs


def _local_gather_reduce(xs: list, op: ReduceOp) -> list:
    """The rows reduced in rank order on the first tensor's device and
    copied to every device: ``lax.psum``/``pmin``/``pmax``/``pmean`` and
    the naive gather's ``jnp.sum(axis=0)``, ``((x0 + x1) + x2) …``."""
    n = len(xs)
    dev0 = xs[0].device
    acc = xs[0].to(_acc_dtype(xs[0].dtype)).clone()
    fn = {ReduceOp.SUM: torch.add, ReduceOp.AVG: torch.add, ReduceOp.PROD: torch.mul,
          ReduceOp.MIN: torch.minimum, ReduceOp.MAX: torch.maximum}[op]
    for x in xs[1:]:
        acc = fn(acc, x.to(dev0, acc.dtype))
    if op == ReduceOp.AVG:
        acc = _avg(acc, n)
    return [acc.to(x.device, x.dtype) for x in xs]


def local_all_reduce(xs: list, op: ReduceOp = ReduceOp.SUM, algorithm: str = "ring") -> list:
    """All-reduce ``n`` same-shape tensors held by this process (tensor i
    on its device i) under the JAX package's algorithms, one result per
    input on its device: ``ring`` / ``ring2`` (the ring schedule, in the
    JAX ring's combine order), ``naive`` (gather, then a rank-order
    reduce), ``xla`` (``lax.psum`` and its siblings: the rank-order reduce;
    PROD takes the ring) and ``auto``."""
    op = ReduceOp(op)
    n = len(xs)
    if n == 1:
        return [xs[0].clone()]
    if algorithm == "auto":
        algorithm = auto_all_reduce_algorithm(xs[0].numel() * xs[0].element_size(), n)
    if algorithm == "ring" or (algorithm == "xla" and op == ReduceOp.PROD):
        return _local_ring(xs, op, (+1,))
    if algorithm == "ring2":
        return _local_ring(xs, op, (+1, -1))
    if algorithm in ("naive", "xla"):
        return _local_gather_reduce(xs, op)
    raise ValueError(f"unknown all-reduce algorithm {algorithm!r}")


def device_buffers_all_reduce(buffers: list, op: ReduceOp = ReduceOp.SUM,
                              algorithm: str = "ring", dtype: str = "float32") -> list:
    """All-reduce per-device byte buffers without a host round trip (the
    JAX ``device_buffers_all_reduce``): ``buffers[i]`` is a flat uint8
    tensor on device i (a device server's registry buffer), viewed as
    ``dtype`` for the reduction; returns one flat uint8 tensor per device,
    ready for ``BufferRegistry.put_array``."""
    dt = TORCH_DTYPES.get(str(dtype))
    if dt is None:
        raise ValueError(f"unsupported buffer dtype {dtype!r}")
    count = buffers[0].numel()
    itemsize = torch.empty(0, dtype=dt).element_size()
    if count % itemsize:
        raise ValueError(f"{count} bytes is not a multiple of {dtype} itemsize")
    for i, b in enumerate(buffers):
        if b.dim() != 1 or b.dtype != torch.uint8 or b.numel() != count:
            raise ValueError(f"buffer {i}: expected flat uint8[{count}], got "
                             f"{b.dtype}{tuple(b.shape)}")
    xs = [b.contiguous().view(dt) for b in buffers]
    return [r.contiguous().view(torch.uint8) for r in local_all_reduce(xs, op, algorithm)]


def make_stacked_all_reduce(devices: list, op: ReduceOp = ReduceOp.SUM,
                            algorithm: str = "ring"):
    """A function of a host-side stack ``[n_devices, ...]`` (slice i device
    i's contribution) that places slice i on ``devices[i]``, all-reduces
    them in process (:func:`local_all_reduce`) and returns the ``[n, ...]``
    stack of results on the input's device: every slice the reduction."""
    devices = [torch.device(d) for d in devices]
    op = ReduceOp(op)

    def run(stacked) -> torch.Tensor:
        t = torch.as_tensor(stacked)
        if t.shape[0] != len(devices):
            raise ValueError(f"expected leading dim {len(devices)}, got {tuple(t.shape)}")
        outs = local_all_reduce([t[i].to(d) for i, d in enumerate(devices)], op, algorithm)
        return torch.stack([o.to(t.device) for o in outs])

    return run
