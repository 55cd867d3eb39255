"""Ring collectives over ``torch.distributed`` — the counterpart of
``dsml_tpu/ops/collectives.py``'s ring neighbourhood: :func:`ring_perm_tables`
and :func:`ring_pass`, the one rotate step that ring attention
(``ops/ring_attention.py``) moves its K/V halves and gradient accumulators
through.

A group is a :class:`~dsml_tpu_torch.parallel.peer.RingGroup`. CPU tensors
hop over gloo point-to-point; CUDA tensors through the group's CUDA IPC
transport (``parallel/peer.py``). The route is chosen by the tensors'
device, and a payload that mixes devices raises. The all-reduce family of
the JAX module comes with the data-parallel slice (ROADMAP.md queue 1,
item 6).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_perm_tables", "ring_pass", "ring_pass_start"]

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


def ring_pass(x, group, sign: int = +1):
    """One rotate step of the ring schedule (:func:`ring_pass_start`,
    waited for at once): the counterpart of the JAX ``ring_pass``."""
    return ring_pass_start(x, group, sign, overlap=False).wait()
