"""The ring transport: one hop of a tensor payload to a ring neighbour, the
counterpart of XLA's ``ppermute`` (``dsml_tpu/ops/collectives.py::
ring_pass``) and of the Pallas remote copy and semaphores of the fused ring
hop (``dsml_tpu/ops/flash.py::_stream_fwd_kernel``).

A :class:`RingGroup` is one ring of processes: a gloo process group, this
process's position in it, and the device its tensors live on. Routing is
explicit by tensor device, never a fallback:

- CPU tensors go over gloo point-to-point (``ops/collectives.py``).
- CUDA tensors are stored straight into the neighbour's memory. Each rank
  allocates, for each ring direction (+1, -1) and each parity of the
  direction's call count, one receive slot (``csrc/peer_ipc.cu``:
  ``cudaMalloc``, one allocation per slot) and exports it with
  ``cudaIpcGetMemHandle``; its ring neighbours map it once with
  ``cudaIpcOpenMemHandle``. A sender writes its payload into the mapped
  slot (a stream-ordered copy, or kernel 4's stores,
  ``ops/flash.py::flash_stream_hop``) and records an interprocess CUDA
  event that the receiver's stream waits on before it reads the slot; the
  receiver then records an interprocess "slot free" event that the
  sender's stream waits on before it writes that slot again, two calls
  later. Two processes on one card can map each other's memory this way
  (the card then time-slices their kernels); ranks on several cards of one
  host map across NVLink.

A stream can wait only on an event record that has been issued, so every
record is announced on the host: the ranks of a ring share a small file of
counters (a notice board, memory-mapped by every rank; CUDA IPC works only
between processes of one host anyway), each rank counts there the payloads
it has written and freed per direction, and a rank polls its peer's
counter before it enqueues its wait. Only the host polls: no kernel spins
on a flag that another process writes (two contexts on one card are
time-sliced, and such a spin could stall the card). A peer that died never
posts: the wait also polls an abort file in the ring's workdir
(``ABORT``, written by whoever supervises the ranks: ``parallel/world.py``)
and raises within milliseconds of it appearing, instead of after
``TIMEOUT_S``.

The received payload is copied out of the slot into fresh tensors (one
extra device copy per hop), so a slot is free as soon as that copy has
run.

Traps: a process cannot open an IPC handle of its own allocation (a ring
of one never opens any); a handle maps a whole ``cudaMalloc`` block, which
is why the slots are allocated in ``csrc/peer_ipc.cu`` and not by PyTorch's
caching allocator, whose expandable segments cannot be exported at all;
the mappings are closed, on every rank, before any rank frees its slots
(:meth:`RingGroup.close`).
"""

from __future__ import annotations

import ctypes
import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from dsml_tpu_torch.ops import _build

__all__ = ["RingGroup"]

_ALIGN = 256  # payload offsets inside a slot: a 16-byte store path needs 16
_MIN_CAPACITY = 1 << 20
_DATA, _FREE = 0, 1  # notice kinds: "slot written", "slot read"
TIMEOUT_S = 600.0  # a rank that waits longer than this on another raises
_SIGN = {+1: 0, -1: 1}
ABORT_FILE = "ABORT"  # in a ring's workdir: its peers are gone, stop waiting
_ABORT_EVERY = 256  # spins between two looks at the abort file


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("peer_ipc")
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.peer_malloc.argtypes = [i, sz, ctypes.POINTER(vp)]
    lib.peer_free.argtypes = [i, vp]
    lib.peer_ipc_handle.argtypes = [i, vp, ctypes.c_char_p]
    lib.peer_ipc_open.argtypes = [i, ctypes.c_char_p, ctypes.POINTER(vp)]
    lib.peer_ipc_close.argtypes = [i, vp]
    lib.peer_copy.argtypes = [i, vp, vp, sz, vp]
    lib.peer_error_string.argtypes = [i]
    lib.peer_error_string.restype = ctypes.c_char_p
    for fn in (lib.peer_malloc, lib.peer_free, lib.peer_ipc_handle, lib.peer_ipc_open,
               lib.peer_ipc_close, lib.peer_copy, lib.peer_handle_size):
        fn.restype = i
    return lib


def _call(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} failed: {lib.peer_error_string(err).decode()}")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _payload_bytes(tensors) -> int:
    """Slot bytes a payload of ``tensors`` takes (each at a 256-byte
    offset)."""
    return sum(_align(t.numel() * t.element_size()) for t in tensors)


class _NoticeBoard:
    """Host counters shared by the ranks of one ring through a memory-mapped
    file: row r holds, per notice kind and direction, how many notices rank
    r has posted. Each rank writes only its own row."""

    def __init__(self, path: str, size: int, rank: int, abort_path: str | None = None):
        self.arr = np.memmap(path, dtype=np.int64, mode="r+", shape=(size, 2, 2))
        self.rank = rank
        self.abort_path = abort_path

    def post(self, kind: int, sign: int, count: int) -> None:
        """Notice number ``count`` (from 0) of this kind is out."""
        self.arr[self.rank, kind, _SIGN[sign]] = count + 1

    def wait(self, pos: int, kind: int, sign: int, count: int) -> None:
        """Block until rank ``pos`` has posted notice ``count`` of this
        kind (polling host memory); raises after the timeout, or as soon
        as the abort file appears."""
        cell = (pos, kind, _SIGN[sign])
        deadline, spins = None, 0
        while self.arr[cell] <= count:
            spins += 1
            if spins > 1000:
                if spins % _ABORT_EVERY == 0 and self.abort_path is not None \
                        and os.path.exists(self.abort_path):
                    raise RuntimeError(
                        f"ring transport: aborted while waiting for rank {pos}'s "
                        f"{('data', 'free')[kind]} notice {count} (a peer of this ring died)")
                deadline = deadline or time.monotonic() + TIMEOUT_S
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ring transport: rank {pos} posted no {('data', 'free')[kind]} notice "
                        f"{count} in direction {sign:+d} within {TIMEOUT_S} s "
                        f"(it has posted {int(self.arr[cell])})")
                time.sleep(20e-6)


class RingGroup:
    """One ring of ``len(ranks)`` processes over the gloo process group
    ``pg``; ``ranks`` are the global ranks in ring order and ``rank`` is
    this process's position. ``device`` is where its tensors live (the
    CUDA transport opens at the first CUDA payload); ``workdir`` is a
    directory every rank sees (the rendezvous file's), where the CUDA
    transport keeps its notice board, in a file named after ``name`` (every
    ring of one mesh has its own: ``parallel/mesh.py`` names them after the
    axis and the group's first rank)."""

    def __init__(self, pg, ranks, rank: int, device, workdir: str | None = None,
                 name: str = "ring"):
        self.pg = pg
        self.ranks = list(ranks)
        self.rank = rank
        self.size = len(self.ranks)
        self.device = torch.device(device)
        self.workdir = workdir
        self.name = name
        self._ipc = None
        self._side = None

    def dst(self, sign: int) -> int:
        """Ring position this rank sends to in direction ``sign``."""
        return (self.rank + sign) % self.size

    def src(self, sign: int) -> int:
        """Ring position this rank receives from in direction ``sign``."""
        return (self.rank - sign) % self.size

    def global_rank(self, pos: int) -> int:
        return self.ranks[pos]

    def side_stream(self) -> torch.cuda.Stream:
        """The stream a hop issued ahead of the math runs on."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def ipc(self) -> "_IpcRing":
        """The CUDA transport, opened (collectively) at first use."""
        if self.device.type != "cuda" or self.workdir is None:
            raise ValueError(f"the CUDA ring transport needs a CUDA group device and a shared "
                             f"workdir, got {self.device} and {self.workdir!r}")
        if self._ipc is None:
            self._ipc = _IpcRing(self)
        return self._ipc

    def close(self) -> None:
        """Close the CUDA transport, if open: a collective call."""
        if self._ipc is not None:
            self._ipc.close()
            self._ipc = None


class _IpcRing:
    """Receive slots, their peer mappings and the interprocess events of
    one :class:`RingGroup` (see the module docstring)."""

    def __init__(self, group: RingGroup):
        self.g = group
        self.dev = group.device.index if group.device.index is not None else torch.cuda.current_device()
        self.capacity = 0
        self.slots: dict = {}
        self._open(_MIN_CAPACITY)

    @property
    def slot_bytes(self) -> int:
        """Device bytes this rank's receive slots hold (``cudaMalloc``'d
        outside PyTorch's allocator): 4 slots of ``capacity``."""
        return len(self._keys()) * self.capacity

    # ---- set-up and tear-down (collective) -------------------------------------

    def _keys(self):
        return [(sign, par) for sign in (+1, -1) for par in (0, 1)]

    def _open(self, capacity: int) -> None:
        g, lib = self.g, _lib()
        n_handle = lib.peer_handle_size()
        board = os.path.join(g.workdir, f"{g.name}_notices.bin")
        if g.rank == 0:  # every counter 0; never truncated under another rank's mapping
            with open(board, "ab"):
                pass
            with open(board, "r+b") as f:
                f.write(bytes(g.size * 2 * 2 * 8))
        handles: dict = {"slot": {}, "data": {}, "free": {}}
        self.ev_data, self.ev_free = {}, {}
        with torch.cuda.device(self.dev):
            for key in self._keys():
                ptr = ctypes.c_void_p()
                _call("peer_malloc", self.dev, capacity, ctypes.byref(ptr))
                self.slots[key] = ptr.value
                buf = ctypes.create_string_buffer(n_handle)
                _call("peer_ipc_handle", self.dev, ctypes.c_void_p(ptr.value), buf)
                handles["slot"][key] = buf.raw
                # data: this rank writes direction `sign`; free: this rank read it
                self.ev_data[key] = torch.cuda.Event(interprocess=True)
                self.ev_free[key] = torch.cuda.Event(interprocess=True)
                handles["data"][key] = self.ev_data[key].ipc_handle()
                handles["free"][key] = self.ev_free[key].ipc_handle()
            everyone = [None] * g.size
            # also the barrier after rank 0 zeroed the board
            dist.all_gather_object(everyone, handles, group=g.pg)
            self.board = _NoticeBoard(board, g.size, g.rank,
                                      os.path.join(g.workdir, ABORT_FILE))
            self.peer_slot, self.peer_free, self.peer_data = {}, {}, {}
            for key in self._keys():
                sign = key[0]
                dst, src = everyone[g.dst(sign)], everyone[g.src(sign)]
                ptr = ctypes.c_void_p()
                _call("peer_ipc_open", self.dev, dst["slot"][key], ctypes.byref(ptr))
                self.peer_slot[key] = ptr.value
                self.peer_free[key] = torch.cuda.Event.from_ipc_handle(self.dev, dst["free"][key])
                self.peer_data[key] = torch.cuda.Event.from_ipc_handle(self.dev, src["data"][key])
        self.capacity = capacity
        self.sent = {+1: 0, -1: 0}      # payloads sent per direction (parity = count % 2)
        self.received = {+1: 0, -1: 0}
        self.sending = None

    def _drain(self) -> None:
        """Wait until no slot of any rank is in use: every rank's device
        idle, then a barrier."""
        torch.cuda.synchronize(self.dev)
        dist.barrier(group=self.g.pg)

    def _release(self) -> None:
        """Close this rank's mappings of its neighbours' slots, then, once
        every rank has, free its own slots."""
        self.unmap_local()
        dist.barrier(group=self.g.pg)
        self.free_local()

    def unmap_local(self) -> None:
        """Close this rank's mappings of its neighbours' slots, with no
        collective (a world whose peer died leaves this way; every rank
        unmaps before any rank calls :meth:`free_local`)."""
        for ptr in self.peer_slot.values():
            _call("peer_ipc_close", self.dev, ctypes.c_void_p(ptr))
        self.peer_slot.clear()
        self.peer_free.clear()
        self.peer_data.clear()

    def free_local(self) -> None:
        """Free this rank's own slots (after every rank's :meth:`unmap_local`)."""
        for ptr in self.slots.values():
            _call("peer_free", self.dev, ctypes.c_void_p(ptr))
        self.slots.clear()
        self.board = None

    def reserve(self, nbytes: int) -> None:
        """Grow every slot to at least ``nbytes``: a collective call that
        every rank makes at the same point of the program (the ring's
        payloads have the same shapes on every rank)."""
        if nbytes <= self.capacity:
            return
        self._drain()
        self._release()
        self._open(max(_align(nbytes), 2 * self.capacity))

    def close(self) -> None:
        self._drain()
        self._release()

    # ---- one payload --------------------------------------------------------------

    def send_begin(self, sign: int, tensors) -> list[int]:
        """Device pointers, in the ``sign`` neighbour's receive slot, where
        ``tensors`` go; the current stream has waited until that slot is
        free. Write them on the current stream, then :meth:`send_end`."""
        if self.sending is not None:
            raise RuntimeError(f"ring send in direction {self.sending[0]} was not ended")
        self.reserve(_payload_bytes(tensors))
        count = self.sent[sign]
        key = (sign, count % 2)
        stream = torch.cuda.current_stream(self.dev)
        if count >= 2:  # the slot held payload count − 2: wait until it is read
            self.board.wait(self.g.dst(sign), _FREE, sign, count - 2)
            stream.wait_event(self.peer_free[key])
        ptrs, off = [], 0
        for t in tensors:
            ptrs.append(self.peer_slot[key] + off)
            off += _align(t.numel() * t.element_size())
        self.sending = (sign, key, count)
        return ptrs

    def send_end(self, sign: int) -> None:
        """The payload's writes are enqueued on the current stream: record
        the data event and tell the receiver."""
        if self.sending is None or self.sending[0] != sign:
            raise RuntimeError(f"ring send_end({sign}) without a matching send_begin")
        _, key, count = self.sending
        self.sending = None
        self.ev_data[key].record(torch.cuda.current_stream(self.dev))
        self.board.post(_DATA, sign, count)
        self.sent[sign] = count + 1

    def recv(self, sign: int, like) -> list[torch.Tensor]:
        """The payload the ``sign`` source wrote into this rank's slot, as
        fresh tensors shaped like ``like``, copied on the current stream."""
        count = self.received[sign]
        key = (sign, count % 2)
        self.board.wait(self.g.src(sign), _DATA, sign, count)
        stream = torch.cuda.current_stream(self.dev)
        stream.wait_event(self.peer_data[key])
        outs, off = [], 0
        for t in like:
            o = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            nbytes = o.numel() * o.element_size()
            _call("peer_copy", self.dev, ctypes.c_void_p(o.data_ptr()),
                  ctypes.c_void_p(self.slots[key] + off), nbytes, ctypes.c_void_p(stream.cuda_stream))
            outs.append(o)
            off += _align(nbytes)
        self.ev_free[key].record(stream)
        self.board.post(_FREE, sign, count)
        self.received[sign] = count + 1
        return outs

    def exchange(self, tensors, sign: int) -> list[torch.Tensor]:
        """Send ``tensors`` (contiguous CUDA tensors) one hop in direction
        ``sign`` and return what arrives from the other side."""
        stream = torch.cuda.current_stream(self.dev)
        ptrs = self.send_begin(sign, tensors)
        for t, ptr in zip(tensors, ptrs):
            _call("peer_copy", self.dev, ctypes.c_void_p(ptr), ctypes.c_void_p(t.data_ptr()),
                  t.numel() * t.element_size(), ctypes.c_void_p(stream.cuda_stream))
        self.send_end(sign)
        return self.recv(sign, tensors)
