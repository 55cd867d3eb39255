"""ctypes bindings of the port's native host runtime (``native/dsml_runtime.cc``).

The library is built with the host compiler the first time it is used:
``g++ -O2 -fPIC -std=c++17 -pthread -shared`` into
``build/native/dsml_runtime-<digest>.so`` at the repo root, the digest
covering the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is (as ``ops/_build.py`` does for the CUDA
sources). A failed build or load raises with the compiler's output: there
is no quiet fall back. The plain Python versions stay beside the calls
(:func:`ring_plan_py`, :func:`reduce_f32_py`,
``utils.crc32c.crc32c_py``); callers and tests choose them by name.

:data:`CALLS` counts the calls into the library by C function, so a run
can show which of them ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "CALLS", "NativeArena", "NativePrefetcher", "NativeStreams", "build", "crc32c",
    "idx_parse", "load", "reduce_f32", "reduce_f32_py", "reset_calls", "ring_plan",
    "ring_plan_py",
]

SOURCE = Path(__file__).resolve().parent / "native" / "dsml_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

DS_OK = 0
DS_IN_PROGRESS = 5

CALLS = {"ds_crc32c": 0, "ds_reduce_f32": 0, "ds_idx_parse": 0, "ds_ring_plan": 0,
         "ds_prefetch_next": 0}

_lib = None
_lock = threading.Lock()


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"dsml_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source is built already; returns
    its path. Raises ``RuntimeError`` with the compiler's output."""
    target = _target()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH to build the native runtime")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sig = {
        "ds_arena_new": (c.c_void_p, [c.c_uint64, c.c_uint64]),
        "ds_arena_free": (None, [c.c_void_p]),
        "ds_arena_write": (c.c_int32, [c.c_void_p, c.c_uint64, c.c_char_p, c.c_uint64]),
        "ds_arena_read": (c.c_int64, [c.c_void_p, c.c_uint64, c.c_void_p, c.c_uint64]),
        "ds_arena_logical_size": (c.c_int64, [c.c_void_p, c.c_uint64]),
        "ds_streams_new": (c.c_void_p, []),
        "ds_streams_free": (None, [c.c_void_p]),
        "ds_stream_arm": (c.c_int32, [c.c_void_p, c.c_void_p, c.c_uint64, c.c_uint64,
                                      c.c_uint64]),
        "ds_stream_push": (c.c_int32, [c.c_void_p, c.c_void_p, c.c_uint64, c.c_char_p,
                                       c.c_uint64, c.c_int32]),
        "ds_stream_status": (c.c_int32, [c.c_void_p, c.c_uint64]),
        "ds_ring_plan": (c.c_int32, [c.c_int32, c.c_int32, c.c_void_p, c.c_void_p]),
        "ds_reduce_f32": (c.c_int32, [c.c_void_p, c.c_int64, c.c_int64, c.c_int32,
                                      c.c_void_p]),
        "ds_idx_parse": (c.c_int64, [c.c_char_p, c.c_uint64, c.c_void_p]),
        "ds_prefetch_new": (c.c_void_p, [c.c_void_p, c.c_uint64, c.c_uint64, c.c_void_p,
                                         c.c_uint64, c.c_uint64, c.c_uint64]),
        "ds_prefetch_next": (c.c_int64, [c.c_void_p, c.c_void_p]),
        "ds_prefetch_free": (None, [c.c_void_p]),
        "ds_crc32c": (c.c_uint32, [c.c_char_p, c.c_uint64, c.c_uint32]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if needed; raises when it cannot be built
    or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the native runtime {path}: {e}") from e
            _lib = _bind(lib)
    return _lib


class NativeArena:
    """Bounds-checked flat-address host buffer registry (C++)."""

    def __init__(self, min_addr: int, size: int):
        self._lib = load()
        self._ptr = self._lib.ds_arena_new(min_addr, size)

    def write(self, addr: int, data: bytes) -> int:
        return self._lib.ds_arena_write(self._ptr, addr, data, len(data))

    def read(self, addr: int, n: int | None = None) -> bytes:
        if n is None:
            n = self._lib.ds_arena_read(self._ptr, addr, None, 0)
            if n < 0:
                raise KeyError(f"arena read failed: status {-n}")
        out = ctypes.create_string_buffer(n)
        rc = self._lib.ds_arena_read(self._ptr, addr, out, n)
        if rc < 0:
            raise KeyError(f"arena read failed: status {-rc}")
        return out.raw[:rc]

    def logical_size(self, addr: int) -> int:
        n = self._lib.ds_arena_logical_size(self._ptr, addr)
        if n < 0:
            raise KeyError(f"no buffer at {addr:#x}")
        return n

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ds_arena_free(self._ptr)
            self._ptr = None


class NativeStreams:
    """Chunked-stream reassembly engine writing into a :class:`NativeArena`."""

    def __init__(self, arena: NativeArena):
        self._lib = arena._lib
        self._arena = arena
        self._ptr = self._lib.ds_streams_new()

    def arm(self, stream_id: int, recv_addr: int, expected: int) -> int:
        return self._lib.ds_stream_arm(self._ptr, self._arena._ptr, stream_id, recv_addr,
                                       expected)

    def push(self, stream_id: int, chunk: bytes, final: bool = False) -> int:
        return self._lib.ds_stream_push(self._ptr, self._arena._ptr, stream_id, chunk,
                                        len(chunk), int(final))

    def status(self, stream_id: int) -> int:
        return self._lib.ds_stream_status(self._ptr, stream_id)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ds_streams_free(self._ptr)
            self._ptr = None


def ring_plan(n: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """The 2(n−1)-step ring segment schedule of ``rank``: (send, recv)
    segment indices, scatter-reduce steps first (C++ planner)."""
    lib = load()
    steps = 2 * (n - 1)
    send = np.zeros(max(steps, 0), np.int32)
    recv = np.zeros(max(steps, 0), np.int32)
    CALLS["ds_ring_plan"] += 1
    rc = lib.ds_ring_plan(n, rank, send.ctypes.data_as(ctypes.c_void_p),
                          recv.ctypes.data_as(ctypes.c_void_p))
    if rc != DS_OK:
        raise ValueError(f"ring_plan({n}, {rank}) failed: {rc}")
    return send, recv


def ring_plan_py(n: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Plain version of :func:`ring_plan`."""
    if n < 2 or not 0 <= rank < n:
        raise ValueError(f"ring_plan({n}, {rank}) failed: 3")
    send = np.zeros(2 * (n - 1), np.int32)
    recv = np.zeros(2 * (n - 1), np.int32)
    for step in range(n - 1):
        send[step] = (rank - step) % n
        recv[step] = (rank - step - 1) % n
        send[n - 1 + step] = (rank - step + 1) % n
        recv[n - 1 + step] = (rank - step) % n
    return send, recv


def reduce_f32(rows: np.ndarray, op: int) -> np.ndarray:
    """Reduce ``[n_rows, n]`` float32 rows elementwise in row order with the
    C++ kernel (``op`` a ``ReduceOp`` value; AVG is the sum times the f32
    reciprocal of ``n_rows``)."""
    rows = np.ascontiguousarray(rows, np.float32)
    lib = load()
    out = np.empty(rows.shape[1], np.float32)
    CALLS["ds_reduce_f32"] += 1
    rc = lib.ds_reduce_f32(rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0], rows.shape[1],
                           int(op), out.ctypes.data_as(ctypes.c_void_p))
    if rc != DS_OK:
        raise ValueError(f"ds_reduce_f32 failed: status {rc} (op {op}, {rows.shape[0]} rows)")
    return out


def reduce_f32_py(rows: np.ndarray, op: int) -> np.ndarray:
    """Plain version of :func:`reduce_f32`: the same row order and the same
    f32 arithmetic, in numpy."""
    rows = np.ascontiguousarray(rows, np.float32)
    if rows.shape[0] < 1 or int(op) not in range(5):
        raise ValueError(f"ds_reduce_f32 failed: status 3 (op {op}, {rows.shape[0]} rows)")
    combine = {0: np.add, 1: np.multiply, 2: np.minimum, 3: np.maximum, 4: np.add}[int(op)]
    out = rows[0].copy()
    for r in range(1, rows.shape[0]):
        # C's `row[i] < out[i] ? row[i] : out[i]` keeps out's NaN, as fmin does not
        if int(op) == 2:
            out = np.where(rows[r] < out, rows[r], out)
        elif int(op) == 3:
            out = np.where(rows[r] > out, rows[r], out)
        else:
            out = combine(out, rows[r])
    if int(op) == 4:
        out = out * (np.float32(1.0) / np.float32(rows.shape[0]))
    return out.astype(np.float32)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data`` with the C kernel; pass the previous
    return value as ``crc`` to roll the checksum across chunks."""
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    lib = load()
    CALLS["ds_crc32c"] += 1
    return int(lib.ds_crc32c(bytes(data), len(data), crc))


def idx_parse(blob: bytes) -> tuple[np.ndarray, tuple[int, ...]]:
    """Parse an un-gzipped IDX blob with the C++ parser: (uint8 payload
    array, dims)."""
    lib = load()
    dims = np.zeros(3, np.int32)
    CALLS["ds_idx_parse"] += 1
    off = lib.ds_idx_parse(blob, len(blob), dims.ctypes.data_as(ctypes.c_void_p))
    if off < 0:
        raise ValueError(f"invalid IDX blob: status {-off}")
    shape = tuple(int(d) for d in dims if d > 0)
    data = np.frombuffer(blob, np.uint8, count=int(np.prod(shape)), offset=int(off))
    return data.reshape(shape), shape


class NativePrefetcher:
    """Background-thread batch pipeline over the C++ loader: a producer
    thread gathers each batch's rows of ``dataset`` into a ring of
    ``depth`` slots while the consumer is inside its device step.

    Iterate to receive ``[batch, *row_shape]`` arrays in index order.
    ``indices`` is ``[n_batches, batch]`` int32 row ids (an epoch's
    permutation reshaped). The dataset and index arrays are borrowed by the
    C++ thread; the prefetcher keeps references so they outlive it. One
    epoch per prefetcher."""

    def __init__(self, dataset: np.ndarray, indices: np.ndarray, depth: int = 2):
        self._lib = load()
        self._data = np.ascontiguousarray(dataset)
        self._idx = np.ascontiguousarray(indices, np.int32)
        if self._idx.ndim != 2:
            raise ValueError(f"indices must be [n_batches, batch], got {self._idx.shape}")
        self._row_shape = self._data.shape[1:]
        self._row_bytes = int(np.prod(self._row_shape, dtype=np.int64)) * self._data.dtype.itemsize
        if not 1 <= int(depth) <= 1024:
            raise ValueError(f"depth must be in [1, 1024], got {depth}")
        self.n_batches, self.batch = map(int, self._idx.shape)
        self._consumed = False
        self._ptr = self._lib.ds_prefetch_new(
            self._data.ctypes.data_as(ctypes.c_void_p), self._data.shape[0], self._row_bytes,
            self._idx.ctypes.data_as(ctypes.c_void_p), self.n_batches, self.batch, int(depth),
        )
        if not self._ptr:
            raise ValueError("bad prefetcher arguments (zero batch/depth/row)")

    def __iter__(self):
        if self._consumed:
            raise RuntimeError("NativePrefetcher is single-use: construct a new one per epoch")
        self._consumed = True
        while True:
            out = np.empty((self.batch, *self._row_shape), self._data.dtype)
            CALLS["ds_prefetch_next"] += 1
            rc = self._lib.ds_prefetch_next(self._ptr, out.ctypes.data_as(ctypes.c_void_p))
            if rc == -1:
                return
            if rc < 0:
                raise IndexError("prefetcher row index out of range")
            yield out

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ds_prefetch_free(self._ptr)
            self._ptr = None
