"""L1 — one device server: buffers on a torch device, P2P streams, compute.

The port's counterpart of ``dsml_tpu/comm/device_server.py``, the rebuild
of the reference's simulated GPU (``DSML/gpu_device_service/
gpu_device_server.go``). Every buffer written through ``Memcpy`` is a flat
``torch.uint8`` tensor on the server's device (the card by default);
``RunForward`` / ``RunBackward`` run the MLP's flat programs there; P2P
streams move bytes device server → device server over ``StreamSend``.

Semantics kept from the reference and the JAX package:

- a flat address space ``[0x1000, 0x1000 + memSize)`` with bounds checks;
  a short write splices into a longer resident buffer (on the device) and
  the logical size is the most recent write's;
- the stream lifecycle IN_PROGRESS → SUCCESS / FAILED with length
  validation, a TTL GC of terminal entries, a stall verdict
  (``DSML_STREAM_STALL_S``) and ``take_partial`` for resumable migration;
- ``GetDeviceMetadata`` advertising the address range.

:class:`BufferRegistry` and :class:`DeviceRuntime` import neither grpc nor
protobuf: a :class:`DeviceError` carries a status code of its own, named
as grpc's (``"NOT_FOUND"``), which :class:`DeviceServicer` maps to
``grpc.StatusCode`` by name. Servers sharing a device (several on one card)
each hold their own registry; reads to the host synchronise.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.obs import get_registry, span
from dsml_tpu_torch.utils.config import env_float as _env_float
from dsml_tpu_torch.utils.logging import get_logger
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = [
    "DEFAULT_MIN_ADDR", "FAILED", "IN_PROGRESS", "SUCCESS", "BufferRegistry", "DeviceError",
    "DeviceRuntime", "DeviceServerHandle", "DeviceServicer", "StreamState", "local_device",
    "serve_device", "serve_local_devices",
]

log = get_logger("device")

DEFAULT_MIN_ADDR = 0x1000  # the reference's base address (gpu_device_server.go:45)
_STREAM_CHUNK = 1 << 18  # 256 KiB per DataChunk

# stream statuses: the values of the wire enum gpu_sim.Status
IN_PROGRESS, SUCCESS, FAILED = 0, 1, 2

# Process-local registry: deviceId -> DeviceRuntime. Lets a colocated
# coordinator reach device buffers without its own socket (the reference
# ran all "devices" as goroutines of one process too).
_LOCAL_DEVICES: dict[int, "DeviceRuntime"] = {}
_LOCAL_LOCK = threading.Lock()


def local_device(device_id: int) -> "DeviceRuntime | None":
    with _LOCAL_LOCK:
        return _LOCAL_DEVICES.get(device_id)


class DeviceError(Exception):
    """A device-side refusal. ``code`` is a status name of grpc's
    (``"OUT_OF_RANGE"``, ``"NOT_FOUND"``, …); the servicers abort the RPC
    with ``grpc.StatusCode[code]``."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = str(getattr(code, "name", code))


@dataclass
class StreamState:
    """One P2P stream (reference StreamState, gpu_device_server.go:14-24)."""

    stream_id: int
    status: int = IN_PROGRESS
    send_addr: int | None = None
    num_bytes: int = 0
    dst_rank: int | None = None
    src_rank: int | None = None
    recv_addr: int | None = None
    chunks: list[bytes] = field(default_factory=list)
    received: int = 0
    armed: bool = False  # BeginReceive seen
    sender_done: bool = False  # StreamSend finished delivering
    # lifecycle stamps (monotonic clock): terminal streams are TTL-evicted,
    # and an armed stream making no progress past the stall deadline is
    # FAILED instead of staying IN_PROGRESS forever
    created_at: float = field(default_factory=time.monotonic)
    done_at: float | None = None
    last_progress: float = field(default_factory=time.monotonic)
    fail_reason: str = ""


def _as_u8(data, device: torch.device) -> torch.Tensor:
    """Bytes, a numpy array or a tensor as a flat uint8 tensor on ``device``,
    in memory of its own that torch allocated (aligned as every other
    tensor: a matmul's blocking, and so its rounding, may depend on it)."""
    if isinstance(data, torch.Tensor):
        t = data.detach().contiguous().reshape(-1)
        t = t if t.dtype == torch.uint8 else t.view(torch.uint8)
        return t.to(device, copy=True)
    src = (np.ascontiguousarray(data).reshape(-1).view(np.uint8) if isinstance(data, np.ndarray)
           else np.frombuffer(data, np.uint8))
    host = torch.empty(src.size, dtype=torch.uint8)
    host.numpy()[:] = src
    return host.to(device)


class BufferRegistry:
    """Address-keyed device buffers: each entry a flat ``torch.uint8``
    tensor on ``device``. Entries are replaced, never written in place, so
    a view handed out stays what it was."""

    def __init__(self, device: torch.device, min_addr: int, mem_size: int):
        self.device = torch.device(device)
        self.min_addr = min_addr
        self.max_addr = min_addr + mem_size
        self._buffers: dict[int, torch.Tensor] = {}
        # logical payload size = bytes of the most recent write at an addr
        # (a short write splices into a larger resident buffer)
        self._last_write: dict[int, int] = {}
        self._lock = threading.Lock()

    def check_bounds(self, addr: int, num_bytes: int = 0) -> None:
        if addr < self.min_addr or addr + num_bytes > self.max_addr:
            raise DeviceError(
                "OUT_OF_RANGE",
                f"address range [{addr:#x}, {addr + num_bytes:#x}) outside "
                f"device memory [{self.min_addr:#x}, {self.max_addr:#x})",
            )

    def write(self, addr: int, data) -> None:
        nbytes_in = (data.numel() * data.element_size() if isinstance(data, torch.Tensor)
                     else data.nbytes if isinstance(data, np.ndarray) else len(data))
        self.check_bounds(addr, nbytes_in)
        buf = _as_u8(data, self.device)
        with self._lock:
            existing = self._buffers.get(addr)
            if existing is not None and existing.numel() > nbytes_in:
                # partial write into a larger resident buffer: splice into
                # the prefix on the device, keep the tail
                spliced = existing.clone()
                spliced[:nbytes_in].copy_(buf)
                buf = spliced
            self._buffers[addr] = buf
            self._last_write[addr] = nbytes_in

    def put_array(self, addr: int, arr: torch.Tensor, logical_nbytes: int | None = None) -> None:
        """Store a flat uint8 tensor already on the device (the compute and
        collective paths). ``logical_nbytes`` records a payload shorter
        than the tensor (a reduced prefix spliced into a longer buffer)."""
        if arr.dtype != torch.uint8 or arr.dim() != 1:
            raise ValueError(f"put_array takes a flat uint8 tensor, got {arr.dtype}{tuple(arr.shape)}")
        self.check_bounds(addr, arr.numel())
        with self._lock:
            self._buffers[addr] = arr
            self._last_write[addr] = logical_nbytes if logical_nbytes is not None else arr.numel()

    def logical_nbytes(self, addr: int) -> int:
        """Size of the most recent payload written at ``addr`` (≤ physical)."""
        with self._lock:
            if addr not in self._buffers:
                raise DeviceError("NOT_FOUND", f"no buffer at address {addr:#x}")
            return self._last_write.get(addr, self._buffers[addr].numel())

    def get_logical_array(self, addr: int) -> torch.Tensor:
        """The current payload at ``addr``: the resident tensor sliced to
        the most recent write's length, read under one lock acquisition."""
        with self._lock:
            arr = self._buffers.get(addr)
            if arr is None:
                raise DeviceError("NOT_FOUND", f"no buffer at address {addr:#x}")
            nbytes = self._last_write.get(addr, arr.numel())
        return arr[:nbytes] if nbytes < arr.numel() else arr

    def read(self, addr: int, num_bytes: int | None = None) -> np.ndarray:
        """The buffer's bytes on the host (the whole physical buffer when
        ``num_bytes`` is None); synchronises with the device."""
        arr = self.get_array(addr)
        if num_bytes is not None:
            if num_bytes > arr.numel():
                raise DeviceError(
                    "OUT_OF_RANGE",
                    f"requested {num_bytes} bytes from {arr.numel()}-byte buffer at {addr:#x}",
                )
            arr = arr[:num_bytes]
        return arr.cpu().numpy()

    def get_array(self, addr: int) -> torch.Tensor:
        with self._lock:
            arr = self._buffers.get(addr)
        if arr is None:
            raise DeviceError("NOT_FOUND", f"no buffer at address {addr:#x}")
        return arr

    def nbytes(self, addr: int) -> int:
        return self.get_array(addr).numel()


def _f32(raw: torch.Tensor) -> torch.Tensor:
    """A flat uint8 device buffer viewed as float32 (its offset is 0 and it
    is contiguous: every registry entry and logical prefix is)."""
    return raw.contiguous().view(torch.float32)


class DeviceRuntime:
    """The device logic, directly callable (the servicer's calls, without
    the wire)."""

    def __init__(
        self,
        device_id: int,
        mem_size: int = 0x3000,
        device: str | torch.device | None = None,
        min_addr: int = DEFAULT_MIN_ADDR,
        model: MLP | None = None,
        weights_addr: int = 0x2000,
    ):
        self.device_id = device_id
        self.device = resolve_device(device)
        self._cpu_threads = torch.get_num_threads()
        self.memory = BufferRegistry(self.device, min_addr, mem_size)
        self.streams: dict[int, StreamState] = {}
        self._stream_lock = threading.Lock()
        # stream ids are sender-namespaced (device_id << 32 | counter); a
        # random counter origin keeps a restarted sender from reusing ids a
        # long-lived receiver still holds as terminal entries
        self._next_stream = int.from_bytes(os.urandom(4), "little") % (1 << 31) or 1
        self.peers: dict[int, str] = {}
        self.self_rank: int | None = None
        self._peer_stubs: dict = {}
        self._peer_lock = threading.Lock()
        # on-device compute: the flat-f32 MLP programs (RunForward/RunBackward)
        self.model = model or MLP(device=self.device)
        self.weights_addr = weights_addr
        self._last_input: torch.Tensor | None = None
        self.bound_address: str | None = None  # set by serve_device once bound
        self.donor = None  # StateDonor, attached by serve_device
        with _LOCAL_LOCK:
            _LOCAL_DEVICES[device_id] = self

    def bind_thread(self) -> None:
        """Set up the calling thread (a gRPC handler's) for this device: its
        card becomes the thread's current CUDA device (handler threads start
        on device 0); on the CPU the thread takes the intra-op thread count
        the runtime was built under, since a CPU matmul's rounding depends
        on how many threads split it."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        elif self.device.type == "cpu" and torch.get_num_threads() != self._cpu_threads:
            torch.set_num_threads(self._cpu_threads)

    # ---- metadata -------------------------------------------------------------

    def metadata(self):
        """``gpu_sim.DeviceMetadata`` of this device (needs protobuf)."""
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        return pb.DeviceMetadata(
            deviceId=pb.DeviceId(value=self.device_id),
            minMemAddr=pb.MemAddr(value=self.memory.min_addr),
            maxMemAddr=pb.MemAddr(value=self.memory.max_addr),
        )

    # ---- memcpy ---------------------------------------------------------------

    def memcpy_h2d(self, addr: int, data) -> None:
        self.memory.write(addr, data)

    def memcpy_d2h(self, addr: int, num_bytes: int | None) -> bytes:
        return self.read_bytes(addr, num_bytes)

    def read_bytes(self, addr: int, num_bytes: int | None = None) -> bytes:
        return self.memory.read(addr, num_bytes).tobytes()

    # ---- streams --------------------------------------------------------------

    def begin_send(self, send_addr: int, num_bytes: int, dst_rank: int) -> int:
        self.memory.check_bounds(send_addr, num_bytes)
        with self._stream_lock:
            # globally unique id (sender-namespaced): two devices' concurrent
            # sends to one receiver must not collide in its stream table
            stream_id = (self.device_id << 32) | self._next_stream
            self._next_stream += 1
            self.streams[stream_id] = StreamState(
                stream_id, send_addr=send_addr, num_bytes=num_bytes, dst_rank=dst_rank
            )
            self._update_stream_gauge_locked()
        # push the payload to the destination in the background, as the
        # proto intends
        threading.Thread(target=self._push_stream, args=(stream_id,), daemon=True).start()
        return stream_id

    def begin_receive(self, stream_id: int, recv_addr: int, num_bytes: int, src_rank: int) -> None:
        self.memory.check_bounds(recv_addr, num_bytes)
        with self._stream_lock:
            st = self.streams.get(stream_id)
            if st is None or st.status != IN_PROGRESS:
                # arming a TERMINAL id means the sender recycled it (a
                # restarted peer): a fresh state, never stale bytes
                st = self.streams[stream_id] = StreamState(stream_id)
            st.recv_addr = recv_addr
            st.num_bytes = num_bytes
            st.src_rank = src_rank
            st.armed = True
            st.last_progress = time.monotonic()
            self._maybe_complete_locked(st)
            self._update_stream_gauge_locked()

    def receive_chunks(self, chunk_iter) -> bool:
        """StreamSend handler: accumulate chunks (each with ``streamId`` and
        ``data``); complete when the armed length arrives."""
        stream_id = None
        seen: set = set()
        for chunk in chunk_iter:
            with self._stream_lock:
                st = self.streams.get(chunk.streamId)
                if st is None or (st.status != IN_PROGRESS and chunk.streamId not in seen):
                    # first chunk of a stream whose id maps to a TERMINAL
                    # entry: a restarted sender recycled the id — a NEW
                    # stream. A stream that goes terminal mid-call keeps its
                    # entry: those chunks are the old stream's stragglers.
                    st = self.streams[chunk.streamId] = StreamState(chunk.streamId)
                seen.add(chunk.streamId)
                stream_id = chunk.streamId
                st.chunks.append(chunk.data)
                st.received += len(chunk.data)
                st.last_progress = time.monotonic()
        if stream_id is None:
            return False
        with self._stream_lock:
            st = self.streams[stream_id]
            st.sender_done = True
            ok = self._maybe_complete_locked(st, final=True)
        # GC on the receive path too: a receive-only server never pushes
        self._gc_streams()
        return ok

    def _maybe_complete_locked(self, st: StreamState, final: bool = False) -> bool:
        if st.status != IN_PROGRESS:
            # terminal is terminal: a late full delivery on a failed stream
            # must not write to recv_addr (it may be re-armed already)
            return st.status == SUCCESS
        if not st.armed or st.recv_addr is None:
            return True  # waiting for BeginReceive; chunks stay buffered
        # a late BeginReceive must still see that the sender finished
        final = final or st.sender_done
        if st.received == st.num_bytes and st.num_bytes > 0:
            data = b"".join(st.chunks)
            st.chunks = []  # the payload now lives in the registry
            try:
                self.memory.write(st.recv_addr, data)
            except DeviceError as e:
                self._finish_locked(st, FAILED, f"recv write failed: {e}")
                return False
            self._finish_locked(st, SUCCESS)
            return True
        if final or st.received > st.num_bytes:
            self._finish_locked(st, FAILED,
                                f"length mismatch: received {st.received} of {st.num_bytes}")
            return False
        return True

    def _finish_locked(self, st: StreamState, status: int, reason: str = "") -> None:
        """Terminal transition (idempotent): stamp ``done_at`` for the TTL
        GC, count failures, refresh the active gauge."""
        if st.status != IN_PROGRESS:
            return
        st.status = status
        st.done_at = time.monotonic()
        if status == FAILED:
            st.fail_reason = reason
            reg = get_registry()
            if reg.enabled:
                reg.counter("comm_stream_failures_total", "P2P streams that ended FAILED",
                            labels=("device",)).inc(device=self.device_id)
            if reason:
                log.warning("device %d: stream %d FAILED: %s", self.device_id, st.stream_id, reason)
        self._update_stream_gauge_locked()

    def _update_stream_gauge_locked(self) -> None:
        reg = get_registry()
        if reg.enabled:
            reg.gauge("comm_streams_active", "P2P streams not yet terminal",
                      labels=("device",)).set(
                sum(1 for s in self.streams.values() if s.status == IN_PROGRESS),
                device=self.device_id,
            )

    def stream_status(self, stream_id: int) -> int:
        stall_s = _env_float("DSML_STREAM_STALL_S", 120.0)
        with self._stream_lock:
            st = self.streams.get(stream_id)
            if st is None:
                raise DeviceError("NOT_FOUND", f"unknown stream {stream_id}")
            # stall verdict at the query point: an armed stream with no
            # progress past the deadline is FAILED (retry / resume)
            if (st.status == IN_PROGRESS and stall_s > 0
                    and time.monotonic() - st.last_progress > stall_s):
                self._finish_locked(st, FAILED, f"stalled: no progress in {stall_s:.0f}s "
                                                f"({st.received}/{st.num_bytes} bytes)")
            return st.status

    def take_partial(self, stream_id: int) -> bytes:
        """Harvest the contiguous prefix a dead or stalled stream delivered
        and mark it FAILED: migration re-requests the rest from
        ``len(prefix)``."""
        with self._stream_lock:
            st = self.streams.get(stream_id)
            if st is None:
                raise DeviceError("NOT_FOUND", f"unknown stream {stream_id}")
            prefix = b"".join(st.chunks)
            st.chunks = []
            st.received = 0
            self._finish_locked(st, FAILED, "partial prefix harvested for resume")
            return prefix

    # ---- peer table + background push ------------------------------------------

    def configure_peers(self, peers: dict[int, str], self_rank: int) -> None:
        with self._peer_lock:
            self.peers = dict(peers)
            self.self_rank = self_rank
            self._peer_stubs.clear()

    def _peer_stub(self, rank: int):
        import grpc

        from dsml_tpu_torch.comm import rpc

        with self._peer_lock:
            stub = self._peer_stubs.get(rank)
            if stub is None:
                addr = self.peers.get(rank)
                if addr is None:
                    raise DeviceError("FAILED_PRECONDITION", f"no peer address for rank {rank}")
                stub = rpc.device_stub(grpc.insecure_channel(addr))
                self._peer_stubs[rank] = stub
            return stub

    def _push_stream(self, stream_id: int) -> None:
        with self._stream_lock:
            st = self.streams[stream_id]
            send_addr, num_bytes, dst_rank = st.send_addr, st.num_bytes, st.dst_rank
        try:
            self.bind_thread()
            payload = self.read_bytes(send_addr, num_bytes)
            if dst_rank is not None and dst_rank == self.self_rank:
                # local delivery: the sender's StreamState IS the receiver's
                with self._stream_lock:
                    st = self.streams[stream_id]
                    st.chunks.append(payload)
                    st.received += len(payload)
                    st.sender_done = True  # a late mismatched arm must FAIL, not hang
                    self._maybe_complete_locked(st, final=True)
            else:
                self._push_remote(stream_id, payload, dst_rank)
        except Exception as e:  # noqa: BLE001 — the background thread must record failure
            log.warning("device %d: stream %d push failed: %s", self.device_id, stream_id, e)
            with self._stream_lock:
                self._finish_locked(self.streams[stream_id], FAILED, f"push failed: {e}")
        self._gc_streams()

    def _push_remote(self, stream_id: int, payload: bytes, dst_rank: int) -> None:
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb
        from dsml_tpu_torch.runtime import chaos

        # wire-fault injection: the plan may corrupt the payload, delay the
        # push, truncate it mid-stream (drop) or sever the link (partition)
        fault = None
        plan = chaos.wire_fault_plan()
        if plan is not None:
            fault = plan.on_send(self.self_rank, dst_rank)
        if fault is not None:
            payload = fault.apply_payload(payload)
            if fault.action == "partition":
                raise RuntimeError(f"wire fault: link to rank {dst_rank} partitioned")
        stub = self._peer_stub(dst_rank)

        def chunks():
            if fault is not None and fault.action == "drop":
                # truncate mid-stream: half the payload in normal-size chunks
                # (one oversized message would hit grpc's 4 MiB cap), then
                # error the call; the sleep lets grpc flush the prefix first
                cut = max(1, len(payload) // 2)
                for off in range(0, cut, _STREAM_CHUNK):
                    yield pb.DataChunk(data=payload[off:off + _STREAM_CHUNK], streamId=stream_id)
                time.sleep(0.05)
                raise RuntimeError("wire fault: stream dropped")
            for off in range(0, len(payload), _STREAM_CHUNK):
                # progress heartbeat: a sender mid-push is not stalled
                with self._stream_lock:
                    sending = self.streams.get(stream_id)
                    if sending is not None:
                        sending.last_progress = time.monotonic()
                yield pb.DataChunk(data=payload[off:off + _STREAM_CHUNK], streamId=stream_id)

        ok = stub.StreamSend(chunks()).success
        with self._stream_lock:
            self._finish_locked(self.streams[stream_id], SUCCESS if ok else FAILED,
                                "" if ok else "receiver reported failure")

    _MAX_STREAMS = 4096

    def _gc_streams(self) -> None:
        """Evict terminal streams after ``DSML_STREAM_TTL_S`` (default
        300 s), with a size cap as a backstop inside one TTL window."""
        ttl_s = _env_float("DSML_STREAM_TTL_S", 300.0)
        now = time.monotonic()
        with self._stream_lock:
            for sid in [sid for sid, s in self.streams.items()
                        if s.done_at is not None and now - s.done_at > ttl_s]:
                del self.streams[sid]
            if len(self.streams) > self._MAX_STREAMS:
                for sid in [s.stream_id for s in self.streams.values() if s.status != IN_PROGRESS]:
                    del self.streams[sid]
                    if len(self.streams) <= self._MAX_STREAMS // 2:
                        break
            self._update_stream_gauge_locked()

    # ---- on-device compute ------------------------------------------------------

    def _flat_params(self) -> torch.Tensor:
        raw = self.memory.get_logical_array(self.weights_addr)
        if raw.numel() != self.model.n_params * 4:
            raise DeviceError(
                "FAILED_PRECONDITION",
                f"weights buffer at {self.weights_addr:#x} has {raw.numel()} bytes; "
                f"model needs {self.model.n_params * 4}",
            )
        return _f32(raw)

    def run_forward(self, input_addr: int, output_addr: int) -> int:
        """Forward on this device: f32 batch at ``input_addr`` → logits
        written to ``output_addr``. Returns the output's byte count."""
        self.bind_thread()
        raw = self.memory.get_logical_array(input_addr)
        in_features = self.model.sizes[0]
        if raw.numel() % (4 * in_features) != 0:
            raise DeviceError(
                "INVALID_ARGUMENT",
                f"input buffer ({raw.numel()} B) is not a multiple of a {in_features}-feature f32 row",
            )
        x = _f32(raw).view(-1, in_features)
        logits = self.model.forward_flat(self._flat_params(), x)
        out_u8 = logits.contiguous().view(torch.uint8).reshape(-1)
        self.memory.put_array(output_addr, out_u8)
        self._last_input = x
        return int(out_u8.numel())

    def run_backward(self, gradient_addr: int) -> None:
        """Backward: reads dL/dlogits (f32 [batch, n_out]) at
        ``gradient_addr``, backprops through the last ``run_forward`` batch
        and overwrites ``gradient_addr`` with the flat parameter gradient."""
        self.bind_thread()
        if self._last_input is None:
            raise DeviceError("FAILED_PRECONDITION", "run_forward must precede run_backward")
        raw = self.memory.get_logical_array(gradient_addr)
        n_out = self.model.sizes[-1]
        expected = self._last_input.shape[0] * n_out * 4
        if raw.numel() != expected:
            raise DeviceError(
                "INVALID_ARGUMENT",
                f"gradient buffer has {raw.numel()} bytes; expected {expected} "
                f"(batch {self._last_input.shape[0]} × {n_out} f32)",
            )
        dlogits = _f32(raw).view(-1, n_out)
        grads = self.model.backward_flat(self._flat_params(), self._last_input, dlogits)
        self.memory.put_array(gradient_addr, grads.contiguous().view(torch.uint8).reshape(-1))


# ---------------------------------------------------------------------------
# gRPC servicer + process bootstrap
# ---------------------------------------------------------------------------


def abort(context, err: DeviceError):
    """Abort the RPC with ``err``'s status code (by name)."""
    import grpc

    context.abort(grpc.StatusCode[err.code], str(err))


class DeviceServicer:
    """Wire adapter: DeviceRuntime ⇄ gpu_sim.GPUDevice."""

    def __init__(self, runtime: DeviceRuntime):
        self.rt = runtime

    def GetDeviceMetadata(self, request, context):  # noqa: N802 (RPC names)
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        return pb.GetDeviceMetadataResponse(metadata=self.rt.metadata())

    def BeginSend(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        try:
            sid = self.rt.begin_send(request.sendBuffAddr.value, request.numBytes,
                                     request.dstRank.value)
        except DeviceError as e:
            abort(context, e)
        return pb.BeginSendResponse(initiated=True, streamId=pb.StreamId(value=sid))

    def BeginReceive(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        try:
            self.rt.begin_receive(request.streamId.value, request.recvBuffAddr.value,
                                  request.numBytes, request.srcRank.value)
        except DeviceError as e:
            abort(context, e)
        return pb.BeginReceiveResponse(initiated=True)

    def StreamSend(self, request_iterator, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        self.rt.bind_thread()
        return pb.StreamSendResponse(success=self.rt.receive_chunks(request_iterator))

    def GetStreamStatus(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        try:
            status = self.rt.stream_status(request.streamId.value)
        except DeviceError as e:
            abort(context, e)
        return pb.GetStreamStatusResponse(status=status)

    def Memcpy(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        # device-side spans: in the stitched cluster timeline this lane
        # shows what the device did inside the coordinator's wire_op span
        self.rt.bind_thread()
        try:
            if request.HasField("hostToDevice"):
                h2d = request.hostToDevice
                with span("device_memcpy", direction="h2d", device=self.rt.device_id):
                    self.rt.memcpy_h2d(h2d.dstMemAddr.value, h2d.hostSrcData)
                return pb.MemcpyResponse(hostToDevice=pb.MemcpyHostToDeviceResponse(success=True))
            d2h = request.deviceToHost
            with span("device_memcpy", direction="d2h", device=self.rt.device_id):
                data = self.rt.memcpy_d2h(d2h.srcMemAddr.value, d2h.numBytes or None)
            return pb.MemcpyResponse(deviceToHost=pb.MemcpyDeviceToHostResponse(dstData=data))
        except DeviceError as e:
            abort(context, e)

    def ConfigurePeers(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        self.rt.configure_peers(dict(request.peerAddresses), request.selfRank)
        return pb.ConfigurePeersResponse(success=True)

    def RunForward(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        self.rt.bind_thread()
        try:
            with span("device_forward", device=self.rt.device_id):
                n = self.rt.run_forward(request.inputAddr.value, request.outputAddr.value)
        except DeviceError as e:
            abort(context, e)
        return pb.RunForwardResponse(success=True, outputBytes=n)

    def RunBackward(self, request, context):  # noqa: N802
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        self.rt.bind_thread()
        try:
            with span("device_backward", device=self.rt.device_id):
                self.rt.run_backward(request.gradientAddr.value)
        except DeviceError as e:
            abort(context, e)
        return pb.RunBackwardResponse(success=True)


@dataclass
class DeviceServerHandle:
    runtime: DeviceRuntime
    server: object  # grpc.Server
    address: str

    def stop(self, grace: float = 0.2) -> None:
        self.server.stop(grace)


def serve_device(
    device_id: int,
    port: int = 0,
    mem_size: int = 0x3000,
    device: str | torch.device | None = None,
    host: str = "127.0.0.1",
    model: MLP | None = None,
) -> DeviceServerHandle:
    """Boot one GPUDevice server on ``device`` (the card by default;
    ephemeral port when ``port=0``), with the obs plane and the
    shard-migration plane on the same port."""
    from concurrent import futures

    import grpc

    from dsml_tpu_torch.comm import rpc
    from dsml_tpu_torch.comm.migration import MigrationServicer, StateDonor
    from dsml_tpu_torch.obs.cluster import ObsServicer, current_role

    runtime = DeviceRuntime(device_id, mem_size=mem_size, device=device, model=model)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
    rpc.add_device_servicer(DeviceServicer(runtime), server)
    rpc.add_obs_servicer(ObsServicer(current_role("device_server")), server)
    # this host serves pieces of whatever state its StateDonor registers
    runtime.donor = StateDonor(runtime)
    rpc.add_migration_servicer(MigrationServicer(runtime.donor), server)
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    runtime.bound_address = f"{host}:{bound}"
    return DeviceServerHandle(runtime, server, runtime.bound_address)


def serve_local_devices(
    n: int,
    base_device_id: int = 1,
    mem_size: int = 0x3000,
    ports: list[int] | None = None,
    model: MLP | None = None,
    device: str | torch.device | None = None,
) -> list[DeviceServerHandle]:
    """Boot ``n`` device servers in this process. With ``device`` unset
    they go round-robin over the cards (``cuda:i % device_count``; on one
    card all share ``cuda:0``); ``device="cpu"`` puts them all there."""
    if device is None:
        resolve_device(None)  # raises without a card
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(device)]
    return [
        serve_device(base_device_id + i, port=(ports[i] if ports else 0), mem_size=mem_size,
                     device=devs[i % len(devs)], model=model)
        for i in range(n)
    ]
