"""L2 — the coordinator: communicator lifecycle and the collectives'
control plane; the port's counterpart of ``dsml_tpu/comm/coordinator.py``
(the reference's ``DSML/gpu_coordinator_service/gpu_coordinator_server.go``).

Status codes as the reference's: INTERNAL on a failed CommInit, NOT_FOUND
on an unknown commId, FAILED_PRECONDITION on a FAILED communicator, a
health loop (5 s, 2 s probes). The data plane is real:

- ``AllReduceRing`` reduces the devices' actual buffers, honouring ``op``,
  ``dtype`` and the per-rank ``memAddrs``. When every device is a server
  of this process on a device of its own, the reduction runs in process
  over the registry tensors (``ops.collectives.device_buffers_all_reduce``,
  the JAX ring's order) and is written back on the devices. When servers
  share a device (several on one card), or are remote, the coordinator
  fetches the bytes and reduces on the host: float32 through the native
  runtime's ``ds_reduce_f32`` — the JAX coordinator's path for the same
  layout.
- ``Memcpy`` forwards to the owning device; ``GroupStart``/``GroupEnd``
  queue and flush collectives; ``CommFinalize`` drains, then destroys.

:class:`CoordinatorRuntime` imports no grpc until it dials: its reduce
path is callable without it. The servicer maps a :class:`DeviceError`'s
code to ``grpc.StatusCode`` by name.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent import futures
from dataclasses import dataclass, field

import numpy as np
import torch

from dsml_tpu_torch.comm.device_server import (
    FAILED,
    IN_PROGRESS,
    SUCCESS,
    DeviceError,
    abort,
    local_device,
)
from dsml_tpu_torch.obs import (
    flight_recorder,
    get_registry,
    hangwatch,
    observe_collective_latency_ms,
    span,
)
from dsml_tpu_torch.ops.collectives import (
    ReduceOp,
    device_buffers_all_reduce,
    make_stacked_all_reduce,
)
from dsml_tpu_torch.utils.config import Config
from dsml_tpu_torch.utils.config import field as cfg_field
from dsml_tpu_torch.utils.logging import get_logger

log = get_logger("coordinator")

DEFAULT_BUFFER_ADDR = 0x1000  # the reference's conventional gradient address


@dataclasses.dataclass
class CoordinatorConfig(Config):
    health_interval_s: float = cfg_field(5.0, help="health-probe period (reference: 5s)")
    probe_timeout_s: float = cfg_field(2.0, help="per-device health probe timeout (reference: 2s)")
    dial_retries: int = cfg_field(3, help="CommInit dial attempts per device (reference: 3)")
    dial_backoff_s: float = cfg_field(0.5, help="sleep between dial attempts (reference: 500ms)")
    ring_algorithm: str = cfg_field("ring", help="AllReduceRing algorithm: ring|ring2|xla|naive|auto (ring2 = bidirectional full-duplex ring; auto = payload/axis-aware latency-vs-bandwidth selection)")
    elastic: bool = cfg_field(
        False,
        help="on device failure, re-rank the surviving devices and keep the "
        "communicator alive instead of failing it permanently (the reference "
        "marks it FAILED forever, SURVEY.md §5.3)",
    )
    straggler_multiplier: float = cfg_field(
        3.0,
        help="a device whose health-probe latency exceeds this multiple of "
        "the pass's median counts into the coordinator_stragglers gauge",
    )


def _remote_error(info: "DeviceInfo", e) -> DeviceError:
    """Surface a remote device's status code (of a ``grpc.RpcError``) as
    this RPC's own (a raw RpcError would reach the client as UNKNOWN)."""
    code = e.code() if callable(getattr(e, "code", None)) else "UNAVAILABLE"
    details = e.details() if callable(getattr(e, "details", None)) else e
    return DeviceError(code, f"device {info.device_id} ({info.address}): {details}")


@dataclass
class DeviceInfo:
    rank: int
    device_id: int
    address: str
    stub: object      # rpc._Stub of gpu_sim.GPUDevice
    channel: object   # grpc.Channel
    metadata: object  # gpu_sim.DeviceMetadata


@dataclass
class Communicator:
    comm_id: int
    devices: list[DeviceInfo]
    status: int = IN_PROGRESS
    group_active: bool = False
    queued: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    in_flight: int = 0


class CoordinatorRuntime:
    """Coordinator logic, directly callable by tests and the gRPC adapter."""

    def __init__(self, config: CoordinatorConfig | None = None):
        self.config = config or CoordinatorConfig()
        # build the native runtime now, not inside the first RPC handler
        from dsml_tpu_torch.runtime import native

        native.load()
        self.comms: dict[int, Communicator] = {}
        self._next_comm = 1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # failure listeners: the health loop's verdicts, pushed instead of
        # polled — the elastic controller subscribes here so a coordinator
        # death sentence becomes a DeviceLost signal, not a hung step
        self._failure_listeners: list = []
        # failure forensics: wire ops ride in the flight-recorder ring, and
        # with DSML_HANGWATCH set each collective arms a deadline at k× the
        # trailing-median op wall — a wedged (alive-but-stuck) device then
        # leaves a stack dump + bundle instead of a silently hung client
        self._recorder = flight_recorder.get_flight_recorder()
        hw_cfg = hangwatch.config_from_env()
        self._hangwatch = hangwatch.get_hangwatch() if hw_cfg is not None else None
        self._wire_deadline = (
            hangwatch.TrailingDeadline.from_config(
                hw_cfg, floor_s=max(2 * self.config.probe_timeout_s, 1.0)
            )
            if hw_cfg is not None else None
        )
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def add_failure_listener(self, fn) -> None:
        """Subscribe to health-probe death verdicts:
        ``fn(comm_id, failed_device_ids, alive_device_ids)`` fires from the
        health loop whenever a probe pass finds dead devices (before any
        elastic renumbering, so the ids are the pre-failure ones). Listener
        exceptions are logged, never allowed to wedge the health loop."""
        with self._lock:
            self._failure_listeners.append(fn)

    def failure_feed(self):
        """A LIVE feed for ``runtime.controller.ElasticController``'s
        ``failure_feed=`` hook: registers an internal listener and returns
        a zero-arg callable that drains the device ids the health loop has
        declared dead since the last call. The push verdict becomes the
        controller's poll — the glue that turns a coordinator death
        sentence into a ``DeviceLost`` signal instead of a hung step
        (closes the ROADMAP item: tests previously used injected feeds
        only)."""
        import collections

        pending: collections.deque = collections.deque()

        def on_failure(comm_id, failed_ids, alive_ids):
            pending.extend(failed_ids)  # deque.extend is thread-safe

        self.add_failure_listener(on_failure)

        def feed() -> list:
            out = []
            while True:
                try:
                    out.append(pending.popleft())
                except IndexError:
                    return out

        return feed

    # ---- communicator lifecycle -----------------------------------------------

    def comm_init(self, num_devices: int, addresses: list[str]) -> Communicator:
        """Dial + probe every device; all-or-nothing (reference
        gpu_coordinator_server.go:121-192). Also installs each device's peer
        table so P2P streams can route cross-device."""
        import grpc

        from dsml_tpu_torch.comm import rpc
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        if num_devices < 1 or len(addresses) != num_devices:
            raise DeviceError(
                "INVALID_ARGUMENT",
                f"numDevices={num_devices} but {len(addresses)} addresses given",
            )
        infos: list[DeviceInfo] = []
        try:
            for rank, addr in enumerate(addresses):
                channel = grpc.insecure_channel(addr)
                stub = rpc.device_stub(channel)
                meta = None
                last_err: Exception | None = None
                for attempt in range(self.config.dial_retries):
                    try:
                        meta = stub.GetDeviceMetadata(
                            pb.GetDeviceMetadataRequest(), timeout=self.config.probe_timeout_s
                        ).metadata
                        break
                    except grpc.RpcError as e:
                        last_err = e
                        if attempt + 1 < self.config.dial_retries:
                            time.sleep(self.config.dial_backoff_s)
                if meta is None:
                    raise DeviceError(
                        "INTERNAL", f"device {addr} unreachable: {last_err}"
                    )
                infos.append(DeviceInfo(rank, meta.deviceId.value, addr, stub, channel, meta))
        except DeviceError:
            for info in infos:
                info.channel.close()
            raise

        peer_map = {info.rank: info.address for info in infos}
        for info in infos:
            try:
                info.stub.ConfigurePeers(
                    pb.ConfigurePeersRequest(peerAddresses=peer_map, selfRank=info.rank),
                    timeout=self.config.probe_timeout_s,
                )
            except grpc.RpcError:
                # Extension RPC: a reference-proto peer won't know it; P2P
                # streams then only support loopback, collectives still work.
                log.info("device %s lacks ConfigurePeers (reference-proto peer?)", info.address)

        with self._lock:
            comm = Communicator(self._next_comm, infos)
            self._next_comm += 1
            self.comms[comm.comm_id] = comm
        log.info("CommInit: comm %d over %d devices", comm.comm_id, len(infos))
        return comm

    def _get_comm(self, comm_id: int) -> Communicator:
        with self._lock:
            comm = self.comms.get(comm_id)
        if comm is None:
            raise DeviceError("NOT_FOUND", f"unknown communicator {comm_id}")
        return comm

    def comm_members(self, comm_id: int) -> tuple[int, list[tuple[int, int, str]]]:
        """(status, [(rank, device_id, address)…]) — the CURRENT membership,
        which elastic recovery may have renumbered; clients re-resolve their
        rank→device maps from this instead of holding stale CommInit ranks."""
        comm = self._get_comm(comm_id)
        with comm.lock:
            return comm.status, [(i.rank, i.device_id, i.address) for i in comm.devices]

    def broker_migration(self, comm_id: int, local_device_id: int):
        """Membership-table routing for cross-host shard migration
        (``comm.migration.ShardMigrator``): resolve which member is the
        caller (``self_rank`` — where donors push their streams) and which
        are potential donors. Returns ``(self_rank, [(rank, address), …])``
        over the CURRENT membership, which elastic recovery may have
        renumbered — the same freshness contract as :meth:`comm_members`."""
        _, members = self.comm_members(comm_id)
        self_rank, donors = None, []
        for rank, device_id, address in members:
            if device_id == local_device_id:
                self_rank = rank
            else:
                donors.append((rank, address))
        if self_rank is None:
            raise DeviceError(
                "NOT_FOUND",
                f"device {local_device_id} is not a member of comm {comm_id}",
            )
        return self_rank, donors

    def comm_destroy(self, comm_id: int) -> None:
        comm = self._get_comm(comm_id)
        with self._lock:
            self.comms.pop(comm_id, None)
        for info in comm.devices:
            info.channel.close()
        log.info("CommDestroy: comm %d", comm_id)

    def comm_finalize(self, comm_id: int, drain_timeout_s: float = 30.0) -> None:
        """Drain queued/in-flight collectives, then destroy."""
        comm = self._get_comm(comm_id)
        with comm.lock:
            if comm.queued:
                self._flush_group_locked(comm)
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            with comm.lock:
                if comm.in_flight == 0:
                    break
            time.sleep(0.01)
        self.comm_destroy(comm_id)

    # ---- group semantics --------------------------------------------------------

    def group_start(self, comm_id: int) -> None:
        comm = self._get_comm(comm_id)
        with comm.lock:
            comm.group_active = True

    def group_end(self, comm_id: int) -> bool:
        comm = self._get_comm(comm_id)
        with comm.lock:
            comm.group_active = False
            return self._flush_group_locked(comm)

    def _flush_group_locked(self, comm: Communicator) -> bool:
        ok = True
        queued, comm.queued = comm.queued, []
        for fn in queued:
            try:
                fn()
            except DeviceError as e:
                log.warning("queued collective failed: %s", e)
                ok = False
        return ok

    # ---- memcpy (forwards to the owning device) ---------------------------------

    def memcpy_h2d(self, device_id: int, addr: int, data: bytes) -> None:
        self._store_bytes(self._find_device(device_id), addr, data)

    def memcpy_d2h(self, device_id: int, addr: int, num_bytes: int) -> bytes:
        return self._fetch_bytes(self._find_device(device_id), addr, num_bytes)

    def _find_device(self, device_id: int) -> DeviceInfo:
        with self._lock:
            for comm in self.comms.values():
                for info in comm.devices:
                    if info.device_id == device_id:
                        return info
        raise DeviceError("NOT_FOUND", f"no known device with id {device_id}")

    # ---- collectives -------------------------------------------------------------

    def all_reduce_ring(
        self,
        comm_id: int,
        count: int,
        op: int = ReduceOp.SUM,
        mem_addrs: dict[int, int] | None = None,
        dtype: str = "",
    ) -> None:
        comm = self._get_comm(comm_id)
        if comm.status == FAILED:
            raise DeviceError(
                "FAILED_PRECONDITION", f"communicator {comm_id} is FAILED"
            )

        def run():
            self._execute_all_reduce(comm, count, op, mem_addrs or {}, dtype or "float32")

        with comm.lock:
            if comm.group_active:
                comm.queued.append(run)
                return
            comm.in_flight += 1
        hw_token = None
        if self._hangwatch is not None:
            deadline_s = self._wire_deadline.timeout_s()
            if deadline_s is not None:
                hw_token = self._hangwatch.arm(
                    "wire_op", deadline_s, comm=comm_id, count=count,
                    algorithm=self.config.ring_algorithm,
                )
        t0 = time.perf_counter()
        try:
            # wire_op span: the coordinator lane of the STITCHED cluster
            # timeline — device-side device_memcpy/device_forward spans from
            # the device servers' own processes land inside this interval
            # once clock offsets are aligned (obs.cluster.stitch_traces)
            with span("wire_op", comm=comm_id, count=count,
                      algorithm=self.config.ring_algorithm):
                run()
            wall_s = time.perf_counter() - t0
            # per-op latency, labeled by the algorithm that actually ran —
            # the accounting surface the reference reported as totalTimeMs
            observe_collective_latency_ms(
                self.config.ring_algorithm, wall_s * 1e3,
                payload_bytes=count, axis="wire",
            )
            self._recorder.record(
                "wire_op", comm=comm_id, count=count,
                algorithm=self.config.ring_algorithm,
                ms=round(wall_s * 1e3, 3),
            )
        finally:
            if self._hangwatch is not None:
                if hw_token is not None:
                    self._hangwatch.disarm(hw_token)
                self._wire_deadline.observe(time.perf_counter() - t0)
            with comm.lock:
                comm.in_flight -= 1

    def _execute_all_reduce(
        self, comm: Communicator, count: int, op: int, mem_addrs: dict[int, int], dtype: str
    ) -> None:
        n = len(comm.devices)
        if n < 2:
            comm.status = SUCCESS  # nothing to reduce (reference :289-295)
            return
        np_dtype = np.dtype(dtype)
        if count % np_dtype.itemsize:
            raise DeviceError(
                "INVALID_ARGUMENT",
                f"count={count} bytes is not a multiple of {dtype} itemsize",
            )
        addrs = {info.rank: mem_addrs.get(info.rank, DEFAULT_BUFFER_ADDR) for info in comm.devices}
        try:
            if self._all_reduce_zero_copy(comm, addrs, count, ReduceOp(op), np_dtype):
                comm.status = SUCCESS
                return
            rows = []
            for info in comm.devices:
                raw = self._fetch_bytes(info, addrs[info.rank], count)
                rows.append(np.frombuffer(raw, dtype=np_dtype))
            stacked = np.stack(rows)
            reduced = self._reduce_stack(comm, stacked, ReduceOp(op))
            for info in comm.devices:
                self._store_bytes(info, addrs[info.rank], np.asarray(reduced[info.rank]).tobytes())
            comm.status = SUCCESS
        except DeviceError:
            comm.status = FAILED  # reference fails the comm on any step error (:340-345)
            raise
        except Exception as e:  # noqa: BLE001
            comm.status = FAILED
            raise DeviceError("INTERNAL", f"all-reduce failed: {e}") from e

    def _all_reduce_zero_copy(
        self, comm: Communicator, addrs: dict[int, int], count: int, op: ReduceOp, np_dtype
    ) -> bool:
        """The device-resident collective: when every communicator device
        is a server of this process on a device of its own, reduce the
        registry tensors in process and write the results back on the
        devices, with no host copy. Returns False when that does not hold
        and the host path must run. Missing or short buffers raise what
        the host path would (NOT_FOUND / OUT_OF_RANGE)."""
        if count == 0:
            return False  # the host path's "0 = whole buffer" convention applies
        devices = self._comm_devices(comm)
        if devices is None:
            return False
        rts = []
        for info in comm.devices:
            rt = self._local_rt(info)
            if rt is None:
                return False
            rts.append(rt)
        buffers = []
        for info, rt in zip(comm.devices, rts):
            addr = addrs[info.rank]
            arr = rt.memory.get_array(addr)  # NOT_FOUND, as the host path
            if count > arr.numel():
                raise DeviceError(
                    "OUT_OF_RANGE",
                    f"requested {count} bytes from {arr.numel()}-byte buffer at {addr:#x}",
                )
            buffers.append(arr[:count])
        reduced = device_buffers_all_reduce(buffers, op, self.config.ring_algorithm, str(np_dtype))
        for info, rt, red in zip(comm.devices, rts, reduced):
            addr = addrs[info.rank]
            old = rt.memory.get_array(addr)
            if old.numel() > count:
                # splice the reduced prefix, keep the tail, on the device
                red = torch.cat([red, old[count:]])
            rt.memory.put_array(addr, red, logical_nbytes=count)
        return True

    def _reduce_stack(self, comm: Communicator, stacked: np.ndarray, op: ReduceOp) -> np.ndarray:
        """Reduce the fetched rows: over the communicator's devices when
        they are distinct local ones, else on this host — float32 through
        the native ``ds_reduce_f32``, other types in numpy."""
        devices = self._comm_devices(comm)
        if devices is not None:
            return make_stacked_all_reduce(devices, op, self.config.ring_algorithm)(
                torch.from_numpy(stacked.copy())).numpy()
        if stacked.dtype == np.float32:
            from dsml_tpu_torch.runtime import native

            reduced = native.reduce_f32(stacked.reshape(stacked.shape[0], -1), int(op))
            return np.broadcast_to(reduced.reshape(stacked.shape[1:]), stacked.shape)
        combine = {
            ReduceOp.SUM: np.add.reduce,
            ReduceOp.AVG: lambda a: np.add.reduce(a) / a.shape[0],
            ReduceOp.PROD: np.multiply.reduce,
            ReduceOp.MIN: np.minimum.reduce,
            ReduceOp.MAX: np.maximum.reduce,
        }[op]
        reduced = combine(stacked.astype(np.float64) if stacked.dtype.kind in "iu" else stacked)
        reduced = reduced.astype(stacked.dtype)
        return np.broadcast_to(reduced, stacked.shape)

    def _comm_devices(self, comm: Communicator) -> list | None:
        """The torch devices of the communicator's servers when all are in
        this process on distinct devices; None when servers share a device
        (several on one card: there is no ring of devices to run)."""
        devs = []
        for info in comm.devices:
            rt = local_device(info.device_id)
            if rt is None:
                return None
            devs.append(rt.device)
        if len({str(d) for d in devs}) != len(devs):
            return None
        return devs

    def _local_rt(self, info: DeviceInfo):
        """In-process shortcut, only when the registered runtime really is the
        one serving info.address (a remote device with a colliding id must
        not be shadowed by a local chip)."""
        rt = local_device(info.device_id)
        if rt is not None and rt.bound_address == info.address:
            return rt
        return None

    def _fetch_bytes(self, info: DeviceInfo, addr: int, count: int) -> bytes:
        rt = self._local_rt(info)
        if rt is not None:
            return rt.read_bytes(addr, count or None)
        import grpc

        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        try:
            resp = info.stub.Memcpy(
                pb.MemcpyRequest(
                    deviceToHost=pb.MemcpyDeviceToHostRequest(
                        srcDeviceId=pb.DeviceId(value=info.device_id),
                        srcMemAddr=pb.MemAddr(value=addr),
                        numBytes=count,
                    )
                )
            )
        except grpc.RpcError as e:
            raise _remote_error(info, e) from e
        return resp.deviceToHost.dstData

    def _store_bytes(self, info: DeviceInfo, addr: int, data: bytes) -> None:
        rt = self._local_rt(info)
        if rt is not None:
            rt.memcpy_h2d(addr, data)
            return
        import grpc

        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        try:
            info.stub.Memcpy(
                pb.MemcpyRequest(
                    hostToDevice=pb.MemcpyHostToDeviceRequest(
                        hostSrcData=data,
                        dstDeviceId=pb.DeviceId(value=info.device_id),
                        dstMemAddr=pb.MemAddr(value=addr),
                    )
                )
            )
        except grpc.RpcError as e:
            raise _remote_error(info, e) from e

    def naive_all_reduce(self, comm_id: int, data_size: int, latency_ms: int) -> tuple[int, int]:
        """Gather→reduce→broadcast through the coordinator host, with the
        reference's simulated per-op latency and metrics
        (gpu_coordinator_server.go:611-717). Devices with no buffer at
        0x1000 are seeded with all-ones (the reference always re-seeded;
        here real data is respected). Returns (totalTimeMs, totalBytes)."""
        comm = self._get_comm(comm_id)
        if comm.status == FAILED:
            raise DeviceError("FAILED_PRECONDITION", f"communicator {comm_id} is FAILED")
        latency = latency_ms / 1000.0
        # init phase (excluded from timing, reference :634-656): any device
        # without a full dataSize buffer at 0x1000 is seeded with all-ones,
        # the reference's demo pattern (:634-656)
        for info in comm.devices:
            time.sleep(latency)
            try:
                self._fetch_bytes(info, DEFAULT_BUFFER_ADDR, data_size)
            except DeviceError as e:
                if e.code in ("NOT_FOUND", "OUT_OF_RANGE"):
                    self._store_bytes(info, DEFAULT_BUFFER_ADDR, b"\x01" * data_size)
                else:
                    raise
        start = time.monotonic()
        rows = []
        for info in comm.devices:
            time.sleep(latency)
            rows.append(np.frombuffer(self._fetch_bytes(info, DEFAULT_BUFFER_ADDR, data_size), np.uint8))
        # dtype-aware reduce (f32 when the size allows, else wide-int bytes —
        # never the reference's wrapping uint8 add, SURVEY.md §8.2)
        stacked = np.stack(rows)
        if data_size % 4 == 0:
            reduced = stacked.view(np.float32).sum(axis=0).tobytes()
        else:
            reduced = stacked.astype(np.uint16).sum(axis=0).clip(0, 255).astype(np.uint8).tobytes()
        for info in comm.devices:
            time.sleep(latency)
            self._store_bytes(info, 0x2000, reduced)
        total_ms = int((time.monotonic() - start) * 1000)
        total_bytes = 2 * len(comm.devices) * data_size
        comm.status = SUCCESS
        observe_collective_latency_ms(
            "naive", float(total_ms), payload_bytes=total_bytes, axis="wire"
        )
        log.info("NaiveAllReduce: %d ms, %d bytes", total_ms, total_bytes)
        return total_ms, total_bytes

    # ---- health loop (reference :69-119) -----------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            with self._lock:
                comms = list(self.comms.values())
            for comm in comms:
                self._check_comm_health(comm)

    def _check_comm_health(self, comm: Communicator) -> None:
        import grpc

        from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

        alive, failed = [], []
        probe_ms: dict[int, float] = {}  # device_id -> probe latency
        for info in comm.devices:
            t0 = time.perf_counter()
            try:
                info.stub.GetDeviceMetadata(
                    pb.GetDeviceMetadataRequest(), timeout=self.config.probe_timeout_s
                )
                probe_ms[info.device_id] = (time.perf_counter() - t0) * 1e3
                alive.append(info)
            except grpc.RpcError:
                failed.append(info)
        # per-probe outcome counts (matching the reference's health loop,
        # now queryable instead of log-only)
        reg = get_registry()
        probes = reg.counter(
            "coordinator_health_probes_total", "device health-probe outcomes",
            labels=("outcome",),
        )
        probes.inc(len(alive), outcome="alive")
        if failed:
            probes.inc(len(failed), outcome="failed")
        # per-device probe latency + straggler derivation: the loop used to
        # discard timing and only count alive/failed — but at pod scale the
        # run-killers are devices that answer SLOWLY, not just dead ones
        stragglers = 0
        if probe_ms:
            lat_hist = reg.histogram(
                "coordinator_probe_ms", "per-device health-probe latency",
                labels=("device",),
            )
            for device_id, ms in probe_ms.items():
                lat_hist.observe(ms, device=device_id)
            lats = sorted(probe_ms.values())
            median = lats[len(lats) // 2]
            bar = self.config.straggler_multiplier * max(median, 1e-6)
            slow = {d: ms for d, ms in probe_ms.items() if ms > bar}
            stragglers = len(slow)
            if slow:
                log.warning(
                    "health: comm %d stragglers (> %.1f ms = %.1f× median): %s",
                    comm.comm_id, bar, self.config.straggler_multiplier,
                    {d: round(ms, 1) for d, ms in slow.items()},
                )
        # set UNCONDITIONALLY: an all-probes-failed pass must zero the gauge,
        # not leave the previous pass's count standing during the outage
        reg.gauge(
            "coordinator_stragglers",
            "devices whose probe latency exceeds k× the pass median",
        ).set(stragglers)
        self._recorder.record(
            "health_probe", comm=comm.comm_id, alive=len(alive),
            failed=len(failed), stragglers=stragglers,
            probe_ms={str(d): round(ms, 3) for d, ms in probe_ms.items()},
        )
        if failed:
            with self._lock:
                listeners = list(self._failure_listeners)
            for fn in listeners:
                try:
                    fn(comm.comm_id,
                       [i.device_id for i in failed],
                       [i.device_id for i in alive])
                except Exception as e:  # noqa: BLE001 — never wedge health
                    log.warning("failure listener raised: %r", e)
            if self.config.elastic and alive:
                # Elastic recovery: shrink the ring and keep going — the
                # Varuna/Bamboo/Oobleck capability the reference shelved as
                # literature (SURVEY.md §5.3). Survivors keep their relative
                # order and get dense new ranks as FRESH DeviceInfo objects.
                # Order matters: (1) fail the comm so no NEW collective
                # starts, (2) drain in-flight collectives (they run against
                # the OLD rank tables and must fail on the dead device, not
                # get misrouted to a renumbered survivor), (3) only then push
                # the new peer tables device-side and swap coordinator state.
                # Clients re-resolve their rank→device maps afterwards via
                # GetCommStatus's members extension
                # (PipelineClient.refresh_membership).
                with comm.lock:
                    comm.status = FAILED
                deadline = time.monotonic() + self.config.probe_timeout_s
                while time.monotonic() < deadline:
                    with comm.lock:
                        if comm.in_flight == 0:
                            break
                    time.sleep(0.01)
                survivors = [
                    dataclasses.replace(info, rank=new_rank)
                    for new_rank, info in enumerate(alive)
                ]
                peer_map = {info.rank: info.address for info in survivors}
                for info in survivors:
                    try:
                        info.stub.ConfigurePeers(
                            pb.ConfigurePeersRequest(peerAddresses=peer_map, selfRank=info.rank),
                            timeout=self.config.probe_timeout_s,
                        )
                    except grpc.RpcError as e:
                        log.warning(
                            "health: comm %d survivor %s did not take the new peer "
                            "table (%s); its P2P routes may be stale until the next "
                            "recovery pass", comm.comm_id, info.address, e,
                        )
                with comm.lock:
                    comm.devices = survivors
                    comm.status = IN_PROGRESS  # recovered; accept collectives again
                log.warning(
                    "health: comm %d lost %d device(s); recovered with %d survivors",
                    comm.comm_id, len(failed), len(alive),
                )
            else:
                with comm.lock:
                    comm.devices = alive  # prune (reference :114)
                    comm.status = FAILED
                for info in failed:
                    log.warning("health: device %d (%s) unreachable; comm %d FAILED",
                                info.device_id, info.address, comm.comm_id)
            for info in failed:
                info.channel.close()  # pruned entries would otherwise leak channels


# ---------------------------------------------------------------------------
# gRPC adapter + bootstrap
# ---------------------------------------------------------------------------


class CoordinatorServicer:
    """Wire adapter: CoordinatorRuntime ⇄ gpu_sim.GPUCoordinator."""

    def __init__(self, runtime: CoordinatorRuntime):
        from dsml_tpu_torch.comm.proto import gpu_sim_pb2

        self.rt = runtime
        self.pb = gpu_sim_pb2

    def CommInit(self, request, context):  # noqa: N802
        try:
            comm = self.rt.comm_init(request.numDevices, list(request.device_addresses))
        except DeviceError as e:
            abort(context, e)
        return self.pb.CommInitResponse(
            success=True, commId=comm.comm_id, devices=[i.metadata for i in comm.devices]
        )

    def GetCommStatus(self, request, context):  # noqa: N802
        try:
            status, members = self.rt.comm_members(request.commId)
        except DeviceError as e:
            abort(context, e)
        return self.pb.GetCommStatusResponse(
            status=status,
            members=[
                self.pb.CommMember(rank=r, deviceId=self.pb.DeviceId(value=d), address=a)
                for r, d, a in members
            ],
        )

    def CommDestroy(self, request, context):  # noqa: N802
        try:
            self.rt.comm_destroy(request.commId)
        except DeviceError as e:
            abort(context, e)
        return self.pb.CommDestroyResponse(success=True)

    def CommFinalize(self, request, context):  # noqa: N802
        try:
            self.rt.comm_finalize(request.commId)
        except DeviceError as e:
            abort(context, e)
        return self.pb.CommFinalizeResponse(success=True)

    def GroupStart(self, request, context):  # noqa: N802
        try:
            self.rt.group_start(request.commId)
        except DeviceError as e:
            abort(context, e)
        return self.pb.GroupStartResponse(success=True)

    def GroupEnd(self, request, context):  # noqa: N802
        try:
            ok = self.rt.group_end(request.commId)
        except DeviceError as e:
            abort(context, e)
        return self.pb.GroupEndResponse(success=ok)

    def AllReduceRing(self, request, context):  # noqa: N802
        try:
            self.rt.all_reduce_ring(
                request.commId,
                request.count,
                request.op,
                {rank: addr.value for rank, addr in request.memAddrs.items()},
                request.dtype,
            )
        except DeviceError as e:
            abort(context, e)
        return self.pb.AllReduceRingResponse(success=True)

    def NaiveAllReduce(self, request, context):  # noqa: N802
        try:
            total_ms, total_bytes = self.rt.naive_all_reduce(
                request.commId, request.dataSize, request.latencyMs
            )
        except DeviceError as e:
            abort(context, e)
        return self.pb.NaiveAllReduceResponse(
            success=True, totalTimeMs=total_ms, totalDataTransferred=total_bytes
        )

    def Memcpy(self, request, context):  # noqa: N802
        try:
            if request.HasField("hostToDevice"):
                h2d = request.hostToDevice
                self.rt.memcpy_h2d(h2d.dstDeviceId.value, h2d.dstMemAddr.value, h2d.hostSrcData)
                return self.pb.MemcpyResponse(hostToDevice=self.pb.MemcpyHostToDeviceResponse(success=True))
            d2h = request.deviceToHost
            data = self.rt.memcpy_d2h(d2h.srcDeviceId.value, d2h.srcMemAddr.value, d2h.numBytes)
            return self.pb.MemcpyResponse(deviceToHost=self.pb.MemcpyDeviceToHostResponse(dstData=data))
        except DeviceError as e:
            abort(context, e)


@dataclass
class CoordinatorHandle:
    runtime: CoordinatorRuntime
    server: object  # grpc.Server
    address: str

    def stop(self, grace: float = 0.2) -> None:
        self.runtime.stop()
        self.server.stop(grace)


def serve_coordinator(
    port: int = 0, config: CoordinatorConfig | None = None, host: str = "127.0.0.1"
) -> CoordinatorHandle:
    import grpc

    from dsml_tpu_torch.comm import rpc
    from dsml_tpu_torch.obs.cluster import ObsServicer, current_role

    runtime = CoordinatorRuntime(config)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
    rpc.add_coordinator_servicer(CoordinatorServicer(runtime), server)
    # cluster obs plane (same port): the aggregator pulls the coordinator's
    # registry/trace snapshot — wire-op latency, health probes, stragglers

    rpc.add_obs_servicer(ObsServicer(current_role("coordinator")), server)
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return CoordinatorHandle(runtime, server, f"{host}:{bound}")
