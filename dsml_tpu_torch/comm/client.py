"""L4 — the training client of the gpu_sim wire API; the port's copy of
``dsml_tpu/comm/client.py``.

The counterpart of the reference's Go client helpers
(``DSML/client/client.go``): connect to the coordinator and the devices,
CommInit, float32↔bytes codecs, weight and gradient shipping and the
AllReduceRing call, plus the on-device compute path
(RunForward/RunBackward). It speaks only the wire, so it drives the JAX
package's servers and the port's alike.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass

import grpc
import numpy as np

from dsml_tpu_torch.comm import rpc
from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

GRAD_ADDR = 0x1000  # conventional addresses, as in client.go:29-30
WEIGHTS_ADDR = 0x2000

# transient control-plane failures worth retrying: the server is restarting
# / the channel flaked (UNAVAILABLE) or one probe window was missed
# (DEADLINE_EXCEEDED). Everything else — NOT_FOUND, INVALID_ARGUMENT,
# FAILED_PRECONDITION — is a REAL answer and retrying it only hides bugs.
TRANSIENT_CODES = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
)


def _rpc_code(e: grpc.RpcError):
    code = getattr(e, "code", None)
    return code() if callable(code) else None


def call_with_retries(op: str, fn, retries: int | None = None,
                      base_s: float = 0.05, cap_s: float = 2.0,
                      rng=random.random, sleep=time.sleep):
    """Run ``fn()`` with bounded exponential backoff + jitter on transient
    gRPC codes (:data:`TRANSIENT_CODES`); anything else raises immediately.

    The RPCs this wraps — control plane (CommInit / GetCommStatus /
    membership refresh) AND the data-plane arm ops (BeginSend /
    BeginReceive / GetStreamStatus, plus the migration plane's
    PlanPieces / BeginMigration) — are exactly the calls a preemption
    storm flakes:
    failing a whole training job on one UNAVAILABLE while the coordinator
    restarts is the reference's brittleness, not a contract. Retries are
    BOUNDED (default 4, ``DSML_COMM_RETRIES``) and jittered (0.5–1.5× the
    exponential delay) so a thundering herd of recovering clients doesn't
    re-flatten the coordinator it is waiting for. Every retry counts into
    ``comm_retry_total{op}``."""
    if retries is None:
        try:
            retries = int(os.environ.get("DSML_COMM_RETRIES", 4))
        except ValueError:
            retries = 4
    attempt = 0
    while True:
        try:
            return fn()
        except grpc.RpcError as e:
            if _rpc_code(e) not in TRANSIENT_CODES or attempt >= retries:
                raise
            from dsml_tpu_torch.obs import get_registry

            get_registry().counter(
                "comm_retry_total",
                "transient control-plane RPC retries", labels=("op",),
            ).inc(op=op)
            delay = min(cap_s, base_s * (2 ** attempt)) * (0.5 + rng())
            sleep(delay)
            attempt += 1


def f32_to_bytes(x: np.ndarray) -> bytes:
    return np.ascontiguousarray(x, dtype=np.float32).tobytes()


def bytes_to_f32(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.float32).copy()


@dataclass
class PipelineClient:
    """Handle on one coordinator + its communicator's devices."""

    coordinator: rpc._Stub
    devices: list[rpc._Stub]
    comm_id: int
    device_ids: list[int]
    addresses: list[str] | None = None

    @classmethod
    def connect(
        cls, coordinator_addr: str, device_addrs: list[str], timeout: float = 5.0
    ) -> "PipelineClient":
        coord = rpc.coordinator_stub(grpc.insecure_channel(coordinator_addr))
        resp = call_with_retries(
            "CommInit",
            lambda: coord.CommInit(
                pb.CommInitRequest(
                    numDevices=len(device_addrs), device_addresses=device_addrs
                ),
                timeout=timeout,
            ),
        )
        devices = [rpc.device_stub(grpc.insecure_channel(a)) for a in device_addrs]
        return cls(
            coord, devices, resp.commId,
            [m.deviceId.value for m in resp.devices], list(device_addrs),
        )

    def refresh_membership(self, timeout: float = 5.0, expect_change: bool = False) -> int:
        """Re-resolve rank→device from the coordinator's CURRENT view.

        After elastic recovery renumbers survivors, the client's per-rank
        stubs/ids from CommInit are stale (the reference had no recovery at
        all, SURVEY.md §5.3). GetCommStatus's
        additive ``members`` extension carries (rank, deviceId, address);
        rebuild the stub table in rank order, reusing live channels by
        address (closing replaced ones). Returns the new communicator size.

        Polls past two windows: while the comm reports FAILED the old table
        may still be installed (recovery drains in-flight collectives before
        renumbering) — a comm still FAILED at the deadline raises rather
        than silently keeping stale ranks. And with ``expect_change=True``
        (use after a per-rank RPC error), also poll until the membership
        actually DIFFERS from the client's current table — the coordinator's
        health probe may simply not have noticed the failure yet."""
        # addresses may be unknown (directly-constructed client): fall back
        # to device-id comparison so expect_change still means something
        if self.addresses:
            current = list(zip(self.device_ids, self.addresses))
        else:
            current = list(self.device_ids)
        deadline = time.monotonic() + timeout
        while True:
            # retries=1 here: the surrounding poll loop IS the retry
            # mechanism, bounded by `deadline` — the full default budget
            # would let one wedged-coordinator iteration block ~5× the
            # caller's timeout before the outer deadline is even checked
            resp = call_with_retries(
                "GetCommStatus",
                lambda: self.coordinator.GetCommStatus(
                    pb.GetCommStatusRequest(commId=self.comm_id), timeout=timeout
                ),
                retries=1,
            )
            ordered = sorted(resp.members, key=lambda m: m.rank)
            if self.addresses:
                fresh = [(m.deviceId.value, m.address) for m in ordered]
            else:
                fresh = [m.deviceId.value for m in ordered]
            if resp.status != pb.FAILED and not (expect_change and fresh == current):
                break
            if time.monotonic() >= deadline:
                if resp.status == pb.FAILED:
                    raise RuntimeError(
                        f"communicator {self.comm_id} still FAILED after {timeout}s; "
                        "membership not refreshed (re-CommInit required)"
                    )
                raise RuntimeError(
                    f"communicator {self.comm_id} membership unchanged after {timeout}s; "
                    "the coordinator has not (yet) observed the expected failure"
                )
            time.sleep(0.05)
        by_addr = dict(zip(self.addresses or [], self.devices))
        new_devices = [
            by_addr.get(m.address) or rpc.device_stub(grpc.insecure_channel(m.address))
            for m in ordered
        ]
        # channel hygiene (mirrors the coordinator's): close every old stub
        # that was NOT carried over — including the addresses-unknown case,
        # where nothing can be matched and ALL old channels are replaced
        reused = {id(s) for s in new_devices}
        for stub in self.devices:
            if id(stub) not in reused:
                channel = getattr(stub, "_channel", None)
                if channel is not None:
                    channel.close()
        self.devices = new_devices
        self.device_ids = [m.deviceId.value for m in ordered]
        self.addresses = [m.address for m in ordered]
        return len(ordered)

    # ---- per-device data movement ---------------------------------------------

    def write(self, rank: int, addr: int, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = f32_to_bytes(data)
        self.devices[rank].Memcpy(
            pb.MemcpyRequest(
                hostToDevice=pb.MemcpyHostToDeviceRequest(
                    hostSrcData=data,
                    dstDeviceId=pb.DeviceId(value=self.device_ids[rank]),
                    dstMemAddr=pb.MemAddr(value=addr),
                )
            )
        )

    def read(self, rank: int, addr: int, num_bytes: int) -> bytes:
        resp = self.devices[rank].Memcpy(
            pb.MemcpyRequest(
                deviceToHost=pb.MemcpyDeviceToHostRequest(
                    srcDeviceId=pb.DeviceId(value=self.device_ids[rank]),
                    srcMemAddr=pb.MemAddr(value=addr),
                    numBytes=num_bytes,
                )
            )
        )
        return resp.deviceToHost.dstData

    def broadcast_weights(self, weights: np.ndarray, addr: int = WEIGHTS_ADDR) -> None:
        """Ship one weight vector to every device (client.go:642-644)."""
        data = f32_to_bytes(weights)
        for rank in range(len(self.devices)):
            self.write(rank, addr, data)

    # ---- collectives -----------------------------------------------------------

    def all_reduce_ring(
        self,
        num_bytes: int,
        op: int = pb.SUM,
        mem_addrs: dict[int, int] | None = None,
        dtype: str = "",
        timeout: float = 120.0,
    ) -> None:
        req = pb.AllReduceRingRequest(commId=self.comm_id, count=num_bytes, op=op, dtype=dtype)
        for rank, addr in (mem_addrs or {}).items():
            req.memAddrs[rank].value = addr
        self.coordinator.AllReduceRing(req, timeout=timeout)

    def naive_all_reduce(self, data_size: int, latency_ms: int = 0, timeout: float = 120.0):
        return self.coordinator.NaiveAllReduce(
            pb.NaiveAllReduceRequest(commId=self.comm_id, dataSize=data_size, latencyMs=latency_ms),
            timeout=timeout,
        )

    def all_reduce_gradients(
        self, per_rank_grads: list[np.ndarray], op: int = pb.SUM, addr: int = GRAD_ADDR
    ) -> np.ndarray:
        """The training-loop step the reference faked (SURVEY.md §8.4): write
        each rank's gradient shard-sum, ring-reduce for real, read back the
        reduction."""
        n = len(self.devices)
        if n != len(per_rank_grads):
            raise ValueError(f"{len(per_rank_grads)} gradient arrays for {n} devices")
        nbytes = None
        for rank, g in enumerate(per_rank_grads):
            data = f32_to_bytes(g)
            nbytes = len(data) if nbytes is None else nbytes
            if len(data) != nbytes:
                raise ValueError("all ranks must contribute equal-size gradients")
            self.write(rank, addr, data)
        self.all_reduce_ring(nbytes, op=op, mem_addrs={r: addr for r in range(n)})
        return bytes_to_f32(self.read(0, addr, nbytes))

    # ---- P2P streams (data-plane arm RPCs, retried like control-plane) ----------

    def begin_send(self, rank: int, send_addr: int, num_bytes: int,
                   dst_rank: int, timeout: float = 5.0) -> int:
        """Arm a P2P send on ``rank``; returns the stream id. The arm RPCs
        are the data plane's CONTROL half — a transient flake here used to
        fail the whole transfer while CommInit-class ops retried; now all
        three (BeginSend / BeginReceive / GetStreamStatus) ride
        :func:`call_with_retries` with the same bounded jittered backoff."""
        resp = call_with_retries(
            "BeginSend",
            lambda: self.devices[rank].BeginSend(
                pb.BeginSendRequest(
                    sendBuffAddr=pb.MemAddr(value=send_addr),
                    numBytes=num_bytes,
                    dstRank=pb.Rank(value=dst_rank),
                ),
                timeout=timeout,
            ),
        )
        return resp.streamId.value

    def begin_receive(self, rank: int, stream_id: int, recv_addr: int,
                      num_bytes: int, src_rank: int, timeout: float = 5.0) -> None:
        call_with_retries(
            "BeginReceive",
            lambda: self.devices[rank].BeginReceive(
                pb.BeginReceiveRequest(
                    streamId=pb.StreamId(value=stream_id),
                    recvBuffAddr=pb.MemAddr(value=recv_addr),
                    numBytes=num_bytes,
                    srcRank=pb.Rank(value=src_rank),
                ),
                timeout=timeout,
            ),
        )

    def stream_status(self, rank: int, stream_id: int, timeout: float = 5.0) -> int:
        return call_with_retries(
            "GetStreamStatus",
            lambda: self.devices[rank].GetStreamStatus(
                pb.GetStreamStatusRequest(streamId=pb.StreamId(value=stream_id)),
                timeout=timeout,
            ),
        ).status

    # ---- on-device compute -----------------------------------------------------

    def run_forward(self, rank: int, input_addr: int, output_addr: int) -> int:
        resp = self.devices[rank].RunForward(
            pb.RunForwardRequest(
                deviceId=pb.DeviceId(value=self.device_ids[rank]),
                inputAddr=pb.MemAddr(value=input_addr),
                outputAddr=pb.MemAddr(value=output_addr),
            )
        )
        return resp.outputBytes

    def run_backward(self, rank: int, gradient_addr: int) -> None:
        self.devices[rank].RunBackward(
            pb.RunBackwardRequest(
                deviceId=pb.DeviceId(value=self.device_ids[rank]),
                gradientAddr=pb.MemAddr(value=gradient_addr),
            )
        )

    # ---- lifecycle --------------------------------------------------------------

    def status(self) -> int:
        return call_with_retries(
            "GetCommStatus",
            lambda: self.coordinator.GetCommStatus(
                pb.GetCommStatusRequest(commId=self.comm_id)
            ),
        ).status

    def destroy(self) -> None:
        self.coordinator.CommDestroy(pb.CommDestroyRequest(commId=self.comm_id))

    def finalize(self) -> None:
        self.coordinator.CommFinalize(pb.CommFinalizeRequest(commId=self.comm_id))
