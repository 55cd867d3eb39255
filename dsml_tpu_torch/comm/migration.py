"""Cross-host state motion over the hardened P2P streams — the port's
counterpart of ``dsml_tpu/comm/migration.py``.

Built on the gpu_sim stream API (``BeginSend``/``BeginReceive``/
``StreamSend``, in ``comm/device_server.py``):

- **Donor side** — :class:`StateDonor` registers a host's live state
  (tensors or arrays keyed by path); on request it serializes the exact
  piece, stages the bytes in its device registry and ``BeginSend``s them
  to the requesting host. The response carries the stream id and the
  per-frame CRC32C checksums computed sender-side (the native
  ``ds_crc32c``).
- **Receiver side** — :class:`ShardMigrator` resolves donors from the
  coordinator's membership table (``from_comm``), arms ``BeginReceive``
  with bounded-backoff re-arm, polls ``GetStreamStatus`` under a deadline
  (``DSML_MIGRATE_TIMEOUT_S``), validates every CRC frame on arrival, and
  on a dropped stream harvests the delivered prefix
  (``DeviceRuntime.take_partial``) and re-requests the rest from a
  resumable offset.
- **Fallback contract** — when streams cannot deliver (donor dead,
  integrity failure after retries, deadline blown) :class:`MigrationError`
  is raised; corrupted bytes never land silently.

Only control messages (JSON over the ``dsml_migrate.ShardMigration``
extension service) ride the new RPCs; the payload moves over the gpu_sim
stream RPCs, under the same wire-fault plan (``runtime.chaos``). Pieces,
dtype names (numpy's: ``"float32"``, ``"bfloat16"``) and frames are the
JAX package's, so either package's migrator pulls from the other's donor.
A fetched piece comes back as a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import grpc
import numpy as np
import torch

from dsml_tpu_torch.comm import rpc
from dsml_tpu_torch.comm.client import call_with_retries
from dsml_tpu_torch.comm.device_server import (
    FAILED,
    IN_PROGRESS,
    SUCCESS,
    DeviceError,
    abort,
)
from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb
from dsml_tpu_torch.obs import flight_recorder, get_registry
from dsml_tpu_torch.utils.config import env_float as _env_float
from dsml_tpu_torch.utils.config import env_int as _env_int
from dsml_tpu_torch.utils.crc32c import MIGRATE_CHUNK, payload_chunk_crcs
from dsml_tpu_torch.utils.dtypes import DTYPE_NAMES, TORCH_DTYPES
from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "MIGRATE_CHUNK",
    "MigrationConfig",
    "MigrationError",
    "MigrationServicer",
    "ShardMigrator",
    "StateDonor",
    "tree_path_str",
]

log = get_logger("migration")

def _host_tensor(arr) -> torch.Tensor:
    """A tensor or numpy array as a contiguous CPU tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().contiguous().cpu()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtype_name(t: torch.Tensor) -> str:
    name = DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"a donor cannot serve dtype {t.dtype}")
    return name


def _torch_dtype(name: str) -> torch.dtype:
    dt = TORCH_DTYPES.get(str(name))
    if dt is None:
        raise MigrationError(f"dtype {name!r} is not one a migration carries")
    return dt


class MigrationError(RuntimeError):
    """P2P streams could not deliver a piece (donor dead, integrity
    failure, deadline blown). The caller's contract is the coordinated
    checkpoint fallback — never a silent zero-fill or partial landing."""


@dataclasses.dataclass
class MigrationConfig:
    """Receiver-side knobs (env defaults: ``DSML_MIGRATE_*``)."""

    timeout_s: float = 30.0      # per-piece stream deadline
    retries: int = 2             # whole-piece retries after the first attempt
    poll_interval_s: float = 0.01
    recv_addr: int = 0x1000      # landing address in the local registry

    @classmethod
    def from_env(cls) -> "MigrationConfig":
        return cls(
            timeout_s=_env_float("DSML_MIGRATE_TIMEOUT_S", cls.timeout_s),
            retries=_env_int("DSML_MIGRATE_RETRIES", cls.retries),
            poll_interval_s=_env_float(
                "DSML_MIGRATE_POLL_S", cls.poll_interval_s
            ),
            recv_addr=_env_int("DSML_MIGRATE_RECV_ADDR", cls.recv_addr),
        )


def tree_path_str(prefix: str, path) -> str:
    """Canonical key of a tree leaf, ``prefix/part/part/...``: dict keys and
    list indices stringify, so donor and receiver (of either package)
    derive identical keys from identical trees."""
    return "/".join([prefix, *(str(p) for p in path)])


def _leaves_with_path(tree, path=()):
    """(path, leaf) of nested dicts, lists and tuples, dict keys sorted
    (the JAX tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, (*path, i))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# donor side
# ---------------------------------------------------------------------------


class StateDonor:
    """Serves pieces of this host's live training state to migrating peers.

    ``register_state`` snapshots array leaves of a tree (host numpy — the
    donor's addressable view); each leaf is keyed by :func:`tree_path_str`
    so both hosts agree on names without any schema exchange. Piece
    requests slice the registered array, stage the bytes in the device
    registry, and ``BeginSend`` them toward the requester's rank (routing
    via the peer table the coordinator installed at CommInit)."""

    def __init__(self, runtime, stage_addr: int | None = None):
        self.runtime = runtime
        self._arrays: dict[str, torch.Tensor] = {}
        # per-key request trace identity (serving KV handoffs register
        # per-request transients): carried in plan/stream descriptors so
        # the cross-host pull stays attributable to ONE request's trace
        self._trace_ids: dict[str, str] = {}
        if stage_addr is None:
            # default to the UPPER half of the registry: the lower half is
            # where a ShardMigrator on this same host lands INCOMING pieces
            # (recv_addr default = min_addr) — a bidirectional shrink (both
            # hosts donate to each other) must not have arrivals overwrite
            # staged outgoing payloads
            mem = runtime.memory
            stage_addr = mem.min_addr + (mem.max_addr - mem.min_addr) // 2
        self._stage_base = stage_addr
        self._stage_next = self._stage_base
        # staged ranges whose background push may not have read them yet:
        # stream_id -> (addr, nbytes); pruned once the stream is terminal
        self._live_stages: dict[int, tuple[int, int]] = {}
        self._lock = threading.Lock()
        # snapshot version (e.g. the training step the registered state
        # belongs to): carried in every plan/stream descriptor so a
        # receiver expecting a specific step REFUSES a stale donor instead
        # of silently landing old bytes that pass their own CRCs
        self.version = None
        # memory-ledger source (docs/OBSERVABILITY.md § Memory ledger):
        # the staging spans whose background pushes are still reading
        # them — a wedged stream shows up as bytes that never release
        from dsml_tpu_torch.obs.memory import get_memory_ledger

        get_memory_ledger().register_source(
            "migration_staging", self.staged_bytes, name=f"donor/{id(self):x}"
        )

    def staged_bytes(self) -> float:
        """Bytes of staging spans still owned by in-flight (or reserved)
        sends — terminal streams are pruned before counting."""
        with self._lock:
            self._prune_stages_locked()
            return float(sum(span for _, span in self._live_stages.values()))

    # -- registration ------------------------------------------------------

    def register_array(self, key: str, arr,
                       trace_id: str | None = None) -> None:
        self._arrays[key] = _host_tensor(arr)
        if trace_id is not None:
            self._trace_ids[key] = str(trace_id)
        else:
            self._trace_ids.pop(key, None)

    def register_state(self, tree, prefix: str = "state",
                       version=None) -> int:
        """Register every tensor or array leaf of ``tree`` (nested dicts and
        lists) under ``prefix``; returns how many were registered. Device
        tensors are copied to the host once here. ``version`` stamps the
        snapshot (conventionally the training step) so receivers can pin
        the step they expect."""
        n = 0
        for path, leaf in _leaves_with_path(tree):
            if leaf is None or not hasattr(leaf, "shape"):
                continue
            self.register_array(tree_path_str(prefix, path), leaf)
            n += 1
        if version is not None:
            self.version = version
        return n

    def keys(self) -> list[str]:
        return sorted(self._arrays)

    def unregister(self, prefix: str) -> int:
        """Drop every registered array at ``prefix`` or under
        ``prefix/...``; returns how many were dropped. The serving KV
        handoff registers per-request transients
        (``serving.handoff.register_with_donor``) — without release, a
        long-lived prefill host would grow its donor table one request at
        a time. Elastic-migration state is re-registered per step and
        never needs this."""
        doomed = [k for k in self._arrays
                  if k == prefix or k.startswith(prefix + "/")]
        for k in doomed:
            del self._arrays[k]
            self._trace_ids.pop(k, None)
        return len(doomed)

    # -- piece serving -----------------------------------------------------

    def plan(self, keys: list[str]) -> dict:
        """Which of ``keys`` this donor holds → {key: {shape, dtype,
        version}}; missing keys map to None (the receiver's
        donor-selection input)."""
        out = {}
        for key in keys:
            arr = self._arrays.get(key)
            if arr is None:
                out[key] = None
                continue
            info = {"shape": list(arr.shape), "dtype": _dtype_name(arr),
                    "version": self.version}
            trace_id = self._trace_ids.get(key)
            if trace_id is not None:  # request-scoped keys only (handoffs)
                info["trace_id"] = trace_id
            out[key] = info
        return out

    def _note_staged_locked(self) -> None:
        get_registry().gauge(
            "migration_staging_bytes",
            "donor staging-area bytes held by in-flight P2P sends",
        ).set(float(sum(s for _, s in self._live_stages.values())))

    def _prune_stages_locked(self) -> None:
        for sid in list(self._live_stages):
            if not isinstance(sid, int):
                continue  # uncommitted reservation token: always live
            st = self.runtime.streams.get(sid)
            if st is None or st.status != IN_PROGRESS:
                del self._live_stages[sid]
        self._note_staged_locked()

    def _stage(self, nbytes: int) -> tuple[int, object]:
        """Sequential staging allocator over the registry's upper half,
        wrapping when the next payload would overrun. A wrap must never
        clobber a staged payload whose background push has not finished
        reading it — live ranges are tracked per stream and an allocation
        that would overlap one raises RESOURCE_EXHAUSTED (the receiver
        retries or falls back) instead of corrupting an in-flight send.
        The range is RESERVED under the allocation lock (returned token),
        then re-keyed to the stream id via :meth:`_commit_stage` — two
        concurrent BeginMigrations can otherwise both wrap onto the same
        base before either records its range."""
        span = max((nbytes + 15) & ~15, 16)
        token = object()
        with self._lock:
            self._prune_stages_locked()
            if self._stage_base + span > self.runtime.memory.max_addr:
                raise DeviceError(
                    "RESOURCE_EXHAUSTED",
                    f"piece of {nbytes} bytes exceeds the staging area "
                    f"({self.runtime.memory.max_addr - self._stage_base} bytes)",
                )
            if self._stage_next + span > self.runtime.memory.max_addr:
                self._stage_next = self._stage_base
            addr = self._stage_next
            for a, m in self._live_stages.values():
                if addr < a + m and a < addr + span:
                    raise DeviceError(
                        "RESOURCE_EXHAUSTED",
                        f"staging area exhausted by in-flight sends "
                        f"({len(self._live_stages)} live)",
                    )
            self._stage_next = addr + span
            self._live_stages[token] = (addr, span)
            self._note_staged_locked()
            return addr, token

    def _commit_stage(self, token: object, stream_id: int) -> None:
        with self._lock:
            self._live_stages[stream_id] = self._live_stages.pop(token)

    def _abort_stage(self, token: object) -> None:
        with self._lock:
            self._live_stages.pop(token, None)
            self._note_staged_locked()

    def begin_pieces(self, pieces: list[dict], dst_rank: int) -> list[dict]:
        """Serialize + BeginSend each requested piece; returns one stream
        descriptor per piece: stream id, sizes, and the CRC32C frame table
        the receiver validates against. ``offset`` resumes a dropped
        stream: only ``payload[offset:]`` is re-shipped, but the checksum
        table always describes the FULL payload."""
        out = []
        for req in pieces:
            key = req["key"]
            arr = self._arrays.get(key)
            if arr is None:
                raise KeyError(f"donor holds no array for {key!r}")
            idx = tuple(slice(int(s), int(e)) for s, e in req["piece"])
            sub = arr[idx].contiguous()
            payload = sub.reshape(-1).view(torch.uint8).numpy().tobytes()
            offset = int(req.get("offset", 0))
            if not 0 <= offset < max(len(payload), 1):
                raise ValueError(
                    f"resume offset {offset} outside payload of {len(payload)} bytes"
                )
            send = payload[offset:]
            addr, token = self._stage(len(send))
            try:
                self.runtime.memory.write(addr, send)
                stream_id = self.runtime.begin_send(addr, len(send), dst_rank)
            except BaseException:
                self._abort_stage(token)
                raise
            self._commit_stage(token, stream_id)
            out.append({
                "key": key,
                "stream_id": stream_id,
                "offset": offset,
                "nbytes": len(send),
                "total_nbytes": len(payload),
                # the frame table describes the FULL payload and the
                # receiver keeps the copy from the offset-0 response —
                # re-CRCing every byte per resume would tax exactly the
                # path that is already struggling
                "chunk_crcs": payload_chunk_crcs(payload) if offset == 0 else [],
                "dtype": _dtype_name(sub),
                "shape": list(sub.shape),
                "version": self.version,
                **({"trace_id": self._trace_ids[key]}
                   if key in self._trace_ids else {}),
            })
            log.info(
                "donor: piece %s %s -> rank %d (stream %d, %d B from offset %d)",
                key, req["piece"], dst_rank, stream_id, len(send), offset,
            )
        return out


class MigrationServicer:
    """Wire adapter: StateDonor ⇄ dsml_migrate.ShardMigration (raw JSON)."""

    def __init__(self, donor: StateDonor):
        self.donor = donor

    def PlanPieces(self, request, context):  # noqa: N802 (RPC names)
        req = json.loads(bytes(request).decode("utf-8"))
        return json.dumps({"pieces": self.donor.plan(req.get("keys", []))}).encode()

    def BeginMigration(self, request, context):  # noqa: N802
        req = json.loads(bytes(request).decode("utf-8"))
        try:
            streams = self.donor.begin_pieces(
                req.get("pieces", []), int(req["dst_rank"])
            )
        except KeyError as e:
            abort(context, DeviceError("NOT_FOUND", str(e)))
        except DeviceError as e:
            abort(context, e)
        except (ValueError, TypeError) as e:
            abort(context, DeviceError("INVALID_ARGUMENT", str(e)))
        return json.dumps({"streams": streams}).encode()


# ---------------------------------------------------------------------------
# receiver side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Donor:
    rank: int
    address: str
    channel: object
    stub: object        # dsml_migrate.ShardMigration
    dev_stub: object    # gpu_sim.GPUDevice on the same channel
    alive: bool = True


class ShardMigrator:
    """Pulls remote-only pieces into the local piecewise reassembly.

    ``donors`` is the membership-table view of the other hosts'
    device-server endpoints ([(rank, address)]); ``self_rank`` is the rank
    donors push streams to (this host's device server). Integrity and
    liveness hardening per piece:

    1. donor selection — first live donor whose ``PlanPieces`` lists the
       leaf (plans are cached per donor);
    2. ``BeginMigration`` / ``BeginReceive`` / ``GetStreamStatus`` all ride
       :func:`comm.client.call_with_retries` (transient UNAVAILABLE /
       DEADLINE_EXCEEDED flakes retried with jittered bounded backoff);
    3. every arrived payload is validated frame-by-frame against the
       donor's CRC32C table before a byte reaches the caller — a mismatch
       counts into ``comm_stream_integrity_failures_total`` and aborts the
       attempt;
    4. a dropped/stalled stream is harvested (``take_partial``) and the
       remainder re-requested from the delivered offset, under one
       per-piece deadline; exhausting retries raises
       :class:`MigrationError` (the checkpoint-fallback signal)."""

    def __init__(
        self,
        local_runtime,
        self_rank: int,
        donors: list[tuple[int, str]],
        config: MigrationConfig | None = None,
        local_address: str | None = None,
        expect_version=None,
    ):
        self.local = local_runtime
        self.self_rank = self_rank
        self.config = config or MigrationConfig.from_env()
        # pin the snapshot version (conventionally the training step) the
        # donors must serve: a donor whose registered state carries any
        # OTHER version is treated as not holding the piece — stale bytes
        # pass their own CRCs, so freshness must be checked explicitly
        self.expect_version = expect_version
        self._donors: list[_Donor] = []
        for rank, addr in donors:
            channel = grpc.insecure_channel(addr)
            self._donors.append(_Donor(
                rank, addr, channel,
                rpc.migration_stub(channel), rpc.device_stub(channel),
            ))
        # loopback stub for the local arm/poll RPCs: with an address the
        # calls ride real gRPC (and its retry semantics); without one they
        # go straight at the runtime object (in-process tests)
        self._local_stub = None
        if local_address is not None:
            self._local_channel = grpc.insecure_channel(local_address)
            self._local_stub = rpc.device_stub(self._local_channel)
        self._plans: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.stats = {
            "pieces": 0, "bytes": 0, "ms": 0.0,
            "retries": 0, "resumed": 0, "integrity_failures": 0,
        }
        self._registry = get_registry()

    @classmethod
    def from_comm(
        cls,
        members: list[tuple[int, int, str]],
        local_runtime,
        config: MigrationConfig | None = None,
        expect_version=None,
    ) -> "ShardMigrator":
        """Coordinator-brokered routing: ``members`` is the membership
        table ``CoordinatorRuntime.comm_members`` /
        ``GetCommStatus.members`` returns ([(rank, device_id, address)]);
        this host's own entry (matched by device id or bound address)
        becomes ``self_rank``, every other entry a donor."""
        self_rank = None
        donors = []
        for rank, device_id, address in members:
            if (device_id == local_runtime.device_id
                    or address == local_runtime.bound_address):
                self_rank = rank
            else:
                donors.append((rank, address))
        if self_rank is None:
            raise ValueError(
                f"local device {local_runtime.device_id} "
                f"({local_runtime.bound_address}) is not in the membership table"
            )
        return cls(local_runtime, self_rank, donors, config=config,
                   local_address=local_runtime.bound_address,
                   expect_version=expect_version)

    def close(self) -> None:
        for donor in self._donors:
            try:
                donor.channel.close()
            except Exception:  # noqa: BLE001 — close is best-effort
                pass
        if self._local_stub is not None:
            self._local_channel.close()

    # -- donor selection ---------------------------------------------------

    def reset_donors(self) -> None:
        """Forget donor death verdicts and cached plans — called at the
        START of each recovery (``ElasticController._recover``): a donor
        that flaked during the LAST outage may be healthy now, and its
        registered snapshot may have moved to a new version. Without this,
        one transient outage would permanently degrade every later
        recovery to the checkpoint fallback."""
        for donor in self._donors:
            donor.alive = True
        with self._lock:
            self._plans.clear()

    def _donors_holding(self, key: str) -> list[_Donor]:
        """Live donors that hold ``key`` at the expected snapshot version
        (PlanPieces answers cached per donor+key for one recovery —
        ``reset_donors`` clears the cache)."""
        held = []
        for donor in self._donors:
            if not donor.alive:
                continue
            cache_key = (donor.address, key)
            with self._lock:
                cached = self._plans.get(cache_key)
            if cached is None:
                try:
                    resp = call_with_retries(
                        "PlanPieces",
                        lambda d=donor: d.stub.PlanPieces(
                            json.dumps({"keys": [key]}).encode(),
                            timeout=self.config.timeout_s,
                        ),
                    )
                except grpc.RpcError as e:
                    log.warning("migration: donor %s unreachable (%s)",
                                donor.address, e)
                    donor.alive = False
                    continue
                info = json.loads(bytes(resp).decode("utf-8"))["pieces"].get(key)
                cached = info if info is not None else False
                with self._lock:
                    self._plans[cache_key] = cached
            if not cached:
                continue
            if (self.expect_version is not None
                    and cached.get("version") != self.expect_version):
                log.warning(
                    "migration: donor %s holds %s at version %r, expected "
                    "%r — skipping (stale snapshot)", donor.address, key,
                    cached.get("version"), self.expect_version,
                )
                continue
            held.append(donor)
        return held

    # -- the per-piece pull ------------------------------------------------

    def fetch_piece(self, key: str, piece, dtype,
                    trace_id: str | None = None) -> torch.Tensor:
        """Pull one piece (``piece`` = ((start, stop), ...) per dim) of leaf
        ``key`` over P2P streams; returns the typed array in piece shape.
        Raises :class:`MigrationError` when no donor can deliver.
        ``trace_id`` tags the flight-recorder event with the request trace
        this piece belongs to (the serving KV-handoff pull path)."""
        piece = [[int(s), int(e)] for s, e in piece]
        dtype = (DTYPE_NAMES.get(dtype, str(dtype)) if isinstance(dtype, torch.dtype)
                 else dtype if isinstance(dtype, str) else np.dtype(dtype).name)
        t0 = time.perf_counter()
        donors = self._donors_holding(key)
        if not donors:
            raise MigrationError(
                f"no live donor holds {key!r} (of {len(self._donors)} known)"
            )
        last_err: Exception | None = None
        for attempt in range(1 + max(self.config.retries, 0)):
            for donor in donors:
                if not donor.alive:
                    continue
                try:
                    data = self._fetch_from(donor, key, piece, dtype)
                except MigrationError as e:
                    last_err = e
                    self.stats["retries"] += 1
                    self._count("migration_retries_total")
                    log.warning("migration: %s from %s failed (attempt %d): %s",
                                key, donor.address, attempt + 1, e)
                    continue
                except grpc.RpcError as e:
                    last_err = e
                    donor.alive = False
                    log.warning("migration: donor %s died mid-piece (%s)",
                                donor.address, e)
                    continue
                ms = (time.perf_counter() - t0) * 1e3
                self.stats["pieces"] += 1
                self.stats["bytes"] += len(data)
                self.stats["ms"] += ms
                if self._registry.enabled:
                    self._registry.counter(
                        "migration_bytes_total",
                        "bytes moved by P2P shard migration",
                    ).inc(len(data))
                    self._registry.histogram(
                        "migration_ms", "per-piece shard-migration latency",
                        labels=("outcome",),
                    ).observe(ms, outcome="migrated")
                    self._registry.counter(
                        "migration_pieces_total",
                        "shard-migration piece outcomes", labels=("outcome",),
                    ).inc(outcome="migrated")
                extra = {"trace_id": trace_id} if trace_id else {}
                flight_recorder.record(
                    "migration_piece", key=key, bytes=len(data),
                    ms=round(ms, 3), donor=donor.address, **extra,
                )
                expect_shape = tuple(e - s for s, e in piece)
                try:
                    flat = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if data
                            else torch.empty(0, dtype=torch.uint8))
                    return flat.view(_torch_dtype(dtype)).reshape(expect_shape)
                except ValueError as e:
                    # must stay a MigrationError: the controller's fallback
                    # catches RuntimeError — a raw ValueError would crash
                    # the recovery instead of degrading to the checkpoint
                    raise MigrationError(
                        f"delivered bytes for {key!r} do not reinterpret as "
                        f"{dtype}{expect_shape}: {e}"
                    ) from e
        if self._registry.enabled:
            self._registry.counter(
                "migration_pieces_total",
                "shard-migration piece outcomes", labels=("outcome",),
            ).inc(outcome="failed")
            self._registry.histogram(
                "migration_ms", "per-piece shard-migration latency",
                labels=("outcome",),
            ).observe((time.perf_counter() - t0) * 1e3, outcome="failed")
        raise MigrationError(
            f"piece {piece} of {key!r} undeliverable after "
            f"{1 + max(self.config.retries, 0)} attempt(s): {last_err}"
        )

    def _fetch_from(self, donor: _Donor, key: str, piece, dtype) -> bytes:
        """One delivery attempt with resumable offsets under one deadline."""
        cfg = self.config
        deadline = time.monotonic() + cfg.timeout_s
        parts: list[bytes] = []
        offset = 0
        total = None
        chunk_crcs = None
        backoff = 0.02
        expect_shape = [int(e - s) for s, e in piece]
        itemsize = torch.empty(0, dtype=_torch_dtype(dtype)).element_size()
        expect_nbytes = int(np.prod(expect_shape, dtype=np.int64)) * itemsize
        while True:
            req = json.dumps({
                "dst_rank": self.self_rank,
                "pieces": [{"key": key, "piece": piece, "offset": offset}],
            }).encode()
            resp = call_with_retries(
                "BeginMigration",
                lambda: donor.stub.BeginMigration(req, timeout=cfg.timeout_s),
            )
            desc = json.loads(bytes(resp).decode("utf-8"))["streams"][0]
            if (self.expect_version is not None
                    and desc.get("version") != self.expect_version):
                raise MigrationError(
                    f"donor {donor.address} began serving {key!r} at "
                    f"version {desc.get('version')!r}, expected "
                    f"{self.expect_version!r} (snapshot moved mid-piece)"
                )
            # SEMANTIC validation, not just transport: the CRCs only prove
            # the bytes match the donor's snapshot — a donor holding the
            # leaf at a different dtype/shape would otherwise land bytes
            # that reinterpret silently (same itemsize) or crash the
            # recovery (different itemsize)
            if (desc.get("dtype") != str(dtype)
                    or list(desc.get("shape", [])) != expect_shape
                    or int(desc["total_nbytes"]) != expect_nbytes):
                raise MigrationError(
                    f"donor {donor.address} serves {key!r} as "
                    f"{desc.get('dtype')}{desc.get('shape')} "
                    f"({desc.get('total_nbytes')} B); expected "
                    f"{dtype}{expect_shape} ({expect_nbytes} B)"
                )
            if total is None:
                total = int(desc["total_nbytes"])
                chunk_crcs = list(desc["chunk_crcs"])
            sid = int(desc["stream_id"])
            nbytes = int(desc["nbytes"])
            # bounded-backoff re-arm: the receive arm itself may flake
            self._arm(sid, nbytes, donor.rank)
            status = self._poll(sid, deadline, donor)
            if status == SUCCESS:
                parts.append(self._read_local(cfg.recv_addr, nbytes))
                payload = b"".join(parts)
                if len(payload) != total:
                    raise MigrationError(
                        f"reassembled {len(payload)} of {total} bytes for {key!r}"
                    )
                self._validate(key, payload, chunk_crcs)
                return payload
            # FAILED or deadline: harvest whatever landed, then resume
            prefix = b""
            try:
                prefix = self.local.take_partial(sid)
            except Exception:  # noqa: BLE001 — stream may be unknown locally
                pass
            if prefix:
                parts.append(prefix)
                offset += len(prefix)
                self.stats["resumed"] += 1
                log.warning(
                    "migration: stream %d died at %d/%d bytes of %s; "
                    "resuming from offset %d", sid, offset, total, key, offset,
                )
            else:
                # the stream died before ANY byte flushed: nothing to
                # resume from, so this is a whole-suffix re-request — count
                # it as a retry so the stats (and the chaos verdict) see
                # that the fault exercised the recovery machinery
                self.stats["retries"] += 1
                self._count("migration_retries_total")
                log.warning(
                    "migration: stream %d died at %d/%d bytes of %s with no "
                    "new bytes; re-requesting", sid, offset, total, key,
                )
            if offset >= total:
                # the stream died AFTER delivering everything: the harvest
                # completed the payload — validate it like any other arrival
                payload = b"".join(parts)
                if len(payload) != total:
                    raise MigrationError(
                        f"reassembled {len(payload)} of {total} bytes for {key!r}"
                    )
                self._validate(key, payload, chunk_crcs)
                return payload
            if time.monotonic() >= deadline:
                raise MigrationError(
                    f"deadline ({cfg.timeout_s:.1f}s) blown at "
                    f"{offset}/{total} bytes of {key!r}"
                )
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.5)

    def _validate(self, key: str, payload: bytes, chunk_crcs) -> None:
        # the frames tile the payload exactly, so a whole-payload CRC on
        # top would re-scan every byte for zero extra information — one
        # pass over the frame table is the entire integrity check
        got = payload_chunk_crcs(payload)
        bad = [i for i, (a, b) in enumerate(zip(got, chunk_crcs)) if a != b]
        if len(got) != len(chunk_crcs) or bad:
            self.stats["integrity_failures"] += 1
            self._count("comm_stream_integrity_failures_total")
            flight_recorder.record(
                "migration_integrity_failure", key=key,
                bad_frames=bad[:8], frames=len(got),
            )
            raise MigrationError(
                f"CRC32C mismatch on {key!r}: frame(s) {bad[:8]} of "
                f"{len(got)} failed sender-side checksum validation"
            )

    def _count(self, name: str) -> None:
        if self._registry.enabled:
            self._registry.counter(name, name.replace("_", " ")).inc()

    # -- local stream plumbing (stub when an address is known, else direct) --

    def _arm(self, stream_id: int, nbytes: int, src_rank: int) -> None:
        # a LOCAL arm failure (e.g. the piece exceeds the landing buffer's
        # bounds) must surface as a MigrationError, not a grpc.RpcError —
        # fetch_piece attributes raw RpcErrors to donor death, and marking
        # healthy donors dead over a receiver-side problem both misleads
        # the logs and (per recovery) disables migration entirely
        try:
            if self._local_stub is not None:
                call_with_retries(
                    "BeginReceive",
                    lambda: self._local_stub.BeginReceive(
                        pb.BeginReceiveRequest(
                            streamId=pb.StreamId(value=stream_id),
                            recvBuffAddr=pb.MemAddr(value=self.config.recv_addr),
                            numBytes=nbytes,
                            srcRank=pb.Rank(value=src_rank),
                        ),
                        timeout=self.config.timeout_s,
                    ),
                )
            else:
                self.local.begin_receive(
                    stream_id, self.config.recv_addr, nbytes, src_rank
                )
        except (grpc.RpcError, DeviceError) as e:
            raise MigrationError(
                f"local BeginReceive for stream {stream_id} failed "
                f"(receiver-side): {e}"
            ) from e

    def _status(self, stream_id: int) -> int:
        try:
            if self._local_stub is not None:
                return call_with_retries(
                    "GetStreamStatus",
                    lambda: self._local_stub.GetStreamStatus(
                        pb.GetStreamStatusRequest(
                            streamId=pb.StreamId(value=stream_id)
                        ),
                        timeout=self.config.timeout_s,
                    ),
                ).status
            return self.local.stream_status(stream_id)
        except (grpc.RpcError, DeviceError) as e:
            raise MigrationError(
                f"local GetStreamStatus for stream {stream_id} failed "
                f"(receiver-side): {e}"
            ) from e

    def _poll(self, stream_id: int, deadline: float,
              donor: _Donor | None = None) -> int | None:
        """Poll the LOCAL stream to completion. Every few iterations also
        ask the DONOR's sender-side status: a dead push is terminal there
        immediately, while the receiver would sit IN_PROGRESS on a partial
        prefix until its stall deadline — the donor verdict is what lets a
        dropped stream resume within the piece deadline instead of after it."""
        ticks = 0
        while True:
            status = self._status(stream_id)
            if status != IN_PROGRESS:
                return status
            if donor is not None and ticks % 5 == 4:
                try:
                    sender = call_with_retries(
                        "GetStreamStatus",
                        lambda: donor.dev_stub.GetStreamStatus(
                            pb.GetStreamStatusRequest(
                                streamId=pb.StreamId(value=stream_id)
                            ),
                            timeout=self.config.timeout_s,
                        ),
                        retries=1,
                    ).status
                except grpc.RpcError:
                    return FAILED  # donor gone mid-stream: harvest + retry
                if sender == FAILED:
                    return FAILED
            if time.monotonic() >= deadline:
                return None
            ticks += 1
            time.sleep(self.config.poll_interval_s)

    def _read_local(self, addr: int, nbytes: int) -> bytes:
        return self.local.read_bytes(addr, nbytes)
