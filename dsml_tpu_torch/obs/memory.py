"""Device-memory ledger: per-subsystem attribution of the card's bytes —
the port of ``dsml_tpu/obs/memory.py``, reconciled against
``torch.cuda.memory_stats`` where the JAX module reads
``jax.Device.memory_stats()``.

A :class:`MemoryLedger` attributes device bytes to the subsystem that
allocated them and reconciles the claims against the allocator's own
statistics at scrape time.

Attribution model — two kinds of claim:

- **static claims** (:meth:`MemoryLedger.set_claim` /
  :meth:`claim_tree`): a subsystem states its resident bytes once, at
  the allocation site (trainer params/optimizer state, error-feedback
  residuals). ``claim_tree`` counts a tree's per-device resident bytes
  (:func:`tree_nbytes`).
- **live sources** (:meth:`register_source`): a callable re-read at
  every scrape — the paged KV pool's live/shared/free split, the
  quantized serving weights. Sources are held by weak reference: a
  retired batcher's pool drops out of the ledger with the batcher.

Reconciliation: a registry collect hook refreshes the gauges at every
exposition — ``hbm_claimed_bytes{subsystem,detail}``,
``hbm_measured_bytes{kind}`` (bytes_in_use / peak_bytes_in_use /
bytes_limit, when the card reports them), ``hbm_headroom_bytes``, and the
drift residual ``hbm_unattributed_bytes = measured − claimed``.
Provenance is always explicit (``hbm_source{source}``): "memory_stats"
when a card reported, "claimed" when the ledger's own attribution is the
only number.

**The torch.cuda mapping.** For each visible CUDA device, and only once
CUDA is initialised in this process (a scrape or a postmortem must never
initialise it), :func:`_device_memory_stats` reads
``torch.cuda.memory_stats(i)`` of PyTorch's caching allocator:

- ``bytes_in_use`` ← ``allocated_bytes.all.current`` (bytes handed to
  live tensors);
- ``peak_bytes_in_use`` ← ``allocated_bytes.all.peak`` (what
  ``torch.cuda.max_memory_allocated`` returns; ``reset_peak_memory_stats``
  resets it);
- ``bytes_limit`` ← ``torch.cuda.get_device_properties(i).total_memory``,
  read once per device and cached.

The allocator's cached segments (``reserved_bytes.all.current``) are not
``bytes_in_use``: they ride beside it as ``reserved_bytes`` in the
per-device rows of :meth:`MemoryLedger.measure` and of the snapshot, and
feed no gauge. Memory allocated outside the allocator (the ring's CUDA IPC
slots, ``cudaMalloc``'d by ``parallel/peer.py``) is in neither. Without
CUDA initialised the answer is ``[]``, a clean "statless" backend (as a
CPU JAX backend gives): the ledger then reports ``source: "claimed"``.

Zero-overhead-by-default contract (same as the registry's): every write
early-returns on one enabled check. Unlike the JAX ledger, no "statless"
answer is cached: CUDA may be initialised after a first scrape, and the
statless check (``torch.cuda.is_initialized()``) costs no more than the
cache would.

OOM forensics: :func:`is_oom` recognises ``torch.OutOfMemoryError`` and
out-of-memory shaped messages, :func:`maybe_dump_oom` writes a postmortem
bundle whose ``memory.json`` carries the ledger snapshot, the watermark
timeline, and every live source's last reading (the page-pool state) —
the flight recorder's crash hooks route OOM-shaped unhandled exceptions
through the same path.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import torch

from dsml_tpu_torch.obs.registry import Registry, get_registry

__all__ = [
    "SUBSYSTEMS",
    "MemoryLedger",
    "get_memory_ledger",
    "tensor_leaves",
    "tree_nbytes",
    "is_oom",
    "maybe_dump_oom",
]

SCHEMA = "dsml.obs.memory_ledger/1"

# the attribution taxonomy; new subsystems are allowed — this tuple
# documents the canonical set the wired hot paths use, it is not an enum
# the ledger enforces
SUBSYSTEMS = (
    "params",              # model weights
    "optimizer",           # optimizer state (adam moments)
    "error_feedback",      # quantized-sync EF residuals (per rank)
    "kv_pages",            # paged KV pool (live/shared/free/scratch split)
    "weights_quant",       # block-quantized serving weights (packed/scales)
    "migration_staging",   # P2P shard-motion staging spans in flight
    "checkpoint_staging",  # async-writer host snapshots awaiting commit
    "activations",         # measured step temps
)

# subsystems whose claims are HOST bytes (a queued checkpoint snapshot
# lives in RAM): reported like every claim, but EXCLUDED from the
# device-reconciliation residual
HOST_SUBSYSTEMS = frozenset({"checkpoint_staging"})

# bounded per-process watermark timeline
WATERMARK_CAP = 512

# textual shapes of a device OOM: the CUDA caching allocator's "CUDA out of
# memory", XLA's RESOURCE_EXHAUSTED status (kept from the JAX module), a
# cudaMalloc "out of memory" error string
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory",
                "hbm_oom", "allocation failure")

# device index -> total_memory, read once (a constant of the card)
_TOTAL_MEMORY: dict[int, int] = {}


def tensor_leaves(tree):
    """The tensors of ``tree``: a tensor, or dicts / lists / tuples of
    them, or an ``nn.Module`` (its ``named_parameters``), nested. Other
    leaves (numbers, strings, None) are skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        for _, p in tree.named_parameters():
            yield p
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def tree_nbytes(tree, per_device: bool = False) -> int:
    """Resident bytes of ``tree``'s tensors (:func:`tensor_leaves`).

    ``per_device=False`` — the logical total (every tensor's bytes).
    ``per_device=True`` — the device-binding number: bytes are summed per
    device and the MAX over devices is returned. Where the tree holds CUDA
    tensors only those count: host tensors beside them (``torch.optim``'s
    per-parameter ``step`` counts stay on the CPU unless the optimizer is
    fused or capturable) occupy no card memory. A tree with no CUDA
    tensor is a CPU run's, and its CPU total is the device number (as a
    CPU JAX backend's arrays are)."""
    total = cpu = 0
    per_dev: dict = {}
    for t in tensor_leaves(tree):
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if t.is_cuda:
            per_dev[t.device] = per_dev.get(t.device, 0) + nbytes
        elif t.device.type == "cpu":
            cpu += nbytes
    if not per_device:
        return total
    return max(per_dev.values()) if per_dev else cpu


def _total_memory(i: int) -> int:
    if i not in _TOTAL_MEMORY:
        _TOTAL_MEMORY[i] = int(torch.cuda.get_device_properties(i).total_memory)
    return _TOTAL_MEMORY[i]


def _device_memory_stats() -> list[dict] | None:
    """Per-device rows of ``torch.cuda.memory_stats`` (the mapping in the
    module docstring), ONLY when CUDA is already initialised in this
    process — a scrape (or a postmortem dump) must never initialise it.
    ``[]`` = a clean "statless" answer (no CUDA in use here), ``None`` =
    the poll itself failed (every device call raised)."""
    if not torch.cuda.is_initialized():
        return []
    try:
        n = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — a half-dead CUDA context
        return None
    out = []
    polled_clean = n == 0
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
            limit = _total_memory(i)
        except Exception:  # noqa: BLE001
            continue
        polled_clean = True
        if not stats:
            continue
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get(
                "allocated_bytes.all.peak", stats.get("allocated_bytes.all.current", 0))),
            "bytes_limit": limit,
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        })
    return out if (out or polled_clean) else None


class MemoryLedger:
    """Per-subsystem device-byte attribution bound to one registry.

    All writes no-op (one enabled check) when the registry is disabled;
    reads (:meth:`claimed`, :meth:`measure`, :meth:`snapshot`) always
    work — a postmortem of a disabled-registry process still carries
    whatever the live sources can tell it.
    """

    def __init__(self, registry: Registry | None = None, stats_fn=None):
        self.registry = registry if registry is not None else get_registry()
        # injectable for tests/bench: () -> list of per-device stat rows
        self._stats_fn = stats_fn if stats_fn is not None else _device_memory_stats
        self._lock = threading.Lock()
        self._claims: dict[tuple[str, str], float] = {}  # (subsystem, detail)
        # (subsystem, name, weakref-to-callable); pruned on read
        self._sources: list[tuple[str, str, object]] = []
        self._watermarks: collections.deque = collections.deque(maxlen=WATERMARK_CAP)
        # gauges refresh at scrape time, not write time — derived values
        # (unattributed, headroom) depend on the live measure
        self.registry.add_collect_hook(self._refresh_gauges)

    # -- claims ------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.registry.enabled

    def set_claim(self, subsystem: str, nbytes: float,
                  detail: str = "total") -> None:
        """State ``subsystem``'s resident device bytes (absolute, not a
        delta — re-claiming replaces). No-op when disabled."""
        if not self.registry.enabled:
            return
        with self._lock:
            self._claims[(str(subsystem), str(detail))] = float(max(nbytes, 0.0))

    def clear_claim(self, subsystem: str, detail: str | None = None) -> None:
        """Drop a subsystem's claim (``detail=None`` = every detail)."""
        with self._lock:
            self._claims = {
                k: v for k, v in self._claims.items()
                if not (k[0] == subsystem and (detail is None or k[1] == detail))
            }

    def claim_tree(self, subsystem: str, tree, detail: str = "total") -> int:
        """Claim a tree's per-device resident bytes (see
        :func:`tree_nbytes`); returns the bytes claimed (0 when disabled —
        the tree is never walked)."""
        if not self.registry.enabled:
            return 0
        nbytes = tree_nbytes(tree, per_device=True)
        self.set_claim(subsystem, nbytes, detail=detail)
        return nbytes

    def register_source(self, subsystem: str, fn, name: str = "0") -> None:
        """Register a live byte source re-read at every scrape/snapshot.
        ``fn() -> bytes | {detail: bytes}``. Weakly held: the source dies
        with its owner. Registration is unconditional (cheap) so a ledger
        enabled mid-run sees sources wired while it was off."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            # same (subsystem, name) re-registers (an owner rebuilt)
            self._sources = [
                s for s in self._sources
                if not (s[0] == subsystem and s[1] == name)
            ]
            self._sources.append((str(subsystem), str(name), ref))

    def _read_sources(self) -> dict[tuple[str, str], float]:
        """Pull every live source; prune the dead. A broken source must
        not break a scrape (or the postmortem that wants the others)."""
        with self._lock:
            sources = list(self._sources)
        out: dict[tuple[str, str], float] = {}
        dead = []
        for subsystem, name, ref in sources:
            fn = ref()
            if fn is None:
                dead.append((subsystem, name, ref))
                continue
            try:
                got = fn()
            except Exception:  # noqa: BLE001
                continue
            if isinstance(got, dict):
                for detail, nbytes in got.items():
                    key = (subsystem, str(detail))
                    out[key] = out.get(key, 0.0) + float(nbytes)
            elif got is not None:
                key = (subsystem, name)
                out[key] = out.get(key, 0.0) + float(got)
        if dead:
            with self._lock:
                self._sources = [s for s in self._sources if s not in dead]
        return out

    def claimed(self) -> dict[str, dict[str, float]]:
        """{subsystem: {detail: bytes}} — static claims merged with a
        fresh read of every live source (sources sum into their detail)."""
        with self._lock:
            merged = dict(self._claims)
        for key, nbytes in self._read_sources().items():
            merged[key] = merged.get(key, 0.0) + nbytes
        out: dict[str, dict[str, float]] = {}
        for (subsystem, detail), nbytes in sorted(merged.items()):
            out.setdefault(subsystem, {})[detail] = nbytes
        return out

    def static_claimed_bytes(self) -> float:
        """Sum of the STATIC claims only — one lock + dict sum, no source
        callables, no cross-subsystem locks. The per-step watermark's
        fallback value on statless backends: a train step must never walk
        the serving pools' or the donor's lock-guarded state."""
        with self._lock:
            return float(sum(self._claims.values()))

    def claimed_bytes(self, subsystem: str | None = None,
                      details: tuple | None = None) -> float:
        """Total claimed bytes — one subsystem's (optionally restricted to
        ``details``) or the whole ledger's. Reads every live source; for
        hot paths use :meth:`static_claimed_bytes`."""
        claims = self.claimed()
        if subsystem is not None:
            claims = {subsystem: claims.get(subsystem, {})}
        return float(sum(
            nbytes
            for per_detail in claims.values()
            for detail, nbytes in per_detail.items()
            if details is None or detail in details
        ))

    # -- measurement -------------------------------------------------------

    def measure(self) -> dict:
        """The backend's own numbers, aggregated per-chip-conservatively:
        ``bytes_in_use``/``peak_bytes_in_use`` are the MAX over devices
        (the binding chip), ``bytes_limit``/``headroom`` the MIN. Returns
        ``{"available": False, "source": "claimed"}`` when no device
        reports stats — callers must branch on provenance, never on a
        guessed constant."""
        rows = self._stats_fn()
        if not rows:
            return {"available": False, "source": "claimed", "devices": 0}
        in_use = max(r["bytes_in_use"] for r in rows)
        peak = max(r["peak_bytes_in_use"] for r in rows)
        limits = [r["bytes_limit"] for r in rows if r["bytes_limit"]]
        limit = min(limits) if limits else 0
        return {
            "available": True,
            "source": "memory_stats",
            "devices": len(rows),
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "headroom_bytes": (limit - in_use) if limit else None,
            "per_device": rows,
        }

    def headroom_bytes(self) -> float | None:
        """Measured per-chip headroom (min over devices), or None when the
        backend reports no stats — the paged batcher's pressure reading
        and the elastic planner both branch on None rather than inventing
        a constant."""
        m = self.measure()
        return m.get("headroom_bytes") if m["available"] else None

    def device_claimed_bytes(self) -> float:
        """Claimed DEVICE bytes: the full claimed total minus
        :data:`HOST_SUBSYSTEMS` — the side reconciliation compares
        against ``memory_stats`` (host-RAM claims like a queued
        checkpoint snapshot must not enter a device residual)."""
        claims = self.claimed()
        return float(sum(
            nbytes
            for subsystem, per_detail in claims.items()
            if subsystem not in HOST_SUBSYSTEMS
            for nbytes in per_detail.values()
        ))

    def unattributed_bytes(self) -> float | None:
        """``measured bytes_in_use − claimed DEVICE total`` — the drift
        gauge (host-subsystem claims excluded; see
        :data:`HOST_SUBSYSTEMS`). None when nothing is measured (there is
        no residual against pure bookkeeping)."""
        m = self.measure()
        if not m["available"]:
            return None
        return float(m["bytes_in_use"]) - self.device_claimed_bytes()

    # -- watermarks --------------------------------------------------------

    def note_step_peak(self, step: int | None = None,
                       label: str | None = None) -> None:
        """Record one watermark: the measured peak when the backend
        reports one, else the STATIC claimed total (source-stamped either
        way — live sources are deliberately excluded here: walking the
        serving pools' and the donor's lock-guarded state per train step
        would turn a watermark into cross-subsystem lock traffic; the
        scrape-time gauges and snapshots carry the full source-inclusive
        picture). The trainer calls this at loss syncs, the hybrid step
        after every step; one enabled check when off, a CUDA-initialised
        check + dict sum on a statless (CPU) run; on the card a read of
        the allocator's statistics, host-side (no device sync)."""
        if not self.registry.enabled:
            return
        m = self.measure()
        if m["available"]:
            value, source = float(m["peak_bytes_in_use"]), "memory_stats"
        else:
            value, source = self.static_claimed_bytes(), "claimed"
        entry = {"t": round(time.time(), 6), "peak_bytes": value,
                 "source": source}
        if step is not None:
            entry["step"] = int(step)
        if label is not None:
            entry["label"] = str(label)
        with self._lock:
            self._watermarks.append(entry)
        self.registry.gauge(
            "hbm_step_peak_bytes",
            "last recorded per-step peak device bytes (watermark)",
            labels=("source",),
        ).set(value, source=source)

    def watermarks(self) -> list[dict]:
        with self._lock:
            return list(self._watermarks)

    def clear(self) -> None:
        """Drop claims + watermarks (tests; a fresh bench section). Sources survive — their owners are still
        alive."""
        with self._lock:
            self._claims.clear()
            self._watermarks.clear()

    # -- exposition --------------------------------------------------------

    def _refresh_gauges(self) -> None:
        """Registry collect hook: re-derive every gauge at scrape time so
        an exposition always reflects the live sources and the live
        measure, not the last write."""
        if not self.registry.enabled:
            return
        claims = self.claimed()
        claimed_gauge = self.registry.gauge(
            "hbm_claimed_bytes",
            "device bytes attributed to a subsystem by the memory ledger",
            labels=("subsystem", "detail"),
        )
        # label sets change between scrapes (a retired batcher's pool
        # drops out; provenance can flip): clear before re-deriving, or a
        # dead series would freeze at its last bytes in every exposition
        claimed_gauge.clear()
        total = device_total = 0.0
        for subsystem, per_detail in claims.items():
            for detail, nbytes in per_detail.items():
                claimed_gauge.set(nbytes, subsystem=subsystem, detail=detail)
                total += nbytes
                if subsystem not in HOST_SUBSYSTEMS:
                    device_total += nbytes
        self.registry.gauge(
            "hbm_claimed_total_bytes", "sum of every ledger claim",
        ).set(total)
        m = self.measure()
        source_gauge = self.registry.gauge(
            "hbm_source",
            "1 for the provenance the ledger's numbers carry "
            "(memory_stats = measured, claimed = bookkeeping only)",
            labels=("source",),
        )
        source_gauge.clear()  # exactly ONE provenance series at a time
        source_gauge.set(1.0, source=m["source"])
        measured_gauge = self.registry.gauge(
            "hbm_measured_bytes",
            "device memory_stats as scraped (max in-use/peak, min limit "
            "over local devices)",
            labels=("kind",),
        )
        if not m["available"]:
            # a provenance flip back to claimed (stats source gone) must
            # not leave the last measured rows frozen in the exposition
            measured_gauge.clear()
        else:
            for kind in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                measured_gauge.set(float(m[kind]), kind=kind)
            if m.get("headroom_bytes") is not None:
                self.registry.gauge(
                    "hbm_headroom_bytes",
                    "min over devices of bytes_limit - bytes_in_use",
                ).set(float(m["headroom_bytes"]))
            self.registry.gauge(
                "hbm_unattributed_bytes",
                "measured bytes_in_use minus ledger-claimed DEVICE total "
                "(host-subsystem claims excluded; attribution drift — "
                "persistent growth = an unclaimed subsystem)",
            ).set(float(m["bytes_in_use"]) - device_total)

    def snapshot(self) -> dict:
        """Self-contained machine-readable state: claims (sources
        included), measurement + provenance, residual, watermark tail."""
        claims = self.claimed()
        total = sum(n for d in claims.values() for n in d.values())
        device_total = sum(
            n for s, d in claims.items() if s not in HOST_SUBSYSTEMS
            for n in d.values()
        )
        m = self.measure()
        per_device = m.pop("per_device", None)
        snap = {
            "schema": SCHEMA,
            "time": time.time(),
            "claimed": claims,
            "claimed_total_bytes": total,
            "claimed_device_bytes": device_total,
            "measured": m,
            "unattributed_bytes": (
                float(m["bytes_in_use"]) - device_total
                if m["available"] else None
            ),
            "watermarks": self.watermarks(),
        }
        if per_device:
            snap["measured"]["per_device"] = per_device
        return snap


# one ledger per registry, stored ON the registry (shares its lifetime —
# a weak-keyed map whose value strongly referenced the key would leak
# every private bench/test registry): the default registry gets the
# default ledger; private registries get their own on first ask — the
# flight recorder resolves THROUGH its registry, so a private-recorder
# bundle never leaks the process ledger's claims
_ledgers_lock = threading.Lock()


def get_memory_ledger(registry: Registry | None = None) -> MemoryLedger:
    reg = registry if registry is not None else get_registry()
    with _ledgers_lock:
        ledger = getattr(reg, "_memory_ledger", None)
        if ledger is None:
            ledger = reg._memory_ledger = MemoryLedger(registry=reg)
        return ledger


def is_oom(exc: BaseException | None) -> bool:
    """Is this exception device-memory-exhaustion shaped? A
    ``torch.OutOfMemoryError`` (the CUDA caching allocator's, whatever its
    message says), or out-of-memory / RESOURCE_EXHAUSTED text in the
    exception type or message (chained causes included one level)."""
    if exc is None:
        return False
    for e in (exc, exc.__cause__, exc.__context__):
        if e is None:
            continue
        if isinstance(e, torch.OutOfMemoryError):
            return True
        text = f"{type(e).__name__}: {e}".lower()
        if any(marker in text for marker in _OOM_MARKERS):
            return True
    return False


def maybe_dump_oom(exc: BaseException, recorder=None,
                   directory: str | None = None) -> str | None:
    """If ``exc`` is OOM-shaped, write a postmortem bundle (reason
    ``resource_exhausted``) whose ``memory.json`` carries the ledger
    snapshot + watermark timeline, and stamp ``exc.bundle`` so the crash
    hooks don't dump a second near-identical bundle. Returns the bundle
    directory, or None when the exception is not an OOM."""
    if not is_oom(exc):
        return None
    if getattr(exc, "bundle", None) is not None:
        return exc.bundle  # already dumped (sentinel/hangwatch contract)
    from dsml_tpu_torch.obs import flight_recorder

    rec = recorder if recorder is not None else flight_recorder.get_flight_recorder()
    bundle = rec.dump("resource_exhausted", exc=exc, directory=directory)
    try:
        exc.bundle = bundle
    except Exception:  # noqa: BLE001 — slotted/frozen exceptions
        pass
    return bundle
