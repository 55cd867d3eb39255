"""Cluster observability plane: cross-process metric aggregation and trace
stitching — the port's copy of ``dsml_tpu/obs/cluster.py`` (its HTTP and
offline half).

- :func:`snapshot` — one process's registry and Chrome trace, stamped
  with ``host``/``pid``/``role`` identity and a monotonic-clock reading on
  the SAME origin as the trace events' ``ts`` (so offsets computed for
  the snapshot align its spans too).
- :class:`ClusterAggregator` — collects snapshots (HTTP scrape of
  ``start_metrics_server``'s ``/cluster.json``, or plain dicts and
  files), merges them (exact-sum counters, bucket-wise histogram merge),
  and exposes ONE Prometheus/JSONL exposition where every series carries
  ``host``/``pid``/``role`` labels, plus ``<name>:fleet`` aggregate
  series, fleet goodput, a per-process straggler ranking and the fleet's
  SLO status.
- :func:`stitch_traces` — per-process Chrome traces merged into one
  timeline with one lane (pid) per process, aligned by handshake-measured
  clock offsets (NTP-style midpoint) with a wall-clock fallback for
  offline snapshot files; :func:`trace_summary` reads each request's
  causal chain out of it.

The snapshot schema, merge semantics and clock contract are the JAX
package's: a snapshot written by either package merges in the other's
``MergedView``.

The gRPC half rides the wire's plumbing (``comm/rpc.py``'s raw-JSON
``dsml_obs.ObsPlane`` service, attached to every device server and
coordinator): :meth:`ClusterAggregator.pull`, :class:`ObsServicer`,
:class:`AggregatorServicer`, :func:`serve_aggregator`,
:func:`push_snapshot` and :func:`run_cluster_demo` (the coordinator plus
device-server subprocesses, ``python -m dsml_tpu_torch.obs.cluster --demo
OUT_DIR``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time

from dsml_tpu_torch.obs import spans as _spans
from dsml_tpu_torch.obs.registry import (
    Registry,
    _fmt_labels,
    _fmt_num,
    get_registry,
)
from dsml_tpu_torch.obs.slo import STATUS_LEVELS, burn_rate

__all__ = [
    "SNAPSHOT_SCHEMA",
    "AggregatorServicer",
    "ClockSync",
    "ClusterAggregator",
    "ObsServicer",
    "current_role",
    "estimate_quantile",
    "merge_snapshots",
    "push_snapshot",
    "run_cluster_demo",
    "serve_aggregator",
    "snapshot",
    "stitch_traces",
    "trace_summary",
    "validate_snapshot",
]

SNAPSHOT_SCHEMA = "dsml.obs.cluster/1"

# identity labels the aggregator stamps onto every merged series; a worker
# registry must not use them itself (the merge would silently shadow them)
IDENTITY_LABELS = ("host", "pid", "role")


def current_role(default: str = "worker") -> str:
    """This process's fleet role (``DSML_OBS_ROLE``, else ``default``).
    Conventional values: coordinator / device_server / trainer /
    decode_replica / chaos / bench."""
    return os.environ.get("DSML_OBS_ROLE", "") or default


def now_us() -> float:
    """Monotonic µs on the SAME origin as span trace events' ``ts`` —
    the snapshot clock and the trace clock must be one clock, or the
    stitcher's offsets would align the metrics but skew the spans."""
    return (time.perf_counter() - _spans.SpanTracer._t0) * 1e6


def snapshot(role: str | None = None, registry: Registry | None = None,
             tracer=None, with_trace: bool = True) -> dict:
    """One process's observable state, stamped with identity + clocks.

    The ``wall_s``/``mono_us`` pair is the offline clock handshake: two
    snapshots' offsets can always be estimated from wall clocks (coarse,
    NTP-disciplined hosts); a live scrape adds the precise RTT-midpoint
    handshake on top (:meth:`ClusterAggregator.add_scraped`)."""
    reg = registry if registry is not None else get_registry()
    trc = tracer if tracer is not None else _spans.get_tracer()
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "role": role or current_role(),
        "wall_s": time.time(),
        "mono_us": now_us(),
        "enabled": reg.enabled,
        "metrics": reg.collect(),
    }
    if with_trace:
        snap["trace"] = trc.chrome_trace()
    return snap


@dataclasses.dataclass
class ClockSync:
    """A process clock's offset into the aggregator's monotonic timeline:
    ``t_agg_us = t_proc_us + offset_us``. ``rtt_us`` bounds the handshake
    error (the true offset lies within ±rtt/2 of the midpoint estimate);
    wall-clock fallbacks carry ``rtt_us=None`` — same-host processes share
    a wall clock, cross-host accuracy is NTP's."""

    offset_us: float
    rtt_us: float | None
    method: str  # "handshake" | "wall" | "identity"

    @classmethod
    def from_handshake(cls, t0_us: float, t1_us: float,
                       proc_mono_us: float) -> "ClockSync":
        """NTP-style single exchange: the aggregator read its clock at
        ``t0`` (request out) and ``t1`` (response in); the worker read
        ``proc_mono_us`` somewhere in between — assume the midpoint."""
        return cls(offset_us=(t0_us + t1_us) / 2.0 - proc_mono_us,
                   rtt_us=max(t1_us - t0_us, 0.0), method="handshake")

    @classmethod
    def from_wall(cls, snap: dict, ref_wall_s: float,
                  ref_mono_us: float) -> "ClockSync":
        """Fallback: map the snapshot's (wall, mono) pair onto the
        aggregator's. offset = what must be added to the process's mono
        reading so both clocks agree on the shared wall instant."""
        return cls(
            offset_us=(snap["wall_s"] - ref_wall_s) * 1e6
            + ref_mono_us - snap["mono_us"],
            rtt_us=None, method="wall",
        )


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def _series_key(rec: dict) -> tuple:
    return (rec["name"], tuple(sorted(rec.get("labels", {}).items())))


def _bounds_of(rec: dict) -> tuple:
    return tuple(b for b in rec["buckets"] if b != "+Inf")


def _noncumulative(rec: dict) -> list[int]:
    """Recover per-bucket counts (incl. the +Inf overflow) from the
    cumulative exposition."""
    bounds = _bounds_of(rec)
    cum = [rec["buckets"][b] for b in bounds] + [rec["buckets"]["+Inf"]]
    out, prev = [], 0
    for c in cum:
        out.append(c - prev)
        prev = c
    return out


def estimate_quantile(bounds: tuple, cum_counts: dict, q: float) -> float | None:
    """Quantile estimate from cumulative bucket counts (linear
    interpolation inside the straddling bucket, Prometheus
    ``histogram_quantile`` style). Used for fleet-level percentiles,
    where no raw sample tail survives the merge. Returns the top finite
    bound when the quantile lands in the +Inf overflow bucket."""
    total = cum_counts.get("+Inf", 0)
    if total <= 0:
        return None
    rank = q * total
    prev_cum, prev_bound = 0, 0.0
    for b in bounds:
        c = cum_counts[b]
        if c >= rank:
            inside = c - prev_cum
            frac = (rank - prev_cum) / inside if inside else 1.0
            return float(prev_bound + frac * (float(b) - prev_bound))
        prev_cum, prev_bound = c, float(b)
    return float(bounds[-1]) if bounds else None


class _MergedHist:
    __slots__ = ("bounds", "counts", "sum", "count", "conflict", "exemplars")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.conflict = False  # a contributor's bounds didn't match
        self.exemplars: dict = {}  # bucket bound -> newest exemplar

    def add(self, rec: dict) -> bool:
        if _bounds_of(rec) != self.bounds:
            self.conflict = True
            return False
        for i, c in enumerate(_noncumulative(rec)):
            self.counts[i] += c
        self.sum += rec["sum"]
        self.count += rec["count"]
        # exemplars survive the merge (newest wall-clock wins per bucket):
        # a FLEET tail bucket still resolves to a concrete trace_id
        for bound, ex in (rec.get("exemplars") or {}).items():
            prev = self.exemplars.get(bound)
            if prev is None or ex.get("time", 0) >= prev.get("time", 0):
                self.exemplars[bound] = ex
        return True

    def cumulative(self) -> dict:
        out, running = {}, 0
        for b, c in zip(self.bounds, self.counts):
            running += c
            out[b] = running
        out["+Inf"] = running + self.counts[-1]
        return out


class MergedView:
    """The fleet-wide merge of N process snapshots.

    Two layers, one exposition:

    - *per-process series*: every worker series re-labeled with
      ``host``/``pid``/``role`` — the lossless layer; sums/rates computed
      downstream stay exact because nothing was pre-aggregated;
    - *fleet aggregates*: counters exact-summed, histograms merged
      bucket-wise (bounds must match — mismatches are kept per-process
      only and listed in ``notes``), exposed under ``<name>:fleet`` (the
      Prometheus recording-rule naming convention, so a fleet series can
      never be double-counted into a ``sum()`` over worker series).
      Gauges are NOT fleet-aggregated — a queue depth sums, a ratio
      means; picking silently would lie — the per-process layer plus
      :meth:`report`'s min/mean/max cover both readings.
    """

    def __init__(self):
        self.processes: list[dict] = []  # identity dicts, insertion order
        self._proc_series: list[dict] = []  # re-labeled per-process records
        self._fleet_counters: dict[tuple, float] = {}
        self._fleet_hists: dict[tuple, _MergedHist] = {}
        self._meta: dict[str, tuple] = {}  # name -> (type, help-less kind)
        self.notes: list[str] = []

    # -- ingest ------------------------------------------------------------

    def add_snapshot(self, snap: dict) -> None:
        validate_snapshot(snap)
        ident = {"host": str(snap["host"]), "pid": str(snap["pid"]),
                 "role": str(snap["role"])}
        self.processes.append(
            {**ident, "wall_s": snap["wall_s"], "mono_us": snap["mono_us"],
             "n_series": len(snap["metrics"])}
        )
        for rec in snap["metrics"]:
            labels = dict(rec.get("labels", {}))
            clash = set(labels) & set(IDENTITY_LABELS)
            if clash:
                # a worker label named "host" would be silently shadowed by
                # the identity stamp; surface it instead
                self.notes.append(
                    f"{rec['name']}: worker labels {sorted(clash)} shadowed "
                    "by identity labels"
                )
            self._meta[rec["name"]] = rec["type"]
            self._proc_series.append(
                {**rec, "labels": {**labels, **ident}}
            )
            key = _series_key(rec)
            if rec["type"] == "counter":
                self._fleet_counters[key] = (
                    self._fleet_counters.get(key, 0.0) + rec["value"]
                )
            elif rec["type"] == "histogram":
                merged = self._fleet_hists.get(key)
                if merged is None:
                    merged = self._fleet_hists[key] = _MergedHist(_bounds_of(rec))
                if not merged.add(rec):
                    self.notes.append(
                        f"{rec['name']}{dict(key[1])}: bucket bounds differ "
                        "across processes; fleet merge skipped (per-process "
                        "series retained)"
                    )

    # -- derived fleet metrics --------------------------------------------

    def _gauge_values(self, *names: str) -> list[tuple[dict, float]]:
        return [
            (rec["labels"], rec["value"])
            for rec in self._proc_series
            if rec["name"] in names and rec["type"] == "gauge"
        ]

    def fleet_goodput(self) -> float | None:
        """Mean of the per-process goodput gauges (``train_goodput`` /
        ``goodput_ratio``), one vote per process — each gauge is already
        a productive/wall RATIO for its whole process, so the unweighted
        mean is the fleet's "average fraction of wall spent training";
        per-process values stay in the exposition for weighted readings."""
        per_proc: dict[tuple, float] = {}
        for labels, v in self._gauge_values("train_goodput", "goodput_ratio"):
            per_proc[(labels["host"], labels["pid"])] = float(v)
        if not per_proc:
            return None
        return sum(per_proc.values()) / len(per_proc)

    def straggler_ranking(self, metric: str = "span_ms",
                          where: dict | None = None, q: float = 0.5,
                          multiplier: float = 2.0) -> list[dict]:
        """Per-process latency ranking from ``metric``'s per-process
        histograms, worst first. ``where`` filters on the metric's own
        labels (e.g. ``{"name": "wire_op"}``); ``q`` picks the quantile;
        a process above ``multiplier``× the fleet median is flagged
        ``straggler`` — the cross-host signal the MLPerf pod paper tunes
        on, which N disconnected registries cannot produce."""
        per_proc: dict[tuple, dict] = {}
        for rec in self._proc_series:
            if rec["name"] != metric or rec["type"] != "histogram":
                continue
            labels = rec["labels"]
            if where and any(labels.get(k) != str(v) for k, v in where.items()):
                continue
            key = (labels["host"], labels["pid"], labels["role"])
            slot = per_proc.setdefault(
                key, {"bounds": _bounds_of(rec), "counts": {}, "count": 0}
            )
            if slot["bounds"] != _bounds_of(rec):
                continue  # mixed-bound series within one process: skip
            for b, c in rec["buckets"].items():
                slot["counts"][b] = slot["counts"].get(b, 0) + c
            slot["count"] += rec["count"]
        rows = []
        for (host, pid, role), slot in per_proc.items():
            est = estimate_quantile(slot["bounds"], slot["counts"], q)
            if est is None:
                continue
            rows.append({"host": host, "pid": pid, "role": role,
                         "value_ms": round(est, 6), "count": slot["count"]})
        rows.sort(key=lambda r: r["value_ms"], reverse=True)
        if rows:
            vals = sorted(r["value_ms"] for r in rows)
            median = vals[len(vals) // 2]
            for r in rows:
                r["straggler"] = bool(r["value_ms"] > multiplier * median
                                      and len(rows) > 1)
        return rows

    def slo_status(self) -> dict:
        """Fleet-wide SLO accounting from the merged ``slo_*`` series
        (written per process by ``obs.slo.SLOTracker`` — the serving
        router's request accounting). Counters merge EXACTLY, so per-class
        per-SLI compliance and the all-time burn are true fleet numbers;
        the rolling multi-window status is per-process state, so the
        fleet status is the WORST process's (max of the
        ``slo_burn_status`` gauges — a paging replica pages the fleet)."""
        classes: dict[str, dict] = {}

        def cls_row(name: str) -> dict:
            return classes.setdefault(
                name, {"objective": None, "requests": 0, "good_requests": 0,
                       "sli": {}, "status": "ok"}
            )

        for (name, labels), v in self._fleet_counters.items():
            ld = dict(labels)
            if name == "slo_requests_total" and "slo" in ld:
                cls_row(ld["slo"])["requests"] = int(v)
            elif name == "slo_good_total" and "slo" in ld:
                cls_row(ld["slo"])["good_requests"] = int(v)
            elif name == "slo_sli_total" and {"slo", "sli", "verdict"} <= set(ld):
                sli = cls_row(ld["slo"])["sli"].setdefault(
                    ld["sli"], {"good": 0, "bad": 0}
                )
                sli[ld["verdict"]] = sli.get(ld["verdict"], 0) + int(v)
        levels = STATUS_LEVELS  # one ladder — obs.slo owns the encoding
        names = {v: k for k, v in levels.items()}
        for rec in self._proc_series:
            if rec["type"] != "gauge":
                continue
            ld = rec["labels"]
            if rec["name"] == "slo_objective" and ld.get("slo") in classes:
                classes[ld["slo"]]["objective"] = float(rec["value"])
            elif rec["name"] == "slo_burn_status" and ld.get("slo") in classes:
                row = classes[ld["slo"]]
                level = int(rec["value"])
                if level > levels[row["status"]]:
                    row["status"] = names.get(level, "page")
                sli = row["sli"].setdefault(ld.get("sli", "?"), {})
                worst = sli.get("status", "ok")
                if level > levels.get(worst, 0):
                    sli["status"] = names.get(level, "page")
        for row in classes.values():
            obj = row["objective"]
            for sli in row["sli"].values():
                total = sli.get("good", 0) + sli.get("bad", 0)
                if total:
                    sli["compliance"] = round(sli.get("good", 0) / total, 6)
                    if obj is not None and obj < 1.0:
                        sli["burn_total"] = round(
                            burn_rate(sli.get("bad", 0) / total, obj), 4
                        )
                sli.setdefault("status", "ok")
        return classes

    # -- exposition --------------------------------------------------------

    def collect(self) -> list[dict]:
        """JSON snapshot: per-process series + fleet aggregates."""
        out = list(self._proc_series)
        for (name, labels), v in sorted(self._fleet_counters.items()):
            out.append({"name": f"{name}:fleet", "type": "counter",
                        "labels": dict(labels), "value": v})
        for (name, labels), h in sorted(self._fleet_hists.items()):
            if h.conflict:
                continue
            rec = {"name": f"{name}:fleet", "type": "histogram",
                   "labels": dict(labels), "buckets": h.cumulative(),
                   "sum": h.sum, "count": h.count}
            if h.exemplars:
                rec["exemplars"] = dict(h.exemplars)
            out.append(rec)
        g = self.fleet_goodput()
        if g is not None:
            out.append({"name": "fleet_goodput", "type": "gauge",
                        "labels": {}, "value": round(g, 6)})
        out.append({"name": "fleet_processes", "type": "gauge", "labels": {},
                    "value": len(self.processes)})
        return out

    def to_jsonl(self) -> str:
        now = time.time()
        return "\n".join(
            json.dumps({"time": now, **rec}) for rec in self.collect()
        )

    def to_prometheus_text(self) -> str:
        """ONE text exposition for the whole fleet (format 0.0.4): worker
        series labeled {host,pid,role}, fleet aggregates as
        ``<name>:fleet``, plus the derived fleet gauges."""
        lines, last_family = [], None
        # group by family: per-process records arrive interleaved across
        # snapshots, and the exposition format wants one TYPE header with
        # every series of that family under it
        records = sorted(self.collect(),
                         key=lambda r: (r["name"], sorted(r["labels"].items())))
        for rec in records:
            base = rec["name"].removesuffix(":fleet")
            kind = self._meta.get(base, rec["type"])
            if rec["name"] != last_family:
                lines.append(f"# TYPE {rec['name']} {kind}")
                last_family = rec["name"]
            pairs = rec["labels"]
            if rec["type"] == "histogram":
                for b, c in rec["buckets"].items():
                    lines.append(
                        f"{rec['name']}_bucket"
                        f"{_fmt_labels({**pairs, 'le': b})} {c}"
                    )
                lines.append(
                    f"{rec['name']}_sum{_fmt_labels(pairs)} {_fmt_num(rec['sum'])}"
                )
                lines.append(
                    f"{rec['name']}_count{_fmt_labels(pairs)} {rec['count']}"
                )
            else:
                lines.append(
                    f"{rec['name']}{_fmt_labels(pairs)} {_fmt_num(rec['value'])}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def report(self) -> dict:
        """Machine-readable fleet summary (the bench/CI artifact)."""
        gauges: dict[str, list[float]] = {}
        for rec in self._proc_series:
            if rec["type"] == "gauge":
                gauges.setdefault(rec["name"], []).append(float(rec["value"]))
        gauge_rows = {
            name: {"min": min(v), "mean": sum(v) / len(v), "max": max(v),
                   "n": len(v)}
            for name, v in sorted(gauges.items())
        }
        # the memory ledger's fleet view: per-host headroom/unattributed/claimed merged min/mean/
        # max — gauges are NEVER summed (two hosts' headroom doesn't add),
        # so the min row is the fleet's binding chip and the max row its
        # roomiest. Keyed without the hbm_ prefix but WITH the series'
        # non-identity labels: pooling hbm_measured_bytes by bare name
        # would take a min over bytes_in_use readings and a max over
        # bytes_limit — cross-kind garbage. Empty when no process
        # exported ledger gauges.
        mem_vals: dict[str, list[float]] = {}
        for rec in self._proc_series:
            if rec["type"] != "gauge" or not rec["name"].startswith("hbm_"):
                continue
            extra = {k: v for k, v in rec["labels"].items()
                     if k not in IDENTITY_LABELS}
            key = rec["name"][len("hbm_"):]
            if extra:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(extra.items())) + "}"
            mem_vals.setdefault(key, []).append(float(rec["value"]))
        memory_rows = {
            key: {"min": min(v), "mean": sum(v) / len(v), "max": max(v),
                  "n": len(v)}
            for key, v in sorted(mem_vals.items())
        }
        return {
            "schema": "dsml.obs.cluster_report/1",
            "processes": self.processes,
            "n_series": len(self._proc_series),
            "fleet_goodput": self.fleet_goodput(),
            "stragglers": self.straggler_ranking(),
            "gauges": gauge_rows,
            "memory": memory_rows,
            "slo": self.slo_status(),
            "notes": self.notes,
        }


def validate_snapshot(snap) -> None:
    """Schema + shape check shared by every ingest path."""
    if not isinstance(snap, dict) or snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"not a cluster snapshot (schema="
            f"{snap.get('schema') if isinstance(snap, dict) else type(snap).__name__!r}; "
            f"expected {SNAPSHOT_SCHEMA!r})"
        )
    missing = {"host", "pid", "role", "wall_s", "mono_us", "metrics"} - set(snap)
    if missing:
        raise ValueError(f"cluster snapshot missing keys {sorted(missing)}")
    if not isinstance(snap["metrics"], list):
        raise ValueError("cluster snapshot 'metrics' must be a list")


def merge_snapshots(snaps: list[dict]) -> MergedView:
    view = MergedView()
    for s in snaps:
        view.add_snapshot(s)
    return view


# ---------------------------------------------------------------------------
# trace stitching
# ---------------------------------------------------------------------------


def stitch_traces(snaps: list[dict],
                  syncs: dict[int, ClockSync] | None = None) -> dict:
    """Merge per-process Chrome traces into one chrome-loadable timeline.

    Each process becomes one pid lane (named ``role host:pid`` via ``M``
    metadata events, coordinator lanes sorted first). Event timestamps are
    shifted onto a shared timeline by each snapshot's :class:`ClockSync`
    (``syncs`` keyed by snapshot index); snapshots without one fall back
    to the wall-clock offset against the FIRST snapshot. The merged
    timeline is re-zeroed so it starts near ts=0.
    """
    if not snaps:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    syncs = syncs or {}
    ref = snaps[0]
    events: list[dict] = []
    used_pids: set[int] = set()
    for i, snap in enumerate(snaps):
        sync = syncs.get(i)
        if sync is None:
            sync = (ClockSync(0.0, None, "identity") if snap is ref
                    else ClockSync.from_wall(snap, ref["wall_s"],
                                             ref["mono_us"]))
        # one lane per PROCESS: real pid when unique, else remapped (two
        # hosts can reuse a pid; chrome would fold their lanes together)
        pid = int(snap["pid"])
        while pid in used_pids:
            pid += 100_000
        used_pids.add(pid)
        role = str(snap["role"])
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{role} {snap['host']}:{snap['pid']}"},
        })
        events.append({
            "name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
            "args": {"sort_index": 0 if role == "coordinator" else i + 1},
        })
        for e in (snap.get("trace") or {}).get("traceEvents", []):
            events.append({**e, "pid": pid, "ts": e["ts"] + sync.offset_us})
    timed = [e for e in events if e["ph"] != "M"]
    t0 = min((e["ts"] for e in timed), default=0.0)
    for e in timed:
        e["ts"] -= t0
    timed.sort(key=lambda e: e["ts"])
    meta = [e for e in events if e["ph"] == "M"]
    return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}


def trace_summary(trace: dict) -> dict:
    """Per-request causal chains from a (stitched or single-process)
    Chrome trace: {trace_id: {pids, names, flow}} for every event tagged
    with a ``trace_id`` arg (request spans, instants, flow events —
    ``obs.spans.TraceContext`` propagation). ``flow`` counts the flow
    phases seen (``s``/``t``/``f``) — a fully linked request shows one
    start, ≥1 step, one end; ``pids`` is the set of process lanes the
    request's events landed in (the ≥3-process acceptance reads this)."""
    out: dict[str, dict] = {}
    for e in trace.get("traceEvents", []):
        tid = (e.get("args") or {}).get("trace_id")
        if not tid:
            continue
        row = out.setdefault(
            tid, {"pids": set(), "names": [], "flow": {}, "n_events": 0}
        )
        row["pids"].add(e.get("pid"))
        row["n_events"] += 1
        if e.get("ph") in ("s", "t", "f"):
            row["flow"][e["ph"]] = row["flow"].get(e["ph"], 0) + 1
        elif e.get("ph") in ("B", "i") and e.get("name") not in row["names"]:
            row["names"].append(e["name"])
    for row in out.values():
        row["pids"] = sorted(row["pids"])
    return out


# ---------------------------------------------------------------------------
# aggregator: scrape, merge, artifacts
# ---------------------------------------------------------------------------


class ClusterAggregator:
    """Collects snapshots from a fleet and produces the merged artifacts.

    Three ingest paths (mixable):

    - :meth:`scrape` — HTTP GET of a worker's ``/cluster.json``
      (``obs.start_metrics_server``), with the RTT-midpoint clock
      handshake measured around the request;
    - :meth:`pull` — the same over the wire's gRPC ObsPlane service
      (attached to every device server and coordinator);
    - :meth:`add` — a snapshot dict/file pushed or loaded offline
      (wall-clock alignment).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._snaps: list[dict] = []
        self._syncs: dict[int, ClockSync] = {}

    # -- ingest ------------------------------------------------------------

    def add(self, snap: dict, sync: ClockSync | None = None) -> None:
        """Raises ``ValueError`` on a malformed snapshot AT INGEST — one
        bad worker (version skew, a stray client) must cost one rejected
        snapshot, not blow up ``merged()``/``stitched_trace()`` at
        artifact-write time with every good snapshot's data."""
        validate_snapshot(snap)
        with self._lock:
            idx = len(self._snaps)
            self._snaps.append(snap)
            if sync is not None:
                self._syncs[idx] = sync

    def add_file(self, path: str) -> None:
        with open(path) as f:
            self.add(json.load(f))

    def scrape(self, base_url: str, timeout: float = 10.0) -> dict:
        """GET ``<base_url>/cluster.json`` with the clock handshake."""
        import urllib.request

        url = base_url.rstrip("/") + "/cluster.json"
        t0 = now_us()
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read()
        t1 = now_us()
        snap = json.loads(body)
        self.add(snap, ClockSync.from_handshake(t0, t1, snap["mono_us"]))
        return snap

    def pull(self, address: str, timeout: float = 10.0) -> dict:
        """ObsPlane.PullSnapshot over a gRPC channel (clock handshake
        measured around the RPC)."""
        import grpc

        from dsml_tpu_torch.comm import rpc as comm_rpc

        channel = grpc.insecure_channel(address)
        try:
            stub = comm_rpc.obs_stub(channel)
            t0 = now_us()
            body = stub.PullSnapshot(b"{}", timeout=timeout)
            t1 = now_us()
        finally:
            channel.close()
        snap = json.loads(body)
        self.add(snap, ClockSync.from_handshake(t0, t1, snap["mono_us"]))
        return snap

    # -- outputs -----------------------------------------------------------

    def merged(self) -> MergedView:
        with self._lock:
            snaps = list(self._snaps)
        return merge_snapshots(snaps)

    def stitched_trace(self) -> dict:
        with self._lock:
            snaps, syncs = list(self._snaps), dict(self._syncs)
        return stitch_traces(snaps, syncs)

    def to_prometheus_text(self) -> str:
        return self.merged().to_prometheus_text()

    def report(self) -> dict:
        rep = self.merged().report()
        with self._lock:
            rep["clock_sync"] = {
                i: {"offset_us": round(s.offset_us, 3),
                    "rtt_us": None if s.rtt_us is None else round(s.rtt_us, 3),
                    "method": s.method}
                for i, s in self._syncs.items()
            }
        return rep

    def write_artifacts(self, out_dir: str) -> dict:
        """Write the merged exposition, stitched trace, and report; returns
        the paths (the CI/bench artifact set)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "prometheus": os.path.join(out_dir, "cluster_metrics.prom"),
            "trace": os.path.join(out_dir, "cluster_trace.json"),
            "report": os.path.join(out_dir, "cluster_report.json"),
        }
        with open(paths["prometheus"], "w") as f:
            f.write(self.to_prometheus_text())
        with open(paths["trace"], "w") as f:
            json.dump(self.stitched_trace(), f)
        with open(paths["report"], "w") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
        return paths


# ---------------------------------------------------------------------------
# worker side: the ObsPlane gRPC servicer + aggregator push
# ---------------------------------------------------------------------------


class ObsServicer:
    """Worker-side ObsPlane: serves this process's snapshot over the
    grpc.Server the worker already runs for its gpu_sim service (attach
    with ``rpc.add_obs_servicer``). Raw-JSON payloads."""

    def __init__(self, role: str, registry: Registry | None = None, tracer=None):
        self.role = role
        self._registry = registry
        self._tracer = tracer

    def PullSnapshot(self, request: bytes, context) -> bytes:  # noqa: N802
        opts = json.loads(request or b"{}")
        snap = snapshot(role=self.role, registry=self._registry, tracer=self._tracer,
                        with_trace=bool(opts.get("trace", True)))
        return json.dumps(snap).encode()

    def PushSnapshot(self, request: bytes, context) -> bytes:  # noqa: N802
        import grpc

        context.abort(grpc.StatusCode.UNIMPLEMENTED,
                      "this ObsPlane endpoint only serves PullSnapshot")


class AggregatorServicer:
    """Aggregator-side ObsPlane: accepts worker pushes."""

    def __init__(self, aggregator: ClusterAggregator):
        self.aggregator = aggregator

    def PushSnapshot(self, request: bytes, context) -> bytes:  # noqa: N802
        import grpc

        try:
            snap = json.loads(request)
        except ValueError:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "PushSnapshot payload is not JSON")
        try:
            # a push has no handshake (the worker cannot read our clock):
            # wall alignment happens at stitch time
            self.aggregator.add(snap)
        except ValueError as e:
            # reject THIS push; never poison the aggregator's artifact run
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return json.dumps({"ok": True, "agg_mono_us": now_us()}).encode()

    def PullSnapshot(self, request: bytes, context) -> bytes:  # noqa: N802
        import grpc

        context.abort(grpc.StatusCode.UNIMPLEMENTED, "aggregators accept PushSnapshot only")


def serve_aggregator(aggregator: ClusterAggregator, port: int = 0, host: str = "127.0.0.1"):
    """Boot a standalone aggregator endpoint workers can push to. Returns a
    handle with ``.address`` and ``.stop()``."""
    from concurrent import futures as _futures

    import grpc

    from dsml_tpu_torch.comm import rpc as comm_rpc

    server = grpc.server(_futures.ThreadPoolExecutor(max_workers=4))
    comm_rpc.add_obs_servicer(AggregatorServicer(aggregator), server)
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()

    class _Handle:
        address = f"{host}:{bound}"

        @staticmethod
        def stop(grace: float = 0.2) -> None:
            server.stop(grace)

    return _Handle()


def push_snapshot(address: str, role: str | None = None, registry: Registry | None = None,
                  with_trace: bool = True, timeout: float = 10.0) -> dict:
    """Worker → aggregator push over the wire's plumbing: one shot, returns
    the aggregator's ack (for workers the aggregator cannot scrape)."""
    import grpc

    from dsml_tpu_torch.comm import rpc as comm_rpc

    snap = snapshot(role=role, registry=registry, with_trace=with_trace)
    channel = grpc.insecure_channel(address)
    try:
        ack = comm_rpc.obs_stub(channel).PushSnapshot(json.dumps(snap).encode(), timeout=timeout)
    finally:
        channel.close()
    return json.loads(ack)


# ---------------------------------------------------------------------------
# demo CLI: the multi-process proof
# ---------------------------------------------------------------------------

_DEMO_WORKER_FLAG = "--serve-one-device"


def _demo_worker_main(device_id: int, device: str | None) -> None:
    """Subprocess body: one device server with obs on and the ObsPlane
    attached; prints its address as a JSON line, then serves until stdin
    closes."""
    import sys

    from dsml_tpu_torch import obs
    from dsml_tpu_torch.comm.device_server import serve_device

    obs.enable(forensics=False)
    handle = serve_device(device_id, mem_size=0x100000, device=device)
    print(json.dumps({"address": handle.address, "pid": os.getpid()}), flush=True)
    sys.stdin.read()  # the parent closes the pipe → exit
    handle.stop()


def run_cluster_demo(out_dir: str, n_devices: int = 2, payload_floats: int = 1024,
                     device: str | None = None) -> dict:
    """The coordinator (this process) and ``n_devices`` device-server
    subprocesses on ``device`` (the card by default): one all-reduce over
    the wire, then every process scraped over the ObsPlane, and the merged
    exposition, stitched trace and report written into ``out_dir``.
    Returns the report with the artifact paths attached."""
    import subprocess
    import sys

    import numpy as np

    from dsml_tpu_torch import obs
    from dsml_tpu_torch.comm.coordinator import CoordinatorConfig, serve_coordinator

    obs.enable(forensics=False)
    env = {**os.environ, "DSML_OBS": "1", "DSML_OBS_ROLE": "device_server"}
    cmd = [sys.executable, "-m", "dsml_tpu_torch.obs.cluster"]
    if device is not None:
        cmd += ["--device", str(device)]
    procs, addrs = [], []
    try:
        for i in range(n_devices):
            procs.append(subprocess.Popen([*cmd, _DEMO_WORKER_FLAG, str(i + 1)],
                                          stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                          env=env, text=True))
        for p in procs:
            addrs.append(json.loads(p.stdout.readline())["address"])
        coordinator = serve_coordinator(
            config=CoordinatorConfig(health_interval_s=0.5, probe_timeout_s=2.0))
        try:
            rt = coordinator.runtime
            comm = rt.comm_init(n_devices, addrs)
            data = np.arange(payload_floats, dtype=np.float32)
            for info in comm.devices:
                rt.memcpy_h2d(info.device_id, 0x1000, data.tobytes())
            rt.all_reduce_ring(comm.comm_id, data.nbytes, dtype="float32")
            agg = ClusterAggregator()
            agg.add(snapshot(role="coordinator"), ClockSync(0.0, 0.0, "identity"))
            for addr in addrs:
                agg.pull(addr)
            paths = agg.write_artifacts(out_dir)
            report = agg.report()
            report["artifacts"] = paths
            report["n_processes"] = 1 + n_devices
            return report
        finally:
            coordinator.stop()
    finally:
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m dsml_tpu_torch.obs.cluster",
        description="cluster obs demo: merged exposition + stitched trace of 3 processes")
    ap.add_argument("--demo", metavar="OUT_DIR",
                    help="run the coordinator + 2 device-server subprocesses, write merged "
                    "artifacts into OUT_DIR")
    ap.add_argument("--device", default=None,
                    help="the device servers' torch device (default: the card)")
    ap.add_argument(_DEMO_WORKER_FLAG, type=int, default=None, metavar="DEVICE_ID",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve_one_device is not None:
        _demo_worker_main(args.serve_one_device, args.device)
        return 0
    if not args.demo:
        ap.print_help()
        return 2
    report = run_cluster_demo(args.demo, device=args.device)
    print(json.dumps({k: report[k] for k in ("n_processes", "n_series", "artifacts", "notes")},
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
