"""Process-wide metrics registry: counters, gauges, histograms — the
port's copy of ``dsml_tpu/obs/registry.py`` (pure Python).

One thread-safe registry per process, metrics labeled by collective
algorithm / bucket index / mesh axis / serving replica, with JSONL and
Prometheus-text exposition. The port's default registry is its own
process global, separate from the JAX package's: a process that imports
both has two.

Zero-overhead-by-default contract: the registry starts DISABLED unless
``DSML_OBS`` is set truthy; every write op early-returns on a single
attribute check, so instrumented hot paths cost one branch when off.
Enabling is a runtime switch (:func:`enable`) — no re-wiring, the same
metric objects go live.

Histograms use FIXED bucket bounds (cumulative, Prometheus-style) plus a
bounded raw-sample tail for p50/p90 summaries; both expositions are
generated from the same snapshot, so the two formats cannot drift.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
import weakref

__all__ = [
    "ObsUnavailable",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "enable",
    "disable",
    "enabled",
    "DEFAULT_LATENCY_BUCKETS_MS",
]


class ObsUnavailable(RuntimeError):
    """An observability backend (the HTTP exporter) is unavailable in
    this environment. The message always carries
    remediation text — callers surface it verbatim instead of an opaque
    backend traceback."""


# ms-scale latency bounds: sub-ms collectives through multi-second compiles.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# raw-sample tail per labeled histogram series, for p50/p90 summaries
# (bounded so a long run cannot grow host memory without bound)
_SAMPLE_CAP = 4096


def _label_key(label_names: tuple, labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared {sorted(label_names)}"
        )
    return tuple(str(labels[n]) for n in label_names)


class _Metric:
    """Shared base: a named family of labeled series."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str,
                 label_names: tuple):
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _items(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return list(self._series.items())


class _BoundCounter:
    """One labeled counter series with the label key resolved ONCE —
    the fast path for per-request hot paths (``Counter.bind``): an inc
    costs the enabled branch + one lock, no per-call label validation."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: "Counter", key: tuple):
        self._counter = counter
        self._key = key

    def inc(self, value: float = 1.0) -> None:
        c = self._counter
        if not c._registry._enabled:
            return
        with c._lock:
            c._series[self._key] = c._series.get(self._key, 0.0) + value


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, errors)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not self._registry._enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {value}")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def bind(self, **labels) -> _BoundCounter:
        """Pre-resolve a label set (validated HERE, once) into a bound
        series handle whose ``inc`` skips per-call label work."""
        return _BoundCounter(self, _label_key(self.label_names, labels))

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(self.label_names, labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value (queue depth, slot occupancy, goodput)."""

    kind = "gauge"

    def clear(self) -> None:
        """Drop every labeled series. For scrape-time re-derived gauges
        whose LABEL SETS change between scrapes (the memory ledger's
        per-subsystem claims, its provenance flag): without a clear, a
        series whose source died — or whose provenance flipped — would
        freeze at its last value in every later exposition."""
        with self._lock:
            self._series.clear()

    def set(self, value: float, **labels) -> None:
        if not self._registry._enabled:
            return
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels) -> float | None:
        with self._lock:
            v = self._series.get(_label_key(self.label_names, labels))
        return None if v is None else float(v)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "samples", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = the +Inf overflow bucket
        self.sum = 0.0
        self.count = 0
        self.samples = collections.deque(maxlen=_SAMPLE_CAP)
        # bucket index -> {"value", "trace_id", "time"}: the LAST traced
        # sample that landed in each bucket. One dict per bucket (not a
        # tail list) bounds memory while guaranteeing the interesting
        # property: a tail bucket's count always resolves to a concrete
        # trace_id — "what request WAS that p99?" has an answer
        self.exemplars: dict[int, dict] = {}


class Histogram(_Metric):
    """Fixed-bound histogram with a bounded raw tail for percentiles."""

    kind = "histogram"

    def __init__(self, registry, name, help, label_names,
                 buckets: tuple | None = None):
        super().__init__(registry, name, help, label_names)
        bounds = tuple(sorted(
            float(b) for b in (buckets if buckets is not None
                               else DEFAULT_LATENCY_BUCKETS_MS)
        ))
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket bound")
        self.buckets = bounds

    def observe(self, value: float, exemplar: str | None = None,
                **labels) -> None:
        """``exemplar`` (a trace_id) attaches the sample's request identity
        to the bucket it lands in (last-wins per bucket) — the link from a
        tail-latency number to the distributed trace that produced it,
        exposed through ``collect()``/JSONL/``/metrics.json``."""
        if not self._registry._enabled:
            return
        value = float(value)
        key = _label_key(self.label_names, labels)
        idx = bisect.bisect_left(self.buckets, value)  # first bound >= value
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets))
            series.counts[idx] += 1
            series.sum += value
            series.count += 1
            series.samples.append(value)
            if exemplar is not None:
                series.exemplars[idx] = {
                    "value": value, "trace_id": str(exemplar),
                    "time": time.time(),
                }

    def summary(self, **labels) -> dict:
        """count / sum / mean / p50 / p90 over the (bounded) raw tail."""
        with self._lock:
            series = self._series.get(_label_key(self.label_names, labels))
            if series is None or not series.count:
                return {"count": 0}
            samples = sorted(series.samples)
            total, count = series.sum, series.count

        def pct(q: float) -> float:
            return samples[min(int(q * len(samples)), len(samples) - 1)]

        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6),
            "p50": round(pct(0.50), 6),
            "p90": round(pct(0.90), 6),
            "p99": round(pct(0.99), 6),
        }


class Registry:
    """Thread-safe metric namespace. ``get_registry()`` returns the
    process-wide default; tests/benches may hold private instances."""

    def __init__(self, enabled: bool = False):
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collect_hooks: list = []  # weakrefs, pruned on collect

    # -- lifecycle ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Drop every metric (tests; a fresh bench section)."""
        with self._lock:
            self._metrics.clear()

    # -- metric constructors (get-or-create) -------------------------------

    def _get(self, cls, name: str, help: str, labels: tuple, **kw) -> _Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(self, name, help, tuple(labels), **kw)
                return metric
        if type(metric) is not cls or metric.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {metric.kind} with "
                f"labels {metric.label_names}"
            )
        # EXPLICIT bucket bounds must match the registered histogram's —
        # silently reusing the first registration's bounds would pile, e.g.,
        # occupancy ratios into a ms-latency ladder. Omitting buckets
        # (buckets=None) always fetches, whatever the bounds.
        want = kw.get("buckets")
        if want is not None and metric.buckets != tuple(sorted(float(b) for b in want)):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{metric.buckets}"
            )
        return metric

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple | None = None) -> Histogram:
        """``buckets=None`` = the default ms-latency ladder when creating,
        and no-bounds-check when fetching an existing histogram."""
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- exposition --------------------------------------------------------

    def add_collect_hook(self, fn) -> None:
        """Register ``fn`` to run at the top of every exposition
        (``collect``/``to_prometheus_text``). For owners of DERIVED
        point-in-time gauges (the memory ledger's reconciliation, a paged
        batcher's pool occupancy) whose value depends on live state, not
        on writes: without a scrape-time refresh, a gauge last exported
        during a burst would FREEZE at that value once traffic stops.
        Held by weak reference: the hook dies with its owner (no
        unregister needed, no cross-test leaks)."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._collect_hooks.append(ref)

    def _run_collect_hooks(self) -> None:
        with self._lock:
            refs = list(self._collect_hooks)
        dead = [r for r in refs if r() is None]
        for r in refs:
            fn = r()
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass  # a broken refresher must not break exposition
        if dead:
            with self._lock:
                self._collect_hooks = [
                    r for r in self._collect_hooks if r not in dead
                ]

    def collect(self) -> list[dict]:
        """Point-in-time snapshot: one record per labeled series."""
        self._run_collect_hooks()
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in metrics:
            for key, series in m._items():
                labels = dict(zip(m.label_names, key))
                if isinstance(m, Histogram):
                    cumulative, running = {}, 0
                    for bound, c in zip(m.buckets, series.counts):
                        running += c
                        cumulative[str(bound)] = running
                    cumulative["+Inf"] = running + series.counts[-1]
                    rec = {
                        "name": m.name, "type": m.kind, "labels": labels,
                        "buckets": cumulative,
                        "sum": series.sum, "count": series.count,
                        "summary": m.summary(**labels),
                    }
                    if series.exemplars:
                        # snapshot under the metric lock: observe() inserts
                        # new bucket keys concurrently, and iterating a
                        # live dict across a resize raises RuntimeError
                        # (the unlocked counts/sum reads are torn-read-
                        # benign; a dict iteration is not)
                        with m._lock:
                            ex_items = sorted(series.exemplars.items())
                        # keyed by bucket BOUND (the exposition's own
                        # vocabulary), not internal index
                        rec["exemplars"] = {
                            ("+Inf" if i == len(m.buckets)
                             else str(m.buckets[i])): dict(ex)
                            for i, ex in ex_items
                        }
                    out.append(rec)
                else:
                    out.append({
                        "name": m.name, "type": m.kind, "labels": labels,
                        "value": series,
                    })
        return out

    def to_jsonl(self) -> str:
        """One JSON record per labeled series, timestamped."""
        now = time.time()
        return "\n".join(
            json.dumps({"time": now, **rec}) for rec in self.collect()
        )

    def dump_jsonl(self, path: str) -> None:
        text = self.to_jsonl()
        if text:
            with open(path, "a") as f:
                f.write(text + "\n")

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._run_collect_hooks()
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            items = m._items()
            if not items:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, series in items:
                pairs = dict(zip(m.label_names, key))
                if isinstance(m, Histogram):
                    running = 0
                    for bound, c in zip(m.buckets, series.counts):
                        running += c
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels({**pairs, 'le': bound})} {running}"
                        )
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels({**pairs, 'le': '+Inf'})} "
                        f"{series.count}"
                    )
                    lines.append(f"{m.name}_sum{_fmt_labels(pairs)} {_fmt_num(series.sum)}")
                    lines.append(f"{m.name}_count{_fmt_labels(pairs)} {series.count}")
                else:
                    lines.append(f"{m.name}{_fmt_labels(pairs)} {_fmt_num(series)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_labels(pairs: dict) -> str:
    if not pairs:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(pairs.items())
    )
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


_default = Registry(
    enabled=os.environ.get("DSML_OBS", "").lower() not in ("", "0", "false", "off")
)


def get_registry() -> Registry:
    return _default


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


def enabled() -> bool:
    return _default.enabled
