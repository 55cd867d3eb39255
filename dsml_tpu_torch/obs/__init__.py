"""dsml_tpu_torch.obs — observability of the port: metrics, spans, step
stats, failure forensics, the device-memory ledger, SLO budgets and the
fleet's cluster plane; the counterpart of ``dsml_tpu/obs`` (its bench
regression gate, ``obs/regress.py``, comes with the port's bench,
ROADMAP.md queue 1, item 16).

- :mod:`~dsml_tpu_torch.obs.registry` — process-wide thread-safe metrics
  registry (counters / gauges / fixed-bound histograms, labeled), JSONL +
  Prometheus-text exposition. DISABLED by default (``DSML_OBS=1`` or
  :func:`enable` turns it on); disabled writes cost one branch. The
  port's registry is its own process global, apart from the JAX one.
- :mod:`~dsml_tpu_torch.obs.spans` — nestable host-side span tracer whose
  ``fence=`` synchronises the CUDA streams of its tensors, Chrome
  trace-event JSON export, per-span p50/p90 summaries; request-scoped
  :class:`TraceContext`.
- :mod:`~dsml_tpu_torch.obs.step_stats` — per-step phase breakdown,
  goodput (productive ÷ wall), MFU.
- :mod:`~dsml_tpu_torch.obs.export` — rotation-safe JSONL sink
  (:class:`MetricsLogger`) + opt-in HTTP ``/metrics`` endpoint (with
  ``/metrics.json`` and ``/cluster.json``).

The serving fleet:

- :mod:`~dsml_tpu_torch.obs.slo` — per-SLO-class SLI windows, rolling
  error budgets with multi-window (fast/slow) burn-rate status, goodput
  and p99 tail attribution by stage (the router's ``Router.slo``).
- :mod:`~dsml_tpu_torch.obs.cluster` — cross-process aggregation:
  identity-stamped snapshots, exact-sum counter and bucket-wise
  histogram merge into one exposition, fleet goodput, stragglers and SLO
  status, and Chrome traces stitched into one timeline
  (:class:`ClusterAggregator`, :func:`snapshot`, :func:`stitch_traces`).

Failure forensics:

- :mod:`~dsml_tpu_torch.obs.flight_recorder` — bounded ring of recent
  structured events; dumps a self-contained postmortem bundle on
  unhandled exception, SIGTERM, or on demand. A dump never initialises
  CUDA.
- :mod:`~dsml_tpu_torch.obs.sentinels` — NaN/Inf-loss, grad-norm and
  loss-spike sentinels with per-sentinel ``warn``/``dump``/``halt``
  policies (``DSML_SENTINELS``), checked at the trainer's existing loss
  sync.
- :mod:`~dsml_tpu_torch.obs.hangwatch` — armable deadline watchdog
  (``DSML_HANGWATCH``): the trainer arms one per loss-sync window.

Memory ledger:

- :mod:`~dsml_tpu_torch.obs.memory` — per-subsystem device-byte
  attribution (:class:`MemoryLedger`) reconciled against
  ``torch.cuda.memory_stats`` at scrape time (the key mapping is in that
  module's docstring), with an ``hbm_unattributed_bytes`` residual and
  explicit provenance (``hbm_source``).

Metric names, label sets and the span taxonomy are the JAX package's
(``docs/OBSERVABILITY.md``).
"""

from __future__ import annotations

from dsml_tpu_torch.obs import flight_recorder, hangwatch, sentinels  # noqa: F401
from dsml_tpu_torch.obs.export import (  # noqa: F401
    MetricsLogger,
    MetricsServer,
    start_metrics_server,
)
from dsml_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    get_flight_recorder,
)
from dsml_tpu_torch.obs.hangwatch import HangWatch, TrailingDeadline, get_hangwatch  # noqa: F401
from dsml_tpu_torch.obs.memory import (  # noqa: F401
    MemoryLedger,
    get_memory_ledger,
)
from dsml_tpu_torch.obs.registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    ObsUnavailable,
    Registry,
    enabled,
    get_registry,
)
from dsml_tpu_torch.obs.registry import disable as _registry_disable
from dsml_tpu_torch.obs.registry import enable as _registry_enable
from dsml_tpu_torch.obs.sentinels import (  # noqa: F401
    SentinelConfig,
    SentinelTripped,
    TrainingSentinels,
)
from dsml_tpu_torch.obs.spans import (  # noqa: F401
    SpanTracer,
    TraceContext,
    get_tracer,
    span,
)
from dsml_tpu_torch.obs.step_stats import (  # noqa: F401
    STEP_PHASES,
    GoodputTracker,
    StepBreakdown,
    mfu,
)

__all__ = [
    "Registry", "Counter", "Gauge", "Histogram", "ObsUnavailable",
    "get_registry", "enable", "disable", "enabled",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "SpanTracer", "TraceContext", "span", "get_tracer",
    "StepBreakdown", "GoodputTracker", "mfu", "STEP_PHASES",
    "MetricsLogger", "MetricsServer", "start_metrics_server",
    "record_collective_plan", "observe_collective_latency_ms",
    "observe_recovery_ms", "record_quant_sync_bytes",
    "FlightRecorder", "get_flight_recorder", "dump_postmortem",
    "MemoryLedger", "get_memory_ledger",
    "SentinelConfig", "SentinelTripped", "TrainingSentinels",
    "HangWatch", "TrailingDeadline", "get_hangwatch",
    "ClockSync", "ClusterAggregator", "merge_snapshots", "snapshot",
    "stitch_traces", "trace_summary",
]

# cluster-plane names resolve lazily (PEP 562), as in the JAX package
_CLUSTER_NAMES = ("ClockSync", "ClusterAggregator", "merge_snapshots",
                  "snapshot", "stitch_traces", "trace_summary")


def __getattr__(name: str):
    if name in _CLUSTER_NAMES:
        from dsml_tpu_torch.obs import cluster as _cluster

        return getattr(_cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enable(forensics: bool = True) -> None:
    """Turn observability on: flip the default registry live and (unless
    ``forensics=False``) install the failure-forensics layer — the
    flight-recorder crash hooks (``sys.excepthook`` / SIGTERM /
    ``faulthandler``) and the ring-buffer log handler whose tail rides in
    every postmortem bundle. ``disable()`` tears all of it down."""
    _registry_enable()
    if forensics:
        from dsml_tpu_torch.utils.logging import install_ring_handler

        install_ring_handler()
        flight_recorder.install()


def disable() -> None:
    """Turn observability off and tear down the forensics hooks installed
    by :func:`enable` (prior excepthook/signal/faulthandler dispositions
    are restored)."""
    from dsml_tpu_torch.utils.logging import uninstall_ring_handler

    flight_recorder.uninstall()
    uninstall_ring_handler()
    _registry_disable()


def dump_postmortem(reason: str = "on_demand",
                    directory: str | None = None) -> str:
    """Write a postmortem bundle NOW (works even with the registry
    disabled); returns the bundle directory."""
    return get_flight_recorder().dump(reason, directory=directory)


def record_collective_plan(algorithm: str, tree, bucket_size_mb,
                           axis: str = "dp",
                           registry: Registry | None = None) -> None:
    """Record a gradient-sync bucket plan's shape (bucket count, per-bucket
    and total bytes) labeled by collective algorithm + mesh axis.

    The JAX steps call it while tracing, once per compilation.
    The port has no compile: the dp and hybrid steps call it on the first
    step of each new batch signature (shape and dtype), where jit's cache
    would trace, so ``collective_sync_compiles_total`` counts what the JAX
    package counts — never steps. ``bucket_size_mb=None`` records ONE
    bucket of the tree's total bytes (the single-buffer sync; raw tensor
    bytes). Callers whose ``None`` means per-dtype buckets resolve it to
    ``float("inf")`` first."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    if bucket_size_mb is None:
        from dsml_tpu_torch.obs.memory import tree_nbytes

        sizes = [tree_nbytes(tree)]
        n_buckets = 1
    else:
        from dsml_tpu_torch.parallel.bucketing import plan_buckets

        plan = plan_buckets(tree, bucket_size_mb)
        sizes = [plan.bucket_nbytes(b) for b in range(plan.n_buckets)]
        n_buckets = plan.n_buckets
    labels = {"algorithm": algorithm, "axis": axis}
    reg.counter(
        "collective_sync_compiles_total",
        "gradient-sync step compilations", labels=("algorithm", "axis"),
    ).inc(**labels)
    reg.gauge(
        "collective_sync_buckets",
        "buckets per gradient sync", labels=("algorithm", "axis"),
    ).set(n_buckets, **labels)
    reg.gauge(
        "collective_sync_bytes",
        "total gradient bytes per sync", labels=("algorithm", "axis"),
    ).set(sum(sizes), **labels)
    hist = reg.histogram(
        "collective_bucket_bytes",
        "per-bucket payload bytes", labels=("algorithm", "axis"),
        buckets=(1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 28),
    )
    for nbytes in sizes:
        hist.observe(nbytes, **labels)
    # one trace-time event per compile: a postmortem shows WHICH sync plan
    # (algorithm / bucket count / payload) the dying step was running.
    # Default-registry callers only — a private registry (test isolation)
    # must not leak its plans into the process-global ring
    if reg is get_registry():
        flight_recorder.record(
            "collective_plan", algorithm=algorithm, axis=axis,
            buckets=n_buckets, bytes=int(sum(sizes)),
        )


def record_quant_sync_bytes(bytes_by_scheme: dict, algorithm: str,
                            axis: str = "dp",
                            registry: Registry | None = None) -> None:
    """One quantized gradient sync's wire bytes →
    ``collective_quant_bytes_total{scheme,algorithm,axis}``.

    ``bytes_by_scheme`` is the ANALYTIC per-sync byte count from
    ``parallel.bucketing.plan_quant_wire_bytes`` (static shapes ⇒ exact).
    The dp step calls this once per quantized step — a dict walk and one
    no-op-able counter write, never a device sync — so the counter is a
    true cumulative total, unlike the plan gauges, which record once per
    batch signature."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled or not bytes_by_scheme:
        return
    c = reg.counter(
        "collective_quant_bytes_total",
        "wire bytes shipped by quantized gradient syncs (analytic per-sync "
        "count; fp32 rows are the uncompressed buckets riding along)",
        labels=("scheme", "algorithm", "axis"),
    )
    for scheme, nbytes in bytes_by_scheme.items():
        c.inc(nbytes, scheme=scheme, algorithm=algorithm, axis=axis)


def observe_recovery_ms(stage: str, ms: float,
                        registry: Registry | None = None) -> None:
    """One elastic-recovery latency sample →
    ``controller_recovery_ms{stage}`` (stages: ``reconfigure`` /
    ``checkpoint_fallback`` / ``grow_keep`` / ``grow_replay``), fed by
    ``runtime.controller.ElasticController`` after every recovery."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    reg.histogram(
        "controller_recovery_ms",
        "elastic-controller recovery latency", labels=("stage",),
    ).observe(ms, stage=stage)


def observe_collective_latency_ms(algorithm: str, ms: float,
                                  payload_bytes: int | None = None,
                                  axis: str = "dp",
                                  registry: Registry | None = None) -> None:
    """One measured collective latency sample →
    ``collective_latency_ms{algorithm,axis}`` (the per-algorithm
    accounting surface; in the JAX package ``utils.tracing.
    ring_latency_ms`` feeds it, ROADMAP.md queue 1, item 15)."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    reg.histogram(
        "collective_latency_ms",
        "measured all-reduce latency", labels=("algorithm", "axis"),
    ).observe(ms, algorithm=algorithm, axis=axis)
    if payload_bytes is not None:
        reg.counter(
            "collective_latency_sampled_bytes_total",
            "payload bytes of measured collectives", labels=("algorithm", "axis"),
        ).inc(payload_bytes, algorithm=algorithm, axis=axis)
