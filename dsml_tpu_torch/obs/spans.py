"""Nestable span tracing with Chrome trace-event export — the port of
``dsml_tpu/obs/spans.py``.

Cheap, dependency-free host-side wall-clock intervals around the phases a
training/serving loop schedules (data fetch, step launch, grad sync, a
serving tick). Spans nest through a thread-local stack, optionally FENCE
on device values before closing (``fence=`` a tensor or a tree of them:
the current stream of each CUDA tensor's device is synchronised, where
the JAX tracer calls ``jax.block_until_ready``, so a span around launched
work measures execution, not launch), and export two ways:

- :meth:`SpanTracer.chrome_trace` — Chrome trace-event JSON (duration
  ``B``/``E`` pairs, microsecond ``ts``), loadable in ``chrome://tracing``
  / Perfetto;
- :meth:`SpanTracer.summaries` — per-span-name count/p50/p90 (ms),
  backed by the registry histogram ``span_ms{name=...}``.

Disabled-registry runs pay one branch per span and record nothing; the
fence runs only when the registry is enabled, so a disabled span adds no
stream synchronisation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import random
import threading
import time

import torch

from dsml_tpu_torch.obs import flight_recorder
from dsml_tpu_torch.obs.memory import tensor_leaves
from dsml_tpu_torch.obs.registry import Registry, get_registry

__all__ = ["SpanTracer", "TraceContext", "span", "get_tracer", "synchronize"]

# cap on retained trace events (B+E pairs): a week-long run must not grow
# host memory; the newest events win because the deque drops oldest first
_EVENT_CAP = 200_000

_trace_seq = itertools.count()
# minting runs on the serving submit path: a PRNG seeded once from the
# OS (not per-call urandom) keeps the per-request bill in the low-µs
_trace_rng = random.Random(os.urandom(8))

# os.getpid() is a real syscall (µs-scale under some kernels) and
# every trace event stamps a pid — cache it, refreshed in fork children
# so forked workers still stamp their own lane
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):  # POSIX
    os.register_at_fork(after_in_child=_refresh_pid)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Request-scoped trace identity, minted once (at ``Router.submit``)
    and propagated through every stage a request touches — prefill
    dispatch, the handoff codec/donor headers, decode injection, retire/
    requeue. ``trace_id`` is the request's globally unique identity;
    ``span_id`` names the PARENT span at the propagation point so a child
    process can record causality, not just membership.

    The context is plain data (two strings) so it serializes into any
    header dict (:meth:`to_header`/:meth:`from_header`) and costs nothing
    when observability is off — span/flow emission is gated separately by
    the registry switch."""

    trace_id: str
    span_id: str = ""

    @classmethod
    def mint(cls, span_id: str = "") -> "TraceContext":
        # pid + process-local sequence + random tail: unique across a
        # fleet of routers without coordination, stable length, greppable
        seq = next(_trace_seq)
        return cls(
            trace_id=f"{_PID:x}-{seq:x}-"
                     f"{_trace_rng.getrandbits(48):012x}",
            span_id=span_id,
        )

    def child(self, span_id: str) -> "TraceContext":
        """Same trace, new parent span — what a stage hands downstream."""
        return TraceContext(trace_id=self.trace_id, span_id=span_id)

    @property
    def flow_id(self) -> int:
        """Stable 48-bit Chrome flow-event id derived from the trace_id:
        every process that carries this context emits flow events under
        the SAME id, so the stitched timeline links the request's spans
        across pid lanes without any id negotiation. Memoized per
        instance (frozen dataclass — the memo rides ``__dict__`` via
        ``object.__setattr__``): flows are emitted per request hop."""
        cached = self.__dict__.get("_flow_id")
        if cached is None:
            digest = hashlib.blake2b(self.trace_id.encode(), digest_size=6)
            cached = int.from_bytes(digest.digest(), "big")
            object.__setattr__(self, "_flow_id", cached)
        return cached

    @property
    def flow_id_hex(self) -> str:
        cached = self.__dict__.get("_flow_id_hex")
        if cached is None:
            cached = f"{self.flow_id:x}"
            object.__setattr__(self, "_flow_id_hex", cached)
        return cached

    def to_header(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_header(cls, header) -> "TraceContext | None":
        if not header or not header.get("trace_id"):
            return None
        return cls(trace_id=str(header["trace_id"]),
                   span_id=str(header.get("span_id", "")))


def synchronize(tree) -> None:
    """Wait for the device work behind ``tree`` (a tensor or a tree of
    them, :func:`~dsml_tpu_torch.obs.memory.tensor_leaves`): synchronise
    the current stream of each CUDA tensor's device, once a device. CPU
    tensors are computed already; nothing to wait for."""
    for device in {t.device for t in tensor_leaves(tree) if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()


def _arg_value(v):
    """Span-arg codec: int/float stay NUMERIC so Chrome viewers and the
    stitcher can sort/aggregate on them; everything else (trace ids
    included) stringifies. bool is an int subclass — keep it readable."""
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, (int, float)):
        return v
    return str(v)


class SpanTracer:
    """Collects spans into trace events + a per-name latency histogram."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._hist = self.registry.histogram(
            "span_ms", "host-side span durations", labels=("name",)
        )

    # perf_counter is monotonic and sub-µs; one common origin per tracer so
    # every event's ts is comparable
    _t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, fence=None, **args):
        """Trace ``name`` around the block. ``fence``: a tensor or tree of
        them whose devices' streams are synchronised before the span closes
        (:func:`synchronize`: measure execution, not launch). Extra kwargs
        land in the event's ``args``. Nesting is carried by B/E event order
        per thread, matching Chrome's duration-event semantics."""
        if not self.registry.enabled:
            yield self
            return
        tid = threading.get_ident()
        begin = {
            "name": name, "ph": "B", "ts": self._now_us(),
            "pid": _PID, "tid": tid,
        }
        if args:
            begin["args"] = {k: _arg_value(v) for k, v in args.items()}
        with self._lock:
            self._append(begin)
        try:
            yield self
        finally:
            if fence is not None:
                synchronize(fence)
            end_ts = self._now_us()
            with self._lock:
                self._append({"name": name, "ph": "E", "ts": end_ts,
                              "pid": _PID, "tid": tid})
            ms = (end_ts - begin["ts"]) / 1e3
            self._hist.observe(ms, name=name)
            # span closes ride in the flight-recorder ring, so a postmortem
            # shows what phases ran right before the failure — but only for
            # tracers on the DEFAULT registry: a private tracer (bench/test
            # isolation) must not interleave into the process-global ring
            if self.registry is get_registry():
                flight_recorder.record("span", name=name, ms=round(ms, 3))

    def instant(self, name: str, **args) -> None:
        """One zero-duration instant event (Chrome ``ph="i"``) — the
        retire/abandon/requeue lifecycle marks request tracing rides on."""
        if not self.registry.enabled:
            return
        event = {"name": name, "ph": "i", "s": "t",
                 "ts": self._now_us(), "pid": _PID,
                 "tid": threading.get_ident()}
        if args:
            event["args"] = {k: _arg_value(v) for k, v in args.items()}
        with self._lock:
            self._append(event)

    _FLOW_PH = {"start": "s", "step": "t", "end": "f"}

    def flow(self, name: str, ctx: "TraceContext", phase: str = "step",
             **args) -> None:
        """One Chrome FLOW event bound to ``ctx``'s flow id: ``start`` at
        the minting stage, ``step`` at every hop (prefill done, handoff
        landed, requeue), ``end`` at retirement. Every process carrying
        the same :class:`TraceContext` emits under the same id, so the
        stitched cross-process timeline draws the request as one causal
        chain of arrows (``obs.cluster.stitch_traces``)."""
        if not self.registry.enabled:
            return
        ph = self._FLOW_PH.get(phase)
        if ph is None:
            raise ValueError(
                f"flow phase must be one of {sorted(self._FLOW_PH)}, "
                f"got {phase!r}"
            )
        flow_args = {"trace_id": ctx.trace_id}
        if args:
            for k, v in args.items():
                flow_args[k] = _arg_value(v)
        event = {
            "name": name, "ph": ph, "cat": "request",
            "id": ctx.flow_id_hex, "ts": self._now_us(),
            "pid": _PID, "tid": threading.get_ident(),
            "args": flow_args,
        }
        if ph == "f":
            event["bp"] = "e"  # bind the arrow to the enclosing slice
        with self._lock:
            self._append(event)

    def request_span(self, name: str, ctx: "TraceContext | None",
                     fence=None, flow: str | None = None, **args):
        """:meth:`span` tagged with a request's trace identity (plus an
        optional flow event emitted inside the span, so Chrome binds the
        arrow to this slice). ``ctx=None`` degrades to a plain span —
        call sites never branch on whether a request carries a trace.

        Request spans ride a lean class-based path (one lock hold for
        B + flow, no flight-recorder write — the serving layer records
        its own admit/retire/requeue flight events): the per-request
        tracing bill is budgeted at < 1% of a decode tick in the JAX
        package (``bench.py --section request_tracing``)."""
        if flow is not None and flow not in self._FLOW_PH:
            # validate eagerly (like :meth:`flow`): __enter__ only looks
            # the phase up when obs is ENABLED, so a call-site typo would
            # otherwise pass every disabled run and crash the serving hot
            # path the first time DSML_OBS=1
            raise ValueError(
                f"flow phase must be one of {sorted(self._FLOW_PH)}, "
                f"got {flow!r}"
            )
        if ctx is None:
            return self.span(name, fence=fence, **args)
        return _RequestSpan(self, name, ctx, fence, flow, args)

    def _append(self, event: dict) -> None:
        self._events.append(event)
        if len(self._events) > _EVENT_CAP:
            # amortized eviction: cut the oldest quarter, then drop 'E'
            # events whose 'B' fell in the cut — orphaned ends would make
            # chrome://tracing mis-nest the whole remaining trace. (Old B
            # events whose E survives stay matched; only E-without-B can
            # result from dropping a prefix.)
            del self._events[: _EVENT_CAP // 4]
            kept, stacks = [], {}
            for e in self._events:
                stack = stacks.setdefault(e["tid"], [])
                if e["ph"] == "B":
                    stack.append(e["name"])
                elif e["ph"] == "E":
                    if not stack or stack[-1] != e["name"]:
                        continue  # its B was evicted — drop the orphan
                    stack.pop()
                kept.append(e)
            self._events = kept

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """``chrome://tracing``-loadable dict. Events are sorted by ``ts``
        (concurrent threads append under one lock, but their clock reads
        race the append order)."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def summaries(self) -> dict:
        """{span name: {count, mean, p50, p90, p99} (ms)}."""
        out = {}
        for key, _ in self._hist._items():
            (name,) = key
            out[name] = self._hist.summary(name=name)
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()


class _RequestSpan:
    """Class-based context manager for trace-tagged spans: emits the B
    event (and optional flow event) under ONE lock hold on enter, the E
    event + ``span_ms`` sample on exit. Exists because request tracing
    runs per request on the serving hot path — the generator-contextmanager
    plumbing of :meth:`SpanTracer.span` costs more than the events."""

    __slots__ = ("tracer", "name", "ctx", "fence", "flow", "args", "_t0",
                 "_live")

    def __init__(self, tracer, name, ctx, fence, flow, args):
        self.tracer = tracer
        self.name = name
        self.ctx = ctx
        self.fence = fence
        self.flow = flow
        self.args = args
        self._t0 = 0.0
        self._live = False

    def __enter__(self):
        tracer = self.tracer
        if not tracer.registry.enabled:
            return tracer
        self._live = True
        ctx = self.ctx
        tid = threading.get_ident()
        pid = _PID
        ts = tracer._now_us()
        self._t0 = ts
        span_args = {"trace_id": ctx.trace_id,
                     "parent_span": ctx.span_id or self.name}
        for k, v in self.args.items():
            span_args[k] = _arg_value(v)
        begin = {"name": self.name, "ph": "B", "ts": ts, "pid": pid,
                 "tid": tid, "args": span_args}
        events = [begin]
        if self.flow is not None:
            flow_ev = {
                "name": self.name, "ph": SpanTracer._FLOW_PH[self.flow],
                "cat": "request", "id": ctx.flow_id_hex, "ts": ts,
                "pid": pid, "tid": tid,
                "args": {"trace_id": ctx.trace_id},
            }
            if flow_ev["ph"] == "f":
                flow_ev["bp"] = "e"
            events.append(flow_ev)
        with tracer._lock:
            for e in events:
                tracer._append(e)
        return tracer

    def __exit__(self, exc_type, exc, tb):
        if not self._live:
            return False
        if self.fence is not None:
            synchronize(self.fence)
        tracer = self.tracer
        end_ts = tracer._now_us()
        with tracer._lock:
            tracer._append({"name": self.name, "ph": "E", "ts": end_ts,
                            "pid": _PID,
                            "tid": threading.get_ident()})
        # request spans deliberately do NOT feed span_ms: their latency
        # distributions already land in the serving_* histograms
        # (admission/TTFT/TPOT/prefill-chunk), and the per-request tracing
        # bill is budgeted against a decode tick — no duplicate sample
        return False


_default_tracer: SpanTracer | None = None
_default_lock = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-default tracer (bound to the default registry)."""
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = SpanTracer()
    return _default_tracer


def span(name: str, fence=None, **args):
    """``with obs.span("grad_sync"): ...`` against the default tracer."""
    return get_tracer().span(name, fence=fence, **args)
