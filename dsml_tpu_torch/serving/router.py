"""SLO-aware router over a disaggregated prefill/decode serving fleet —
the port's counterpart of ``dsml_tpu/serving/router.py``.

The front door of the fleet: N prefill workers and M decode workers
behind one admission surface.

- **Admission + shedding** — every request names an :class:`SLOClass`;
  a class sheds with the batcher's own :class:`QueueFull` when its router
  backlog hits the class cap or the measured-TTFT estimate exceeds the
  class budget (``serving_shed_total`` with ``role="router"``).
- **Load-aware dispatch** — prompts go to the prefill worker with the
  cheapest measured backlog (queue tokens priced at the per-chunk wall
  EWMA); completed handoffs go to the decode worker with the smallest
  (load, TPOT cost estimate), the estimate acceptance-aware for a
  speculating worker (``ContinuousBatcher.predicted_tpot_s``).
- **Prefix replication** — ``register_prefix`` fans out to every prefill
  worker (and, paged, to every decode worker, after which prefill
  workers stop shipping the prefix's pages).
- **Handoff transport** — in-process object handover by default (the
  rows stay on the device); ``transport=`` a callable (e.g.
  ``handoff.frame_transport``) routes every handoff through the
  CRC-framed codec. A failed hop re-prefills the request.
- **Failure** — ``kill_prefill_worker`` / ``kill_decode_worker``: the
  unfinished work re-enters the backlog and re-prefills on survivors.
  Prefill is a pure function of the prompt and the sampler's noise
  follows the fleet-wide rid, so a worker loss costs latency, never
  tokens.
- **Request tracing + SLO accounting** — ``submit`` mints a
  :class:`~dsml_tpu_torch.obs.TraceContext` that rides every stage
  (prefill dispatch, the handoff, decode injection, retire or requeue,
  the same trace across retries); the TTFT/TPOT histograms carry
  trace_id exemplars; each class's measured TTFT/TPOT/e2e feeds the
  ``obs/slo.py`` windows (``Router.slo``).

``build_fleet`` assembles one from a model. Prefill workers run on the
model's device. A decode worker over one device is a ``ContinuousBatcher``
there; a decode worker over several is a tensor-parallel
``serving.mesh_worker.MeshDecodeWorker``: one rank process a device, which
this router drives in lockstep through the same interface (its page pool
or cache holds each rank's block of heads, as the JAX worker's is sharded
over them). :meth:`Router.close` ends such workers' processes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from dsml_tpu_torch.obs import TraceContext, flight_recorder, get_registry, get_tracer
from dsml_tpu_torch.obs.slo import SLOSpec, SLOTracker
from dsml_tpu_torch.serving.batcher import ContinuousBatcher, QueueFull
from dsml_tpu_torch.serving.prefill import PrefillWorker
from dsml_tpu_torch.utils.config import env_int
from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["Router", "SLOClass", "build_fleet"]

log = get_logger("serving.router")

# raw per-request sample/record retention (offline percentiles, SLO tail
# attribution, worker-loss verdicts): bounded so a long-lived fleet's host
# memory stays flat — overflow counts into ``dropped_samples`` +
# ``serving_samples_dropped_total`` instead of growing silently
_SAMPLE_CAP_ENV = "DSML_SERVING_SAMPLES"
_SAMPLE_CAP_DEFAULT = 4096


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One admission class. ``max_queue`` caps this class's ROUTER backlog
    (0 = unbounded); ``ttft_budget_ms`` sheds when the measured-load TTFT
    estimate exceeds it (None = no budget) AND doubles as the class's
    measured TTFT SLI budget; lower ``priority`` dispatches first when
    classes compete for prefill capacity.

    The SLO-accounting fields (``obs/slo.py``): ``tpot_budget_ms`` /
    ``e2e_budget_ms`` budget the other two SLIs, ``objective`` is the
    target good fraction each budgeted SLI must meet before its error
    budget starts burning."""

    name: str
    max_queue: int = 0
    ttft_budget_ms: float | None = None
    priority: int = 0
    tpot_budget_ms: float | None = None
    e2e_budget_ms: float | None = None
    objective: float = 0.99


@dataclasses.dataclass
class _Spec:
    prompt: object
    max_new_tokens: int
    slo: str
    submitted_at: float
    trace: TraceContext | None = None


class Router:
    """See module docstring. ``prefill_workers`` is a list of
    :class:`PrefillWorker`, ``decode_workers`` a list of
    :class:`ContinuousBatcher` (the decode role: admission happens via
    ``inject``, their own submit path stays unused). All workers must
    share the model config and — for sampled serving — the same
    ``seed``/``temperature`` as the reference deployment, since the
    sampler's noise follows (seed, fleet rid, step)."""

    def __init__(self, prefill_workers, decode_workers,
                 slo_classes=None, transport=None):
        if not prefill_workers or not decode_workers:
            raise ValueError("need at least one prefill and one decode worker")
        self.prefill_workers = list(prefill_workers)
        self.decode_workers = list(decode_workers)
        for i, pw in enumerate(self.prefill_workers):
            pw.obs_replica = str(i)
        for i, dw in enumerate(self.decode_workers):
            dw.obs_replica = str(i)
            dw.obs_role = "decode"
        # paged fleets are all-or-nothing: a dense handoff cannot land in
        # a page pool (and vice versa), so a mixed fleet is a deployment
        # bug caught HERE, not inside a later tick's inject
        paged = {bool(getattr(w, "paged", False))
                 for w in self.prefill_workers + self.decode_workers}
        if len(paged) > 1:
            raise ValueError(
                "mixed fleet: every prefill AND decode worker must agree "
                "on paged_kv"
            )
        self.paged = paged.pop()
        if self.paged:
            shapes = {(w.page_size, w.page_quant)
                      for w in self.prefill_workers + self.decode_workers}
            if len(shapes) > 1:
                raise ValueError(
                    f"paged fleet disagrees on (page_size, quant): {shapes}"
                )
        classes = list(slo_classes) if slo_classes else [SLOClass("default")]
        self._classes = {c.name: c for c in classes}
        if len(self._classes) != len(classes):
            raise ValueError("duplicate SLO class names")
        self.transport = transport
        self._obs = get_registry()
        self.obs_replica = "router"
        self.obs_role = "router"
        self._backlog: dict[str, deque[int]] = {
            c.name: deque() for c in classes
        }
        self._spec: dict[int, _Spec] = {}
        self._next_frid = 0
        self._prefill_at: dict[int, PrefillWorker] = {}
        self._ready: deque = deque()  # handoffs awaiting decode capacity
        self._local: dict[tuple, int] = {}   # (id(worker), local rid) -> frid
        self._decode_at: dict[int, tuple] = {}
        self._prefill_done_at: dict[int, float] = {}
        self._results: dict[int, list] = {}
        # measured fleet latencies (seconds; EWMA alpha 0.2): TTFT end to
        # end, per-token decode latency, and the handoff→first-token wait
        # that prices the decode half of the admission estimate
        self.ttft_ewma_s: float | None = None
        self.tpot_ewma_s: float | None = None
        self.decode_wait_ewma_s: float | None = None
        # raw per-request samples (ttft_s, tpot_s or None, e2e_s) for
        # offline percentiles — the SLO-report path; cleared by
        # :meth:`reset_latency_stats`. BOUNDED (maxlen deque): a
        # long-lived fleet must not grow host memory one tuple per
        # lifetime request — overflow is counted, never silent
        self._sample_cap = max(env_int(_SAMPLE_CAP_ENV, _SAMPLE_CAP_DEFAULT), 1)
        self.latency_samples: deque[tuple] = deque(maxlen=self._sample_cap)
        self.dropped_samples = 0
        self._tpot_by_worker: dict[int, float] = {}
        self.shed_counts: dict[str, int] = {c.name: 0 for c in classes}
        self.requeued_prefill = 0
        self.requeued_decode = 0
        self.transport_failures = 0
        self.n_handoffs_routed = 0
        # ---- request tracing + SLO accounting ----
        # trace context per in-flight request; stage marks (monotonic
        # seconds) split TTFT into queue/prefill/handoff/first-decode;
        # request_records is the bounded retired-request ledger the
        # worker-loss verdicts and the tail attribution read
        self._trace: dict[int, TraceContext] = {}
        self._stage_marks: dict[int, dict] = {}
        self._retries: dict[int, int] = {}
        self.requeue_log: list[tuple] = []  # (frid, monotonic) — bounded below
        self.request_records: dict[int, dict] = {}
        self._record_order: deque[int] = deque()
        self.slo = SLOTracker([
            SLOSpec(
                name=c.name, objective=c.objective,
                ttft_budget_ms=c.ttft_budget_ms,
                tpot_budget_ms=c.tpot_budget_ms,
                e2e_budget_ms=c.e2e_budget_ms,
            )
            for c in classes
        ], registry=self._obs)

    # ---- admission -------------------------------------------------------

    def register_prefix(self, tokens) -> None:
        """Replicate a shared prompt head across EVERY prefill worker (the
        fleet-wide system-prompt pattern): any worker the router picks
        admits a matching prompt at O(L − P). Blocking setup call.

        On a PAGED fleet the registration also lands on every DECODE
        worker (its page pool holds the prefix pages once, refcounted),
        and prefill workers then ELIDE the prefix's full pages from
        every matching handoff (``ship_prefix_pages``): the decode side
        shares its local pages for those rows — the fleet-level CoW that
        cuts both the handoff wire bytes and the decode-side HBM per
        matching request."""
        for pw in self.prefill_workers:
            pw.register_prefix(tokens)
        if self.paged:
            for dw in self.decode_workers:
                dw.register_prefix(tokens)
            # every decode worker can now serve the shared rows locally —
            # safe to stop shipping them (replication happens before any
            # matching handoff exists: this is a blocking setup call)
            for pw in self.prefill_workers:
                pw.ship_prefix_pages = True

    def estimate_ttft_ms(self, prompt_len: int) -> float:
        """Measured-load TTFT estimate for a hypothetical new prompt:
        un-prefilled tokens ahead of it — router backlog plus the cheapest
        worker's own queue — priced at the measured per-chunk wall EWMA
        (spread across the prefill pool), plus the measured
        handoff→first-token decode wait. Zero until the first measurements
        land — the class cap (queue depth) carries admission control
        before the cost model is warm."""
        worker_ms = min(
            pw.estimate_ms(prompt_len) for pw in self.prefill_workers
        )
        ewmas = [pw.chunk_s_ewma for pw in self.prefill_workers
                 if pw.chunk_s_ewma]
        backlog_ms = 0.0
        if ewmas:
            backlog_tokens = sum(
                len(self._spec[f].prompt)
                for b in self._backlog.values() for f in b
            )
            chunk = self.prefill_workers[0].prefill_chunk
            chunks = -(-backlog_tokens // chunk)
            backlog_ms = (chunks * (sum(ewmas) / len(ewmas)) * 1e3
                          / len(self.prefill_workers))
        decode_ms = (self.decode_wait_ewma_s or 0.0) * 1e3
        return worker_ms + backlog_ms + decode_ms

    def _shed(self, cls: SLOClass, reason: str) -> None:
        self.shed_counts[cls.name] += 1
        self._obs.counter(
            "serving_shed_total", "requests rejected by the queue cap",
            labels=("replica", "role"),
        ).inc(replica=self.obs_replica, role=self.obs_role)
        if self._obs.enabled:
            flight_recorder.record(
                "serving_router_shed", slo=cls.name, reason=reason,
            )
        raise QueueFull(
            f"SLO class {cls.name!r} shed ({reason}); back off or retry a "
            "lower class"
        )

    def submit(self, prompt, max_new_tokens: int, slo: str = "default") -> int:
        cls = self._classes.get(slo)
        if cls is None:
            raise ValueError(
                f"unknown SLO class {slo!r}; declared: {sorted(self._classes)}"
            )
        # validate at the fleet edge: a malformed request must fail HERE
        # (the caller's bug, ValueError) — not inside a later tick's
        # dispatch, where it would crash unrelated requests' scheduling
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        pw0 = self.prefill_workers[0]
        pw0.model._check_generate_args(len(prompt), max_new_tokens, 0.0, 0, 0)
        if not pw0._fits(len(prompt)):
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the chunk grid for "
                f"max_seq={pw0.model.config.max_seq}"
            )
        if cls.max_queue and len(self._backlog[cls.name]) >= cls.max_queue:
            self._shed(cls, f"backlog at cap {cls.max_queue}")
        if cls.ttft_budget_ms is not None:
            est = self.estimate_ttft_ms(len(prompt))
            if est > cls.ttft_budget_ms:
                self._shed(
                    cls, f"estimated TTFT {est:.0f}ms > budget "
                    f"{cls.ttft_budget_ms:.0f}ms"
                )
        frid = self._next_frid
        self._next_frid += 1
        # mint the request's trace identity HERE — the fleet edge is the
        # one point every request passes exactly once. The context then
        # rides prefill dispatch, the handoff wire, and decode injection;
        # a requeue keeps the SAME trace (the retry is the same request)
        ctx = TraceContext.mint(span_id="router_submit")
        self._trace[frid] = ctx
        self._retries[frid] = 0
        with get_tracer().request_span(
            "router_submit", ctx, flow="start", frid=frid, slo=cls.name,
            prompt_len=len(prompt),
        ):
            self._spec[frid] = _Spec(
                prompt=prompt, max_new_tokens=int(max_new_tokens),
                slo=cls.name, submitted_at=time.monotonic(), trace=ctx,
            )
            self._stage_marks[frid] = {}
            self._backlog[cls.name].append(frid)
        return frid

    @property
    def outstanding(self) -> int:
        return len(self._spec)

    def trace_of(self, frid: int) -> TraceContext | None:
        """The trace context minted for ``frid`` at submit (None once the
        request retired — its trace_id then lives in
        ``request_records[frid]``)."""
        return self._trace.get(frid)

    # ---- dispatch --------------------------------------------------------

    def _dispatch_prefill(self) -> None:
        """Drain backlogs (priority order) onto the cheapest prefill
        worker. A worker at its queue cap is excluded for this tick only;
        dispatching stops when every worker is capped."""
        for cls in sorted(self._classes.values(), key=lambda c: c.priority):
            backlog = self._backlog[cls.name]
            while backlog:
                # capacity-check BEFORE submitting: the worker's own
                # QueueFull path counts a SHED, and a routed request that
                # merely waits another tick was never shed (single-threaded
                # scheduler, so the check cannot race the submit)
                open_pws = [
                    pw for pw in self.prefill_workers
                    if not (pw.max_queue and pw.n_queued >= pw.max_queue)
                ]
                if not open_pws:
                    return
                frid = backlog[0]
                spec = self._spec[frid]
                pw = min(
                    open_pws,
                    key=lambda w: (w.estimate_ms(len(spec.prompt)),
                                   w.queue_tokens, w.n_queued),
                )
                pw.submit(
                    spec.prompt, spec.max_new_tokens, frid=frid,
                    key_rid=frid, submitted_at=spec.submitted_at,
                    trace=(spec.trace.child("prefill_dispatch")
                           if spec.trace else None),
                )
                # queue stage ends here: the LAST dispatch wins after a
                # requeue, so a retry's stage split reflects the run that
                # actually finished (e2e always counts from first submit)
                self._stage_marks.setdefault(frid, {})["dispatched"] = (
                    time.monotonic()
                )
                backlog.popleft()
                self._prefill_at[frid] = pw

    def decode_cost_s(self, dw) -> float:
        """Per-token cost estimate for one decode worker — the TPOT cost
        model the dispatch order uses. An acceptance-aware prediction
        wins when the worker speculates and its EWMAs are warm
        (``ContinuousBatcher.predicted_tpot_s``: measured verify-tick
        wall over measured committed-tokens-per-tick — a worker whose
        drafts stop landing gets expensive BEFORE harvested TPOT catches
        up); otherwise the harvested per-worker TPOT EWMA."""
        predict = getattr(dw, "predicted_tpot_s", None)
        p = predict() if callable(predict) else None
        if p is not None:
            return p
        return self._tpot_by_worker.get(id(dw), 0.0)

    def _route_handoff(self, h) -> bool:
        """Place one (already-transported) handoff on the decode worker
        with the smallest (load, TPOT cost estimate); returns False when
        every worker is at its inject cap (the handoff waits in
        ``_ready``). Caps are checked before injecting — the worker's own
        QueueFull path counts a SHED, and a handoff that merely waits
        another tick was never shed."""
        order = sorted(
            self.decode_workers,
            key=lambda w: (
                w.n_active + w.n_queued + w.n_pending + w.n_injected,
                self.decode_cost_s(w),
            ),
        )
        for dw in order:
            if dw.max_queue and dw.n_injected >= dw.max_queue:
                continue
            if h.page_size is not None:
                lrid = dw.inject(
                    h.prompt, h.max_new_tokens, logits_row=h.logits,
                    key_rid=h.key_rid, submitted_at=h.submitted_at,
                    kv_pages=h.cache1, page_size=h.page_size,
                    prefix_rows=h.prefix_rows, trace_id=h.trace_id,
                )
            else:
                lrid = dw.inject(
                    h.prompt, h.max_new_tokens, h.cache1, h.logits,
                    key_rid=h.key_rid, submitted_at=h.submitted_at,
                    trace_id=h.trace_id,
                )
            self._local[(id(dw), lrid)] = h.frid
            self._decode_at[h.frid] = (dw, lrid)
            self._prefill_done_at[h.frid] = h.prefill_done_at
            marks = self._stage_marks.setdefault(h.frid, {})
            marks["prefill_done"] = h.prefill_done_at
            marks["injected"] = time.monotonic()
            self.n_handoffs_routed += 1
            return True
        return False

    def _harvest(self, dw) -> None:
        for lrid, req in dw.collect_requests().items():
            frid = self._local.pop((id(dw), lrid), None)
            if frid is None:
                continue
            self._decode_at.pop(frid, None)
            spec = self._spec.pop(frid, None)
            self._results[frid] = req.tokens
            done_at = self._prefill_done_at.pop(frid, None)
            ctx = self._trace.pop(frid, None)
            marks = self._stage_marks.pop(frid, {})
            retries = self._retries.pop(frid, 0)
            if req.first_token_at is None:
                continue
            ttft = req.first_token_at - req.submitted_at
            self.ttft_ewma_s = (
                ttft if self.ttft_ewma_s is None
                else 0.8 * self.ttft_ewma_s + 0.2 * ttft
            )
            tpot = None
            e2e = None
            if len(req.tokens) > 1 and req.finished_at is not None:
                tpot = (req.finished_at - req.first_token_at) / (
                    len(req.tokens) - 1
                )
            if req.finished_at is not None:
                e2e = req.finished_at - req.submitted_at
                if len(self.latency_samples) == self._sample_cap:
                    self.dropped_samples += 1
                    if self._obs.enabled:
                        self._obs.counter(
                            "serving_samples_dropped_total",
                            "per-request samples evicted by the bounded "
                            "buffer", labels=("replica", "role"),
                        ).inc(replica=self.obs_replica, role=self.obs_role)
                self.latency_samples.append((ttft, tpot, e2e))
            if done_at is not None:
                wait = max(req.first_token_at - done_at, 0.0)
                self.decode_wait_ewma_s = (
                    wait if self.decode_wait_ewma_s is None
                    else 0.8 * self.decode_wait_ewma_s + 0.2 * wait
                )
            if tpot is not None:
                self.tpot_ewma_s = (
                    tpot if self.tpot_ewma_s is None
                    else 0.8 * self.tpot_ewma_s + 0.2 * tpot
                )
                prev = self._tpot_by_worker.get(id(dw))
                self._tpot_by_worker[id(dw)] = (
                    tpot if prev is None else 0.8 * prev + 0.2 * tpot
                )
                if self._obs.enabled:
                    self._obs.histogram(
                        "serving_tpot_ms", "per-token decode latency",
                        labels=("replica", "role"),
                    ).observe(tpot * 1e3,
                              exemplar=ctx.trace_id if ctx else None,
                              replica=dw.obs_replica, role=dw.obs_role)
            if self._obs.enabled:
                self._obs.histogram(
                    "serving_ttft_ms", "end-to-end time to first token",
                    labels=("replica", "role"),
                ).observe(ttft * 1e3,
                          exemplar=ctx.trace_id if ctx else None,
                          replica=self.obs_replica, role=self.obs_role)
            self._account_retired(frid, req, spec, ctx, marks, retries,
                                  ttft, tpot, e2e)

    def _account_retired(self, frid, req, spec, ctx, marks, retries,
                         ttft, tpot, e2e) -> None:
        """SLO + stage accounting for one retired request: split TTFT into
        queue / prefill / handoff / first-decode from the stage marks,
        feed the class's SLI windows (``obs/slo.py``), and append the
        bounded request record the worker-loss verdicts and the
        tail-attribution report read."""
        slo_name = spec.slo if spec is not None else "default"
        stages = {}
        t_sub = req.submitted_at
        dispatched = marks.get("dispatched")
        prefill_done = marks.get("prefill_done")
        injected = marks.get("injected")
        if dispatched is not None:
            stages["queue"] = max(dispatched - t_sub, 0.0)
        if prefill_done is not None and dispatched is not None:
            stages["prefill"] = max(prefill_done - dispatched, 0.0)
        if injected is not None and prefill_done is not None:
            stages["handoff"] = max(injected - prefill_done, 0.0)
        if injected is not None and req.first_token_at is not None:
            stages["first_decode"] = max(req.first_token_at - injected, 0.0)
        if req.finished_at is not None and req.first_token_at is not None:
            stages["decode"] = req.finished_at - req.first_token_at
        if slo_name in self.slo.specs:
            self.slo.record(
                slo_name,
                ttft_ms=ttft * 1e3,
                tpot_ms=None if tpot is None else tpot * 1e3,
                e2e_ms=None if e2e is None else e2e * 1e3,
                trace_id=ctx.trace_id if ctx else None,
                stages=stages,
            )
        record = {
            "frid": frid,
            "slo": slo_name,
            "trace_id": ctx.trace_id if ctx else None,
            "retries": retries,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "e2e_s": e2e,
            "finished_mono": req.finished_at,
            "stages_s": stages,
        }
        self.request_records[frid] = record
        self._record_order.append(frid)
        while len(self._record_order) > self._sample_cap:
            self.request_records.pop(self._record_order.popleft(), None)

    def tick(self) -> None:
        """One fleet pass: retry waiting handoffs → dispatch backlog →
        step prefill workers (routing fresh handoffs) → step decode
        workers → harvest."""
        while self._ready:
            if not self._route_handoff(self._ready[0]):
                break
            self._ready.popleft()
        self._dispatch_prefill()
        for pw in self.prefill_workers:
            for h in pw.step():
                self._prefill_at.pop(h.frid, None)
                if self.transport is not None:
                    # the wire hop runs ONCE per handoff, here — a handoff
                    # parked in _ready must not re-pay encode+CRC+decode
                    # on every placement retry. A FAILED hop (CRC abort,
                    # dead stream, donor loss) is the documented
                    # re-prefill case: the handoff is reproducible from
                    # the prompt, so the request goes back to the backlog
                    # front instead of crashing the fleet or stranding
                    try:
                        h = self.transport(h)
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        self.transport_failures += 1
                        self._respool(h.frid)
                        log.warning(
                            "handoff transport failed for frid %d; "
                            "re-prefilling: %r", h.frid, e,
                        )
                        if self._obs.enabled:
                            flight_recorder.record(
                                "serving_handoff_transport_failure",
                                frid=h.frid, error=repr(e)[:120],
                            )
                        continue
                if not self._route_handoff(h):
                    self._ready.append(h)
        for dw in self.decode_workers:
            if (dw.n_active or dw.n_queued or dw.n_pending or dw.n_injected
                    or dw.n_preempted):
                dw.step()
                self._harvest(dw)
        if self._obs.enabled:
            self._obs.gauge(
                "serving_queue_depth", "requests waiting for a slot",
                labels=("replica", "role"),
            ).set(
                sum(len(b) for b in self._backlog.values()) + len(self._ready),
                replica=self.obs_replica, role=self.obs_role,
            )

    def decode_gaps(self) -> list[float]:
        """All decode workers' inter-emission gap samples (seconds),
        pooled — with ``decode_quantum=1`` these ARE per-token decode
        latencies, the burst-isolation headline's raw data: a monolithic
        batcher's gaps stretch while prefill chunks share its ticks; a
        disaggregated decode worker's do not."""
        out: list[float] = []
        for dw in self.decode_workers:
            out.extend(dw._gaps)
        return out

    def reset_latency_stats(self) -> None:
        self.latency_samples.clear()
        for dw in self.decode_workers:
            dw.reset_latency_stats()

    def reset_request_records(self) -> None:
        """Drop the retired-request ledger (and its eviction order —
        clearing only the dict would desync the bound). Warm-up
        isolation alongside :meth:`reset_latency_stats` + ``slo.reset()``."""
        self.request_records.clear()
        self._record_order.clear()

    def close(self) -> None:
        """End the processes of every decode worker that has them
        (``MeshDecodeWorker``); in-process workers need nothing."""
        for dw in self.decode_workers:
            close = getattr(dw, "close", None)
            if close is not None:
                close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def run(self, max_ticks: int = 100_000) -> dict[int, list]:
        """Drain everything; returns {frid: [tokens]} for every request
        finished during (or before) this call."""
        for _ in range(max_ticks):
            if not self.outstanding:
                break
            self.tick()
        else:
            raise RuntimeError(f"fleet did not drain within {max_ticks} ticks")
        out = dict(self._results)
        self._results.clear()
        return out

    # ---- worker loss -----------------------------------------------------

    def _respool(self, frid: int) -> None:
        spec = self._spec.get(frid)
        if spec is None:
            return
        self._backlog[spec.slo].appendleft(frid)  # it has waited longest
        # the retry keeps the SAME trace (same request, same error-budget
        # clock: submitted_at is untouched, so the eventual SLI burn
        # counts the FULL user-visible latency, kill included) — the
        # retry span marks the requeue on the request's causal chain
        self._retries[frid] = self._retries.get(frid, 0) + 1
        now = time.monotonic()
        self.requeue_log.append((frid, now))
        if len(self.requeue_log) > self._sample_cap:
            del self.requeue_log[: len(self.requeue_log) - self._sample_cap]
        ctx = self._trace.get(frid)
        if ctx is not None and self._obs.enabled:
            tracer = get_tracer()
            with tracer.request_span(
                "serving_request_retry", ctx, frid=frid,
                outcome="requeued", retries=self._retries[frid],
            ):
                tracer.flow("serving_request_retry", ctx, phase="step",
                            outcome="requeued")

    def kill_prefill_worker(self, idx: int | None = None) -> int:
        """Chaos hook: drop a prefill worker (default: the last). Its
        unfinished jobs — queued and MID-CHUNK — re-enter the backlog at
        the front and re-prefill on a survivor; identical rows, identical
        tokens. Returns the requeue count."""
        if len(self.prefill_workers) <= 1:
            raise RuntimeError("cannot kill the last prefill worker")
        pw = self.prefill_workers.pop(
            idx if idx is not None else len(self.prefill_workers) - 1
        )
        requeued = 0
        # abandon() lists oldest first; appendleft-ing in REVERSE keeps
        # the longest-waiting job at the backlog head (the same rule as
        # kill_decode_worker's)
        for spec in reversed(pw.abandon()):
            frid = spec["frid"]
            self._prefill_at.pop(frid, None)
            self._respool(frid)
            requeued += 1
        self.requeued_prefill += requeued
        if self._obs.enabled:
            flight_recorder.record(
                "serving_prefill_worker_lost", requeued=requeued,
                survivors=len(self.prefill_workers),
            )
        return requeued

    def kill_decode_worker(self, idx: int | None = None) -> int:
        """Chaos hook: drop a decode worker. Finished-but-uncollected
        results are harvested first; unfinished requests (injected queue,
        mid-decode) re-enter the backlog and run the FULL pipeline again —
        re-prefill on a prefill worker, handoff, decode on a survivor.
        Greedy decode makes the re-run bit-identical. A worker of rank
        processes (``MeshDecodeWorker``) is killed for real after the
        harvest of what rank 0 reported, its unfinished requests read from
        the router's own record. Returns the requeue count."""
        if len(self.decode_workers) <= 1:
            raise RuntimeError("cannot kill the last decode worker")
        dw = self.decode_workers.pop(
            idx if idx is not None else len(self.decode_workers) - 1
        )
        self._harvest(dw)
        kill = getattr(dw, "kill", None)
        if kill is not None:
            # a worker of rank processes: its state dies with them, and what
            # it held unfinished is the router's own record of its requests
            kill()
            lrids = sorted(lrid for w, lrid in self._local if w == id(dw))
        else:
            lrids = [req.rid for req in dw.abandon()]
        requeued = 0
        for lrid in reversed(lrids):
            frid = self._local.pop((id(dw), lrid), None)
            if frid is None:
                continue
            self._decode_at.pop(frid, None)
            self._prefill_done_at.pop(frid, None)
            self._respool(frid)
            requeued += 1
        self.requeued_decode += requeued
        self._tpot_by_worker.pop(id(dw), None)
        if self._obs.enabled:
            flight_recorder.record(
                "serving_decode_worker_lost", requeued=requeued,
                survivors=len(self.decode_workers),
            )
        return requeued


def _model_on(model, device: torch.device):
    """``model`` itself when it lives on ``device``, else a model of its
    class and config there holding a copy of its weights."""
    if device == model.device:
        return model
    twin = type(model)(model.config, device=device)
    twin.load_state_dict(model.state_dict())
    return twin


def build_fleet(
    model,
    n_prefill: int = 1,
    n_decode: int = 1,
    prefill_chunk: int = 64,
    slo_classes=None,
    transport=None,
    devices=None,
    prefill_max_queue: int = 0,
    paged_kv=False,
    page_size: int = 16,
    prefill_n_pages: int = 0,
    **decode_kwargs,
) -> Router:
    """Assemble a disaggregated fleet: ``n_prefill`` chunked prefill
    workers and ``n_decode`` decode batchers behind a :class:`Router`,
    every one on ``model``'s device (``model`` holds the weights; build
    it with ``device="cpu"`` for a CPU fleet). ``decode_kwargs`` go to
    each decode batcher (``n_slots``, ``max_queue``, ``temperature`` /
    ``seed``, ``speculative_window``, ...); decode workers keep
    ``prefill_chunk=0``, their admissions arrive prefilled. ``paged_kv``
    builds a PAGED fleet (page pools everywhere, paged handoffs,
    decode-side CoW prefixes): ``page_size`` is fleet-wide,
    ``prefill_n_pages`` sizes the prefill pools, and the decode pools'
    size rides ``decode_kwargs['n_pages']``.

    ``devices`` gives each decode worker an equal slice of the list
    (the JAX ``ContinuousBatcher.for_devices``); prefill workers stay on
    the model's device. A slice of one device is a worker on it, serving a
    copy of the weights there when the model lives elsewhere. A slice of
    several is a tensor-parallel ``MeshDecodeWorker`` over them (tp = the
    slice's length), one rank process a device, every worker's processes
    started at once; ``workdir`` in ``decode_kwargs`` goes
    to it (``serving/mesh_worker.py``). Such a fleet's processes end with
    :meth:`Router.close`."""
    prefill_workers = [
        PrefillWorker(model, prefill_chunk, max_queue=prefill_max_queue, paged_kv=paged_kv,
                      page_size=page_size, n_pages=prefill_n_pages)
        for _ in range(n_prefill)
    ]
    if paged_kv:
        decode_kwargs.setdefault("paged_kv", paged_kv)
        decode_kwargs.setdefault("page_size", page_size)
    if devices is not None:
        devices = list(devices)
        per = len(devices) // n_decode
        if per < 1:
            raise ValueError(f"{len(devices)} device(s) cannot back {n_decode} decode worker(s)")
        if per > 1:
            from dsml_tpu_torch.serving.mesh_worker import MeshDecodeWorker

            decode_workers = MeshDecodeWorker.spawn(
                model, [devices[i * per:(i + 1) * per] for i in range(n_decode)],
                **decode_kwargs)
            return Router(prefill_workers, decode_workers, slo_classes=slo_classes,
                          transport=transport)
        decode_workers = []
        for dev in devices[:n_decode]:
            dev = torch.device(dev)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            decode_workers.append(ContinuousBatcher.for_devices(_model_on(model, dev), [dev],
                                                                **decode_kwargs))
    else:
        decode_workers = [ContinuousBatcher(model, **decode_kwargs) for _ in range(n_decode)]
    return Router(prefill_workers, decode_workers, slo_classes=slo_classes, transport=transport)
