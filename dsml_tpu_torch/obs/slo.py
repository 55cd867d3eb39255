"""Per-SLO-class SLI windows, error budgets, burn rates and tail
attribution — the port's copy of ``dsml_tpu/obs/slo.py`` (pure Python).

The serving router admits by SLO class; this module is the measured half
of a class's budget, in the shape of the SRE workbook's multi-window
burn-rate alerting over the fleet's own request samples:

- **SLIs**: per class, each configured budget (TTFT / TPOT / e2e) is a
  binary good/bad verdict per retired request; compliance over a rolling
  window is the SLI.
- **Error budget + burn rate**: with objective ``o`` (e.g. 0.99), the
  budget is the allowed bad fraction ``1-o``; ``burn_rate = bad_frac /
  (1-o)`` — 1.0 burns exactly the budget over the window, 14.4 exhausts
  a 30-day budget in ~2 days. Two windows (fast ~1 min, slow ~10 min by
  default here) gate the status: both above the page threshold ⇒
  ``page``, both above the warn threshold ⇒ ``warn``, else ``ok`` — the
  multi-window rule that suppresses blips (fast-only) and stale alerts
  (slow-only).
- **Goodput**: requests meeting EVERY configured budget, counted per
  class.
- **Tail attribution**: per-request stage breakdown (queue, prefill,
  handoff, first-decode, inter-token) aggregated over the e2e tail —
  which STAGE dominates each class's p99, with the worst request's
  trace_id as the exemplar.

Everything exports into the metrics registry (`slo_*` series, merged
fleet-wide by ``obs.cluster.MergedView``), with the JAX package's names,
labels and arithmetic.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from dsml_tpu_torch.obs.registry import Registry, get_registry

__all__ = [
    "SLIS",
    "SLOSpec",
    "SLOTracker",
    "STAGES",
    "burn_rate",
    "status_from_burn",
    "tail_attribution",
    "window_compliance",
]

# the three request-latency SLIs a serving class can budget
SLIS = ("ttft", "tpot", "e2e")

# per-request stage breakdown (seconds), in causal order; "decode" is the
# inter-token phase after the first token
STAGES = ("queue", "prefill", "handoff", "first_decode", "decode")

# burn-rate thresholds (SRE workbook defaults): both windows above PAGE
# pages, both above WARN warns. A burn of 1.0 spends exactly the budget.
PAGE_BURN = 14.4
WARN_BURN = 6.0

# bounded per-class sample memory (the stage/tail attribution source)
_STAGE_SAMPLE_CAP = 4096

# numeric encoding of the status ladder, exported as a gauge so the
# cluster merge can take a fleet-wide max (strings don't merge)
STATUS_LEVELS = {"ok": 0, "warn": 1, "page": 2}


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One class's objectives. A ``None`` budget means that SLI is not
    part of this class's contract (batch traffic rarely budgets TTFT).
    ``objective`` is the target good fraction shared by every budgeted
    SLI — 0.99 allows 1% of requests over budget before the burn rate
    exceeds 1."""

    name: str
    objective: float = 0.99
    ttft_budget_ms: float | None = None
    tpot_budget_ms: float | None = None
    e2e_budget_ms: float | None = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective} "
                f"(class {self.name!r})"
            )
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )

    def budget_ms(self, sli: str) -> float | None:
        return {"ttft": self.ttft_budget_ms, "tpot": self.tpot_budget_ms,
                "e2e": self.e2e_budget_ms}[sli]

    def budgeted_slis(self) -> tuple:
        return tuple(s for s in SLIS if self.budget_ms(s) is not None)


def window_compliance(events, now: float, window_s: float) -> tuple[int, int]:
    """(good, total) over events ``(t, good)`` with ``t > now - window_s``.
    Plain counting — the numpy pin in tests re-derives it independently."""
    lo = now - window_s
    good = total = 0
    for t, ok in events:
        if t > lo:
            total += 1
            good += 1 if ok else 0
    return good, total


def burn_rate(bad_fraction: float, objective: float) -> float:
    """How fast the error budget is being spent: observed bad fraction
    over the allowed bad fraction ``1 - objective``. 0 when nothing is
    bad; 1.0 = spending exactly the budget; `1/(1-o)` when EVERYTHING
    is bad (the ceiling — at o=0.99 that is 100)."""
    allowed = 1.0 - objective
    if allowed <= 0.0:
        raise ValueError(f"objective {objective} leaves no error budget")
    return bad_fraction / allowed


def status_from_burn(fast: float, slow: float,
                     page: float = PAGE_BURN, warn: float = WARN_BURN) -> str:
    """The multi-window rule: BOTH windows must agree before escalating —
    a fast-only spike is a blip, a slow-only excess is an already-ended
    incident still draining out of the long window."""
    if fast >= page and slow >= page:
        return "page"
    if fast >= warn and slow >= warn:
        return "warn"
    return "ok"


def tail_attribution(samples, q: float = 0.99) -> dict | None:
    """Attribute a latency tail to its dominant stage.

    ``samples``: list of ``(e2e_s, stages_dict, trace_id)`` — the tracker
    keeps one bounded deque per class. Requests at or above the ``q``
    quantile of e2e form the tail set; their mean per-stage seconds name
    the ``dominant_stage``, and the single worst request's trace_id rides
    along as the exemplar (the "open THIS trace" link)."""
    if not samples:
        return None
    e2e = sorted(s[0] for s in samples)
    # nearest-rank quantile (matches numpy 'higher' within one sample —
    # the tests pin the tail SET, not an interpolated scalar)
    idx = min(int(q * len(e2e)), len(e2e) - 1)
    threshold = e2e[idx]
    tail = [s for s in samples if s[0] >= threshold]
    worst = max(tail, key=lambda s: s[0])
    stage_ms = {}
    for stage in STAGES:
        vals = [s[1].get(stage) for s in tail]
        vals = [v for v in vals if v is not None]
        if vals:
            stage_ms[stage] = round(sum(vals) / len(vals) * 1e3, 3)
    if not stage_ms:
        return None
    dominant = max(stage_ms, key=stage_ms.get)
    return {
        "p_quantile": q,
        "threshold_ms": round(threshold * 1e3, 3),
        "n_tail": len(tail),
        "n_samples": len(samples),
        "stage_ms": stage_ms,
        "dominant_stage": dominant,
        "dominant_share": round(
            stage_ms[dominant] / max(sum(stage_ms.values()), 1e-12), 4
        ),
        "worst_e2e_ms": round(worst[0] * 1e3, 3),
        "worst_trace_id": worst[2],
    }


# per-window event retention cap: a window's compliance is computed over
# at most this many most-recent events — bounds memory at any QPS (the
# rolling counts stay O(1) per record either way)
_SLI_EVENT_CAP = 8192


class _Window:
    """One rolling SLI window with O(1)-amortized incremental counts —
    ``SLOTracker.record`` runs on the serving harvest path, so compliance
    must never rescan the event history per request."""

    __slots__ = ("window_s", "events", "good")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.events: deque = deque(maxlen=_SLI_EVENT_CAP)
        self.good = 0

    def add(self, t: float, ok: bool) -> None:
        if len(self.events) == self.events.maxlen:
            _, old_ok = self.events[0]  # maxlen evicts silently — account
            self.good -= 1 if old_ok else 0
        self.events.append((t, ok))
        self.good += 1 if ok else 0
        self.prune(t)

    def prune(self, now: float) -> None:
        lo = now - self.window_s
        ev = self.events
        while ev and ev[0][0] <= lo:
            _, ok = ev.popleft()
            self.good -= 1 if ok else 0

    def counts(self, now: float) -> tuple[int, int]:
        self.prune(now)
        return self.good, len(self.events)


class _SLIState:
    __slots__ = ("fast", "slow", "good_total", "total")

    def __init__(self, spec: "SLOSpec"):
        self.fast = _Window(spec.fast_window_s)
        self.slow = _Window(spec.slow_window_s)
        self.good_total = 0           # all-time (the fleet-merge counters)
        self.total = 0


class SLOTracker:
    """Measured SLO compliance per class, fed one retired request at a
    time (:meth:`record`). Windows use the caller's clock (default
    ``time.monotonic`` — the same origin as the serving timing marks).

    Registry export (when observability is enabled): ``slo_requests_total
    {slo}``, ``slo_good_total{slo}`` (goodput: every budgeted SLI met),
    ``slo_sli_total{slo,sli,verdict}`` (the exact fleet-mergeable
    counters), ``slo_objective{slo}``, ``slo_burn_rate{slo,sli,window}``
    and ``slo_burn_status{slo,sli}`` (0 ok / 1 warn / 2 page) gauges, the
    JAX package's series."""

    def __init__(self, specs, registry: Registry | None = None, clock=None):
        specs = list(specs)
        if not specs:
            raise ValueError("SLOTracker needs at least one SLOSpec")
        self.specs = {s.name: s for s in specs}
        if len(self.specs) != len(specs):
            raise ValueError("duplicate SLO class names")
        self._clock = clock if clock is not None else time.monotonic
        # RLock: record() holds it across _export → export_gauges, and the
        # registry's scrape-time collect hook refreshes gauges from OTHER
        # threads (the HTTP metrics server) — window counts() prunes, so
        # unsynchronized concurrent reads would corrupt the running good
        # counter
        self._lock = threading.RLock()
        self._obs = registry if registry is not None else get_registry()
        self._sli: dict[tuple, _SLIState] = {
            (s.name, sli): _SLIState(s)
            for s in specs for sli in s.budgeted_slis()
        }
        # (class, sli) -> budget ms, flattened once: spec.budget_ms builds
        # a dict per call and record() runs per retired request
        self._budgets: dict[str, tuple] = {
            s.name: tuple((sli, s.budget_ms(sli))
                          for sli in s.budgeted_slis())
            for s in specs
        }
        # burn-rate GAUGES recompute at most ~4x/s per class (counters
        # still bump per record — they must merge exactly); the first
        # record always exports so tests/short runs see the series
        self._last_gauge_export: dict[str, float] = {}
        # metric handles resolved ONCE — record() runs per retired request
        # on the router's harvest path, and the registry's get-or-create
        # lookup is not free there
        reg = self._obs
        c_requests = reg.counter(
            "slo_requests_total", "retired requests per SLO class",
            labels=("slo",),
        )
        c_good = reg.counter(
            "slo_good_total",
            "requests that met every budgeted SLI (goodput)", labels=("slo",),
        )
        c_sli = reg.counter(
            "slo_sli_total",
            "per-SLI request verdicts (exact fleet-mergeable counts)",
            labels=("slo", "sli", "verdict"),
        )
        # bound series per (class, sli, verdict): label validation paid at
        # init, one lock per inc on the harvest path
        self._b_requests = {s: c_requests.bind(slo=s) for s in self.specs}
        self._b_good = {s: c_good.bind(slo=s) for s in self.specs}
        self._b_sli = {
            (s.name, sli, verdict): c_sli.bind(slo=s.name, sli=sli,
                                               verdict=verdict)
            for s in specs for sli in s.budgeted_slis()
            for verdict in ("good", "bad")
        }
        self._g_objective = reg.gauge(
            "slo_objective", "target good fraction per class", labels=("slo",),
        )
        self._g_burn = reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate over the rolling window",
            labels=("slo", "sli", "window"),
        )
        self._g_status = reg.gauge(
            "slo_burn_status",
            "multi-window burn status (0 ok / 1 warn / 2 page)",
            labels=("slo", "sli"),
        )
        self.requests: dict[str, int] = {s.name: 0 for s in specs}
        self.good_requests: dict[str, int] = {s.name: 0 for s in specs}
        self._stage_samples: dict[str, deque] = {
            s.name: deque(maxlen=_STAGE_SAMPLE_CAP) for s in specs
        }
        # scrape-time refresh: the burn gauges depend on the CLOCK (rolling
        # windows drain), not just on ingest — without this hook a gauge
        # last exported mid-burst would freeze at "page" once the class's
        # traffic stops, and every exposition/snapshot/MergedView would
        # report a permanently-firing alert on an idle class. Weakly held:
        # dies with the tracker.
        reg.add_collect_hook(self.export_gauges)

    # -- ingest ------------------------------------------------------------

    def record(self, name: str, ttft_ms: float | None = None,
               tpot_ms: float | None = None, e2e_ms: float | None = None,
               trace_id: str | None = None,
               stages: dict | None = None) -> dict:
        """One retired request's measured latencies → SLI verdicts.

        A budgeted SLI with a ``None`` measurement is NOT MEASURABLE for
        this request and is skipped — it counts toward neither window
        (TPOT is undefined for a single-token request; counting it as
        bad would burn a class's TPOT budget on traffic that fully met
        its contract). Requests that never produce a first token never
        reach the router's harvest, so None here always means
        "inapplicable", not "failed". Returns {sli: good} for the
        class's MEASURED budgeted SLIs."""
        spec = self.specs.get(name)
        if spec is None:
            raise ValueError(
                f"unknown SLO class {name!r}; declared: {sorted(self.specs)}"
            )
        now = self._clock()
        measured = {"ttft": ttft_ms, "tpot": tpot_ms, "e2e": e2e_ms}
        verdicts: dict[str, bool] = {}
        with self._lock:
            for sli, budget in self._budgets[name]:
                val = measured[sli]
                if val is None:
                    continue
                good = val <= budget
                verdicts[sli] = good
                state = self._sli[(name, sli)]
                state.fast.add(now, good)
                state.slow.add(now, good)
                state.total += 1
                state.good_total += 1 if good else 0
            self.requests[name] += 1
            all_good = all(verdicts.values()) if verdicts else True
            if all_good:
                self.good_requests[name] += 1
            if stages is not None and e2e_ms is not None:
                self._stage_samples[name].append(
                    (e2e_ms / 1e3, dict(stages), trace_id)
                )
            self._export(name, spec, verdicts, all_good)
        return verdicts

    def reset(self) -> None:
        """Drop every rolling window, per-class counter, and stage
        sample — warm-up isolation (a warm-up drives first-call
        requests through the fleet before the measured schedule; their
        seconds-long e2e would own the p99 tail and the burn windows).
        The registry's ``slo_*`` counters are monotonic by contract
        (fleet merges sum them exactly) and are NOT rolled back."""
        with self._lock:
            for state in self._sli.values():
                for w in (state.fast, state.slow):
                    w.events.clear()
                    w.good = 0
                state.good_total = 0
                state.total = 0
            for name in self.requests:
                self.requests[name] = 0
                self.good_requests[name] = 0
            for dq in self._stage_samples.values():
                dq.clear()
            self._last_gauge_export.clear()

    # -- derived -----------------------------------------------------------

    def burn(self, name: str, sli: str, window: str = "fast",
             now: float | None = None) -> dict:
        """{good, total, compliance, burn} over the ``"fast"`` or
        ``"slow"`` rolling window (O(1) — incremental counts). Zero
        traffic in the window burns nothing (burn 0, compliance None)."""
        spec = self.specs[name]
        state = self._sli[(name, sli)]
        now = self._clock() if now is None else now
        with self._lock:  # counts() PRUNES; scrape hooks read concurrently
            good, total = getattr(state, window).counts(now)
        if total == 0:
            return {"good": 0, "total": 0, "compliance": None, "burn": 0.0}
        bad_frac = (total - good) / total
        return {
            "good": good, "total": total,
            "compliance": good / total,
            "burn": burn_rate(bad_frac, spec.objective),
        }

    def status(self, name: str, sli: str) -> dict:
        now = self._clock()
        fast = self.burn(name, sli, "fast", now)
        slow = self.burn(name, sli, "slow", now)
        # the burn CEILING is 1/(1-objective) (everything bad): at loose
        # objectives the standard thresholds would be unreachable — a
        # class burning its ENTIRE budget must page regardless, so the
        # thresholds clamp to the achievable range
        ceiling = burn_rate(1.0, self.specs[name].objective)
        return {
            "fast": fast, "slow": slow,
            "status": status_from_burn(
                fast["burn"], slow["burn"],
                page=min(PAGE_BURN, ceiling),
                warn=min(WARN_BURN, ceiling / 2.0),
            ),
        }

    def tail_attribution(self, name: str, q: float = 0.99) -> dict | None:
        with self._lock:
            samples = list(self._stage_samples[name])
        return tail_attribution(samples, q=q)

    def report(self) -> dict:
        """Per-class machine-readable summary — the bench/CI artifact and
        the shape ``MergedView.report()`` mirrors fleet-wide."""
        out: dict = {}
        for name, spec in self.specs.items():
            row: dict = {
                "objective": spec.objective,
                "requests": self.requests[name],
                "good_requests": self.good_requests[name],
                "sli": {},
            }
            worst = "ok"
            for sli in spec.budgeted_slis():
                st = self.status(name, sli)
                state = self._sli[(name, sli)]
                row["sli"][sli] = {
                    "budget_ms": spec.budget_ms(sli),
                    "good_total": state.good_total,
                    "total": state.total,
                    "fast_burn": round(st["fast"]["burn"], 4),
                    "slow_burn": round(st["slow"]["burn"], 4),
                    "status": st["status"],
                }
                if STATUS_LEVELS[st["status"]] > STATUS_LEVELS[worst]:
                    worst = st["status"]
            row["status"] = worst
            tail = self.tail_attribution(name)
            if tail is not None:
                row["tail"] = tail
            out[name] = row
        return out

    # -- registry export ---------------------------------------------------

    def _export(self, name: str, spec: SLOSpec, verdicts: dict,
                all_good: bool) -> None:
        if not self._obs.enabled:
            return
        self._b_requests[name].inc()
        if all_good:
            self._b_good[name].inc()
        for sli, good in verdicts.items():
            self._b_sli[(name, sli, "good" if good else "bad")].inc()
        # gauges recompute at most ~4x/s per class on the harvest path;
        # scrapes force a fresh export via the registry collect hook
        self.export_gauges(name)

    def export_gauges(self, name: str | None = None,
                      force: bool = False) -> None:
        """Recompute the burn-rate/status gauges for ``name`` (or every
        class). Throttled to ~4x/s per class — the harvest path must not
        pay a full status recompute per retired request — and refreshed
        by every exposition via the registry collect hook (same
        throttle): the rolling windows drain with the CLOCK, so a gauge
        is stale the moment traffic stops, not just when a record is
        missed; a scrape sees status at most 250 ms old instead of
        frozen-at-last-burst forever."""
        if not self._obs.enabled:
            return
        now = self._clock()
        for cls in ((name,) if name is not None else tuple(self.specs)):
            spec = self.specs[cls]
            last = self._last_gauge_export.get(cls)
            if not force and last is not None and now - last < 0.25:
                continue
            self._last_gauge_export[cls] = now
            self._g_objective.set(spec.objective, slo=cls)
            for sli in spec.budgeted_slis():
                st = self.status(cls, sli)
                for window, b in (("fast", st["fast"]), ("slow", st["slow"])):
                    self._g_burn.set(round(b["burn"], 6), slo=cls, sli=sli,
                                     window=window)
                self._g_status.set(STATUS_LEVELS[st["status"]],
                                   slo=cls, sli=sli)

