"""Per-step breakdown + goodput/MFU accounting — the port's copy of
``dsml_tpu/obs/step_stats.py``.

- :class:`StepBreakdown` — where a step's wall time goes: ``data`` /
  ``forward_backward`` / ``grad_sync`` / ``optimizer`` /
  ``checkpoint_stall`` (the canonical phases; arbitrary names accepted).
  The trainer records ``data`` + ``step_dispatch`` + ``loss_sync``: its
  step launches its work asynchronously and blocks only at loss syncs.
- :class:`GoodputTracker` — productive step time ÷ wall time across
  preemption/restore events: every second spent re-doing work after a
  restore, blocked on a checkpoint, or idle between epochs shows up as the
  gap between the two.
- :func:`mfu` — achieved model FLOP/s ÷ the card's peak, with the FLOP
  numerators computed analytically by ``models.common``
  (``transformer_train_flops``).

Everything here is clock arithmetic but :meth:`StepBreakdown.phase`'s
``fence=``, which synchronises the CUDA streams of its tensors
(``spans.synchronize``) when the registry is enabled. ``clock=`` is
injectable for deterministic tests.
"""

from __future__ import annotations

import contextlib
import threading
import time

from dsml_tpu_torch.obs.registry import Registry, get_registry
from dsml_tpu_torch.obs.spans import synchronize

__all__ = ["StepBreakdown", "GoodputTracker", "mfu", "STEP_PHASES"]

# the canonical phase taxonomy of the JAX package; add() accepts any name
STEP_PHASES = (
    "data", "forward_backward", "grad_sync", "optimizer", "checkpoint_stall",
)


class StepBreakdown:
    """Accumulates per-phase seconds and per-step walls; thread-safe."""

    def __init__(self, registry: Registry | None = None,
                 clock=time.perf_counter):
        self.registry = registry if registry is not None else get_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._phase_s: dict[str, float] = {}
        self._phase_n: dict[str, int] = {}
        self._step_wall_s = 0.0
        self._steps = 0
        self._hist = self.registry.histogram(
            "step_phase_ms", "per-step phase durations", labels=("phase",)
        )

    def add(self, phase: str, seconds: float) -> None:
        """Record ``seconds`` spent in ``phase`` (explicit form — the hot
        loop reads the clock itself and pays no context-manager frames)."""
        with self._lock:
            self._phase_s[phase] = self._phase_s.get(phase, 0.0) + seconds
            self._phase_n[phase] = self._phase_n.get(phase, 0) + 1
        self._hist.observe(seconds * 1e3, phase=phase)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = self._clock()
        try:
            yield self
        finally:
            if fence is not None and self.registry.enabled:
                synchronize(fence)
            self.add(name, self._clock() - t0)

    @contextlib.contextmanager
    def step(self):
        """Wrap one whole step; its wall time is the coverage denominator."""
        t0 = self._clock()
        try:
            yield self
        finally:
            with self._lock:
                self._step_wall_s += self._clock() - t0
                self._steps += 1

    def note_step_wall(self, seconds: float) -> None:
        with self._lock:
            self._step_wall_s += seconds
            self._steps += 1

    def summary(self) -> dict:
        """Per-phase totals/means plus ``coverage_pct`` — how much of the
        measured step wall the recorded phases account for (100% means the
        breakdown explains the whole step; the JAX bench's obs section
        requires >= 95%)."""
        with self._lock:
            phases = {
                name: {
                    "total_s": round(total, 6),
                    "mean_ms": round(total / max(self._phase_n[name], 1) * 1e3, 3),
                    "count": self._phase_n[name],
                }
                for name, total in self._phase_s.items()
            }
            wall, steps = self._step_wall_s, self._steps
        phase_sum = sum(p["total_s"] for p in phases.values())
        out = {
            "phases": phases,
            "phase_sum_s": round(phase_sum, 6),
            "steps": steps,
            "step_wall_s": round(wall, 6),
        }
        if wall > 0:
            out["step_wall_mean_ms"] = round(wall / max(steps, 1) * 1e3, 3)
            out["coverage_pct"] = round(100.0 * phase_sum / wall, 2)
        return out


class GoodputTracker:
    """Productive-time ÷ wall-time accounting across preemptions/restores.

    ``wall`` runs from construction (or the injected clock's first read);
    ``productive`` accumulates only inside :meth:`productive` blocks (or
    explicit :meth:`add_productive` seconds). Preemption/restore/save
    events are timestamped marks, so the exported record shows WHERE the
    non-productive time went. A preempted-and-restarted run carries its
    prior productive seconds forward via ``carry_s`` — goodput then spans
    the whole job, not just the current incarnation.
    """

    def __init__(self, registry: Registry | None = None,
                 clock=time.monotonic, carry_s: float = 0.0):
        self.registry = registry if registry is not None else get_registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._productive_s = float(carry_s)
        self.events: list[dict] = []

    @contextlib.contextmanager
    def productive(self):
        t0 = self._clock()
        try:
            yield self
        finally:
            self.add_productive(self._clock() - t0)

    def add_productive(self, seconds: float) -> None:
        with self._lock:
            self._productive_s += seconds

    def mark(self, event: str, **info) -> None:
        """Timestamp a lifecycle event (``preemption`` / ``restore`` /
        ``checkpoint_save`` / ``checkpoint_gc`` ...)."""
        rec = {"event": event, "t_s": round(self._clock() - self._t0, 6), **info}
        with self._lock:
            self.events.append(rec)
        self.registry.counter(
            "goodput_events_total", "goodput lifecycle events", labels=("event",)
        ).inc(event=event)

    @property
    def wall_s(self) -> float:
        return self._clock() - self._t0

    @property
    def productive_s(self) -> float:
        with self._lock:
            return self._productive_s

    def goodput(self) -> float:
        """productive / wall in [0, 1] (0 when no wall has elapsed)."""
        wall = self.wall_s
        if wall <= 0:
            return 0.0
        return min(self.productive_s / wall, 1.0)

    def summary(self) -> dict:
        g = self.goodput()
        self.registry.gauge("goodput_ratio", "productive/wall").set(g)
        with self._lock:
            events = list(self.events)
        return {
            "wall_s": round(self.wall_s, 6),
            "productive_s": round(self.productive_s, 6),
            "goodput": round(g, 4),
            "events": events,
        }


def mfu(achieved_flops_per_s: float, peak_flops_per_s: float | None) -> float | None:
    """Model FLOPs utilization: achieved ÷ peak (None when the chip's peak
    is unknown — never guess a denominator)."""
    if not peak_flops_per_s or peak_flops_per_s <= 0:
        return None
    return achieved_flops_per_s / peak_flops_per_s
