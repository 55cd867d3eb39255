"""Training-health sentinels: NaN/Inf loss, grad-norm blowup, loss spikes —
the port's copy of ``dsml_tpu/obs/sentinels.py`` (pure Python).

Pod-scale practice loses more runs to silent numeric blowups than to
clean crashes: a NaN at step k quietly poisons every later step and the
job burns its allocation emitting garbage. These sentinels watch the
values the step ALREADY produces — the trainer checks them at its
existing ``loss_sync`` point, so the fused step gains **no extra
device→host syncs** (the loss scalar is already on the host there).

Three sentinels, each with its own policy:

===========  ==========================================================
sentinel     trips when
===========  ==========================================================
nonfinite    the synced loss (or a provided grad norm) is NaN/±Inf
spike        the loss's z-score over a trailing window exceeds
             ``spike_z`` (after ``spike_min_steps`` warmup samples)
gradnorm     a provided global grad norm exceeds ``gradnorm_max``
===========  ==========================================================

Policies: ``off`` | ``warn`` (log + count) | ``dump`` (also write a
flight-recorder postmortem bundle, once per sentinel) | ``halt`` (dump,
then raise :class:`SentinelTripped` so the run stops AT the failure with
the bundle on disk instead of hours later with a truncated log).

Configured via ``DSML_SENTINELS``: unset/``0`` disables; ``1`` enables
the defaults (``nonfinite=halt,spike=warn,gradnorm=warn``); a bare
policy name applies to every sentinel; ``name=policy,...`` sets them
individually. Every trip increments
``sentinel_trips_total{sentinel,policy}``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading

from dsml_tpu_torch.obs import flight_recorder
from dsml_tpu_torch.obs.registry import Registry, get_registry
from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "SentinelTripped",
    "SentinelConfig",
    "TrainingSentinels",
    "SENTINELS",
    "POLICIES",
]

log = get_logger("sentinels")

SENTINELS = ("nonfinite", "spike", "gradnorm")
POLICIES = ("off", "warn", "dump", "halt")


class SentinelTripped(RuntimeError):
    """A ``halt``-policy sentinel fired. Carries the bundle path so the
    catcher (or the operator reading the traceback) finds the postmortem."""

    def __init__(self, sentinel: str, message: str, bundle: str | None = None):
        super().__init__(message)
        self.sentinel = sentinel
        self.bundle = bundle


@dataclasses.dataclass
class SentinelConfig:
    nonfinite: str = "halt"
    spike: str = "warn"
    gradnorm: str = "warn"
    spike_z: float = 6.0        # z-score threshold over the trailing window
    spike_window: int = 64      # trailing losses kept
    spike_min_steps: int = 16   # warmup before the z-score is trusted
    gradnorm_max: float = 1e4   # absolute global-grad-norm ceiling

    def __post_init__(self):
        for name in SENTINELS:
            policy = getattr(self, name)
            if policy not in POLICIES:
                raise ValueError(
                    f"sentinel {name}: unknown policy {policy!r} "
                    f"(choose from {POLICIES})"
                )

    @classmethod
    def from_env(cls, spec: str | None = None) -> "SentinelConfig | None":
        """Parse ``DSML_SENTINELS`` (or an explicit ``spec``). Returns
        ``None`` when sentinels are disabled."""
        if spec is None:
            spec = os.environ.get("DSML_SENTINELS", "")
        spec = spec.strip()
        if spec.lower() in ("", "0", "false", "off"):
            return None
        if spec.lower() in ("1", "true", "on"):
            return cls()
        if spec in POLICIES:
            return cls(nonfinite=spec, spike=spec, gradnorm=spec)
        kv = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"DSML_SENTINELS entry {part!r} is neither a policy "
                    f"({POLICIES}) nor name=policy"
                )
            name, _, policy = part.partition("=")
            name, policy = name.strip(), policy.strip()
            if name in ("spike_z", "gradnorm_max"):
                kv[name] = float(policy)
            elif name in ("spike_window", "spike_min_steps"):
                kv[name] = int(policy)
            elif name in SENTINELS:
                kv[name] = policy
            else:
                raise ValueError(
                    f"DSML_SENTINELS names unknown sentinel {name!r} "
                    f"(choose from {SENTINELS})"
                )
        return cls(**kv)


class TrainingSentinels:
    """Stateful checker; one instance per training run (thread-safe).

    ``check(step, loss, grad_norm=None)`` is the whole API: call it with
    host floats at a point where they are already synced. Policies
    ``dump``/``halt`` write a flight-recorder bundle (at most one dump per
    sentinel per run — a NaN that poisons every later loss must not fill
    the disk with identical bundles).
    """

    def __init__(self, config: SentinelConfig | None = None,
                 registry: Registry | None = None,
                 recorder: "flight_recorder.FlightRecorder | None" = None):
        self.config = config if config is not None else SentinelConfig()
        self.registry = registry if registry is not None else get_registry()
        self.recorder = (recorder if recorder is not None
                         else flight_recorder.get_flight_recorder())
        self._lock = threading.Lock()
        # trailing window with RUNNING sum/sum-of-squares: the z-score is
        # O(1) per check, not O(window) — this sits on the per-step path
        self._window: collections.deque = collections.deque(
            maxlen=max(self.config.spike_window, 2)
        )
        self._win_sum = 0.0
        self._win_sumsq = 0.0
        self._dumped: set[str] = set()
        self.trips: list[dict] = []

    @classmethod
    def maybe_from_env(cls, registry: Registry | None = None,
                       recorder=None) -> "TrainingSentinels | None":
        """The trainer's hook: an instance when ``DSML_SENTINELS`` asks for
        one, else ``None`` (zero per-step cost)."""
        cfg = SentinelConfig.from_env()
        if cfg is None:
            return None
        return cls(cfg, registry=registry, recorder=recorder)

    # -- the check ---------------------------------------------------------

    def check(self, step: int, loss: float, grad_norm: float | None = None) -> None:
        """Inspect one step's host-side values; raises
        :class:`SentinelTripped` under a ``halt`` policy."""
        cfg = self.config
        loss = float(loss)
        if not math.isfinite(loss):
            self._trip("nonfinite", step,
                       f"loss is {loss!r} at step {step}", loss=loss)
        else:
            with self._lock:
                z = self._zscore_locked(loss)
                if len(self._window) == self._window.maxlen:
                    old = self._window[0]  # about to be evicted by append
                    self._win_sum -= old
                    self._win_sumsq -= old * old
                self._window.append(loss)
                self._win_sum += loss
                self._win_sumsq += loss * loss
            if z > cfg.spike_z:
                self._trip(
                    "spike", step,
                    f"loss {loss:.6g} is {z:.1f} sigma above the trailing "
                    f"mean at step {step}", loss=loss, z=round(z, 2),
                )
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if not math.isfinite(grad_norm):
                self._trip("nonfinite", step,
                           f"global grad norm is {grad_norm!r} at step {step}",
                           grad_norm=grad_norm)
            elif grad_norm > cfg.gradnorm_max:
                self._trip(
                    "gradnorm", step,
                    f"global grad norm {grad_norm:.6g} exceeds "
                    f"{cfg.gradnorm_max:.6g} at step {step}",
                    grad_norm=grad_norm,
                )

    def _zscore_locked(self, loss: float) -> float:
        """z-score of ``loss`` against the trailing window (0 before the
        warmup fills). Caller holds ``self._lock``."""
        n = len(self._window)
        if n < max(self.config.spike_min_steps, 2):
            return 0.0
        mean = self._win_sum / n
        var = max(self._win_sumsq / n - mean * mean, 0.0)
        return (loss - mean) / max(math.sqrt(var), 1e-12)

    def spike_zscore(self, loss: float) -> float:
        """The z-score ``check`` would compute for ``loss`` right now —
        including the warmup guard (0.0 until ``spike_min_steps`` samples).
        Read-only; exposed for tests pinning the math."""
        with self._lock:
            return self._zscore_locked(float(loss))

    # -- policy execution --------------------------------------------------

    def _trip(self, sentinel: str, step: int, message: str, **info) -> None:
        policy = getattr(self.config, sentinel)
        if policy == "off":
            return
        rec = {"sentinel": sentinel, "policy": policy, "step": step,
               "message": message, **info}
        with self._lock:
            self.trips.append(rec)
        self.registry.counter(
            "sentinel_trips_total", "training-health sentinel trips",
            labels=("sentinel", "policy"),
        ).inc(sentinel=sentinel, policy=policy)
        self.recorder.record("sentinel_trip", **rec)
        log.warning("sentinel %s [%s]: %s", sentinel, policy, message)
        bundle = None
        if policy in ("dump", "halt"):
            with self._lock:
                first = sentinel not in self._dumped
                self._dumped.add(sentinel)
            if first:
                bundle = self.recorder.dump(f"sentinel_{sentinel}", extra=rec)
                log.warning("sentinel %s: postmortem bundle at %s",
                            sentinel, bundle)
        if policy == "halt":
            raise SentinelTripped(sentinel, message, bundle=bundle)
