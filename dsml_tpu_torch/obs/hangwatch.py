"""Hang/straggler detection: a deadline watchdog for the paths that wedge —
the port's copy of ``dsml_tpu/obs/hangwatch.py`` (pure Python).

A collective that never completes doesn't crash — it sits. The reference
coordinator's health loop catches DEAD devices (probe timeout) but a
wedged-yet-alive one keeps answering probes while the training step
blocks forever. This module is the missing deadline layer:

- :class:`HangWatch` — one daemon watchdog thread per instance; callers
  **arm** a named deadline around a blocking operation and **disarm** it
  on completion. On expiry the watchdog dumps all-thread Python stacks
  plus a full flight-recorder postmortem bundle (reason ``hang_<name>``),
  increments ``hang_suspected_total{watcher}``, and logs the armed
  context. Expiry fires ONCE per armed token — a genuinely hung process
  leaves exactly one bundle, then the operator's stack dump shows where.
- :class:`TrailingDeadline` — turns observed durations into a deadline:
  ``k × trailing-median`` with a floor, ``None`` until enough samples
  exist (compile-skewed first steps must not set the bar).

Wired call site: the trainer arms per loss-sync window (k×
trailing-median window wall — the only point its loop truly blocks under
asynchronous launches). The JAX package's coordinator (per wire op) and
async checkpoint writer (per commit) come with ROADMAP.md queue 1, items
14 and 9. All of it is off unless ``DSML_HANGWATCH`` is set: ``1`` enables
the default multiplier (10×), a number sets the multiplier itself.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import statistics
import threading
import time

from dsml_tpu_torch.obs import flight_recorder
from dsml_tpu_torch.obs.registry import Registry, get_registry
from dsml_tpu_torch.utils.logging import get_logger

__all__ = [
    "HangWatch",
    "TrailingDeadline",
    "HangWatchConfig",
    "get_hangwatch",
    "config_from_env",
]

log = get_logger("hangwatch")

DEFAULT_MULTIPLIER = 10.0


@dataclasses.dataclass(frozen=True)
class HangWatchConfig:
    multiplier: float = DEFAULT_MULTIPLIER  # deadline = multiplier × median
    floor_s: float = 1.0                    # never arm tighter than this
    min_samples: int = 5                    # observations before arming


def config_from_env(spec: str | None = None) -> HangWatchConfig | None:
    """``DSML_HANGWATCH``: unset/``0`` → ``None`` (off); ``1`` → default
    10× multiplier; a number → that multiplier."""
    if spec is None:
        spec = os.environ.get("DSML_HANGWATCH", "")
    spec = spec.strip().lower()
    if spec in ("", "0", "false", "off"):
        return None
    if spec in ("1", "true", "on"):
        return HangWatchConfig()
    try:
        mult = float(spec)
    except ValueError as e:
        raise ValueError(
            f"DSML_HANGWATCH={spec!r} is neither a flag nor a multiplier"
        ) from e
    if mult <= 0:
        raise ValueError(f"DSML_HANGWATCH multiplier must be positive, got {mult}")
    return HangWatchConfig(multiplier=mult)


class TrailingDeadline:
    """k × trailing-median duration, floored; ``None`` until warmed up."""

    def __init__(self, multiplier: float = DEFAULT_MULTIPLIER,
                 floor_s: float = 1.0, window: int = 64, min_samples: int = 5):
        self.multiplier = float(multiplier)
        self.floor_s = float(floor_s)
        self.min_samples = max(int(min_samples), 1)
        self._lock = threading.Lock()
        self._walls: collections.deque = collections.deque(maxlen=window)

    @classmethod
    def from_config(cls, cfg: HangWatchConfig, floor_s: float | None = None,
                    window: int = 64) -> "TrailingDeadline":
        return cls(multiplier=cfg.multiplier,
                   floor_s=cfg.floor_s if floor_s is None else floor_s,
                   window=window, min_samples=cfg.min_samples)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._walls.append(float(seconds))

    def timeout_s(self) -> float | None:
        with self._lock:
            if len(self._walls) < self.min_samples:
                return None
            median = statistics.median(self._walls)
        return max(self.multiplier * median, self.floor_s)


class _Armed:
    __slots__ = ("token", "name", "deadline", "timeout_s", "info", "thread")

    def __init__(self, token, name, deadline, timeout_s, info, thread):
        self.token = token
        self.name = name
        self.deadline = deadline
        self.timeout_s = timeout_s
        self.info = info
        self.thread = thread


class HangWatch:
    """Armable-deadline watchdog; the worker thread starts lazily on the
    first :meth:`arm` and sleeps on a condition between deadlines."""

    def __init__(self, registry: Registry | None = None,
                 recorder: "flight_recorder.FlightRecorder | None" = None,
                 clock=time.monotonic, name: str = "hangwatch"):
        self.registry = registry if registry is not None else get_registry()
        self.recorder = (recorder if recorder is not None
                         else flight_recorder.get_flight_recorder())
        self._clock = clock
        self._name = name
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._armed: dict[int, _Armed] = {}
        self._tokens = itertools.count(1)
        self._thread: threading.Thread | None = None
        self._next_wake: float | None = None  # when the worker will look next
        self._closed = False
        self.fired: list[dict] = []

    def arm(self, name: str, timeout_s: float, **info) -> int:
        """Start a deadline; returns a token for :meth:`disarm`. The armed
        record remembers the calling thread so the expiry dump can point
        at the stack that is actually stuck."""
        timeout_s = float(timeout_s)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self._name} is closed")
            token = next(self._tokens)
            deadline = self._clock() + timeout_s
            self._armed[token] = _Armed(
                token, name, deadline, timeout_s, info,
                threading.current_thread().name,
            )
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            # wake the worker ONLY when this deadline lands before its next
            # scheduled look — the hot arm/disarm-per-step path must not pay
            # a futex wake + context switch per call
            if self._next_wake is None or deadline < self._next_wake:
                self._wake.notify_all()
        return token

    def disarm(self, token: int) -> None:
        """Cancel an armed deadline (completing after expiry is fine — the
        token is already gone and this is a no-op). Never wakes the worker:
        a stale scheduled look finds nothing expired and goes back to
        sleep, which is cheaper than a wake per disarm."""
        with self._lock:
            self._armed.pop(token, None)

    def watching(self, name: str, timeout_s: float, **info):
        """``with hw.watching("wire_op", 5.0): ...`` arm/disarm guard."""
        return _WatchContext(self, name, timeout_s, info)

    def armed_count(self) -> int:
        with self._lock:
            return len(self._armed)

    def close(self) -> None:
        """Stop the worker (tests/bench teardown; the process-default
        instance just dies with the process)."""
        with self._lock:
            self._closed = True
            self._armed.clear()
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
                now = self._clock()
                expired = [a for a in self._armed.values() if a.deadline <= now]
                for a in expired:
                    del self._armed[a.token]
                if not expired:
                    nxt = min(
                        (a.deadline for a in self._armed.values()), default=None
                    )
                    # bounded sleep even when idle so close() can't race a
                    # missed notify into a stuck join
                    wait_s = min(nxt - now, 60.0) if nxt is not None else 60.0
                    self._next_wake = now + wait_s
                    self._wake.wait(timeout=wait_s)
                    self._next_wake = None
                    continue
            for a in expired:
                self._fire(a)

    def _fire(self, a: _Armed) -> None:
        info = {
            "watcher": a.name, "timeout_s": round(a.timeout_s, 3),
            "armed_by_thread": a.thread,
            **{k: str(v) for k, v in a.info.items()},
        }
        log.error(
            "hangwatch: %r exceeded its %.3fs deadline (armed by thread %s; "
            "context %s) — dumping stacks + postmortem bundle",
            a.name, a.timeout_s, a.thread, a.info,
        )
        self.registry.counter(
            "hang_suspected_total", "deadline-watchdog expiries",
            labels=("watcher",),
        ).inc(watcher=a.name)
        self.recorder.record("hang_suspected", **info)
        bundle = None
        try:
            bundle = self.recorder.dump(f"hang_{a.name}", extra=info)
            log.error("hangwatch: bundle at %s", bundle)
        except Exception:  # noqa: BLE001 — the watchdog must survive
            pass
        with self._lock:
            self.fired.append({**info, "bundle": bundle})


class _WatchContext:
    def __init__(self, hw: HangWatch, name: str, timeout_s: float, info: dict):
        self._hw = hw
        self._args = (name, timeout_s, info)
        self._token: int | None = None

    def __enter__(self):
        name, timeout_s, info = self._args
        self._token = self._hw.arm(name, timeout_s, **info)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            self._hw.disarm(self._token)
        return False


_default: HangWatch | None = None
_default_lock = threading.Lock()


def get_hangwatch() -> HangWatch:
    """The process-default watchdog (bound to the default registry)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = HangWatch()
    return _default
