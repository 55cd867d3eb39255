"""Background commit thread for async checkpoint saves — the counterpart of
``dsml_tpu/checkpoint/async_writer.py``, writing into the port's
observability core (``dsml_tpu_torch.obs``).

The save path splits in two: the SNAPSHOT (device→host copy,
``native.snapshot``) happens synchronously on the caller's thread — after it
returns, the training step is free to overwrite every source tensor in place —
and the COMMIT (file writes + atomic rename + garbage collection) runs here,
overlapping the next steps' compute. One worker thread, FIFO order, so saves
commit in submission order and ``max_to_keep`` GC never races a commit.

Errors from a background commit don't vanish: the first failure is held and
re-raised on the next :meth:`submit`, :meth:`wait`, or :meth:`close` — a
training loop that keeps calling ``save`` finds out about a full disk on the
very next save, not at shutdown.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from dsml_tpu_torch.obs import get_registry
from dsml_tpu_torch.obs import flight_recorder, hangwatch
from dsml_tpu_torch.obs.memory import get_memory_ledger
from dsml_tpu_torch.utils.logging import get_logger

log = get_logger("ckpt-writer")

# a background commit outliving this many seconds is suspect: wait() warns
# with queue depth + the in-flight label instead of blocking silently, and
# with DSML_HANGWATCH set the worker's armed deadline dumps stacks + bundle
DEFAULT_COMMIT_DEADLINE_S = 120.0


def _commit_deadline_s() -> float:
    try:
        v = float(os.environ.get("DSML_CKPT_COMMIT_DEADLINE_S",
                                 DEFAULT_COMMIT_DEADLINE_S))
    except ValueError:
        return DEFAULT_COMMIT_DEADLINE_S
    return v if v > 0 else DEFAULT_COMMIT_DEADLINE_S


class AsyncWriter:
    """Single-threaded FIFO job runner with sticky first-error propagation.

    Observability (the JAX package's ``docs/OBSERVABILITY.md``; no-op
    unless the registry is enabled): ``checkpoint_queue_depth`` gauge (jobs waiting + running),
    ``checkpoint_commit_ms`` histogram (per-job wall), and
    ``checkpoint_errors_total`` counter (background failures held for the
    caller — the sticky-error path is otherwise invisible until the next
    ``save``). Each commit lands a ``checkpoint_commit`` flight-recorder
    event, and a commit (or a ``wait()``) exceeding ``deadline_s`` logs a
    warning carrying the queue depth and the in-flight job's label — a
    full NFS mount blocks loudly instead of forever."""

    def __init__(self, name: str = "ckpt-writer",
                 deadline_s: float | None = None):
        self._name = name
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _commit_deadline_s())
        # host bytes of snapshots queued-or-committing (the memory the
        # async path STAGES between the device→host copy and the rename);
        # a ledger source + gauge so leaked staging shows up, not just
        # queue depth
        self._staged_nbytes = 0.0
        self._jobs: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._busy = False
        self._busy_since: float | None = None
        self._overdue_warned = False
        self._current_label: str | None = None
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._closed = False
        self._obs = get_registry()
        self._recorder = flight_recorder.get_flight_recorder()
        hw_cfg = hangwatch.config_from_env()
        self._hangwatch = hangwatch.get_hangwatch() if hw_cfg is not None else None
        # memory-ledger source: weakly held, dies with this writer
        get_memory_ledger(self._obs).register_source(
            "checkpoint_staging", self.staged_bytes,
            name=f"{self._name}/{id(self):x}",
        )

    def staged_bytes(self) -> float:
        """Host bytes of snapshots not yet committed (queued + in-flight)."""
        with self._lock:
            return self._staged_nbytes

    def _note_depth(self) -> None:
        # caller holds self._lock
        self._obs.gauge(
            "checkpoint_queue_depth", "async checkpoint jobs pending",
            labels=("writer",),
        ).set(len(self._jobs) + (1 if self._busy else 0), writer=self._name)
        self._obs.gauge(
            "checkpoint_staging_bytes",
            "host snapshot bytes awaiting background commit",
            labels=("writer",),
        ).set(self._staged_nbytes, writer=self._name)

    def submit(self, fn, label: str | None = None,
               nbytes: float = 0.0) -> None:
        """Queue ``fn()`` for background execution; raises any held error
        from a previous job first. ``label`` (e.g. ``"step 42"``) names the
        job in deadline warnings and flight-recorder events; ``nbytes`` is
        the staged payload the job holds until it completes (the ledger's
        ``checkpoint_staging`` accounting — released success or fail)."""
        self.check_error()
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncWriter is closed")
            # a commit wedged PAST its deadline would otherwise be silent
            # until wait(): the next save is the natural place to shout
            if (self._busy and self._busy_since is not None
                    and not self._overdue_warned
                    and time.monotonic() - self._busy_since > self.deadline_s):
                self._overdue_warned = True
                log.warning(
                    "commit %s still running after %.0fs (deadline %.0fs, "
                    "%d queued behind it) — storage may be wedged",
                    self._current_label or "?",
                    time.monotonic() - self._busy_since, self.deadline_s,
                    len(self._jobs),
                )
            self._jobs.append((fn, label, float(max(nbytes, 0.0))))
            self._staged_nbytes += float(max(nbytes, 0.0))
            self._note_depth()
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._idle.notify_all()

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._jobs and not self._closed:
                    self._idle.wait(timeout=1.0)
                if not self._jobs:
                    return  # closed and drained
                fn, label, job_nbytes = self._jobs.popleft()
                self._busy = True
                self._busy_since = time.monotonic()
                self._overdue_warned = False
                self._current_label = label
                depth = len(self._jobs) + 1
                self._note_depth()
            hw_token = (
                self._hangwatch.arm(
                    "checkpoint_commit", self.deadline_s,
                    label=label or "?", queue_depth=depth, writer=self._name,
                )
                if self._hangwatch is not None else None
            )
            t0 = time.perf_counter()
            ok = True
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — held for the caller
                ok = False
                self._obs.counter(
                    "checkpoint_errors_total",
                    "background checkpoint commit failures (held sticky)",
                    labels=("writer",),
                ).inc(writer=self._name)
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                if hw_token is not None:
                    self._hangwatch.disarm(hw_token)
                wall_ms = (time.perf_counter() - t0) * 1e3
                self._obs.histogram(
                    "checkpoint_commit_ms", "background commit wall time",
                    labels=("writer",),
                ).observe(wall_ms, writer=self._name)
                self._recorder.record(
                    "checkpoint_commit", writer=self._name,
                    label=label or "?", ms=round(wall_ms, 3), ok=ok,
                )
                with self._lock:
                    queued_behind = len(self._jobs)
                    self._busy = False
                    self._busy_since = None
                    self._current_label = None
                    # the snapshot is durable (or dead) either way — its
                    # host bytes are no longer staged
                    self._staged_nbytes = max(
                        self._staged_nbytes - job_nbytes, 0.0)
                    self._note_depth()
                    self._idle.notify_all()
                if wall_ms > self.deadline_s * 1e3:
                    log.warning(
                        "commit %s took %.1fs (deadline %.0fs, %d queued "
                        "behind it) — storage is falling behind the save "
                        "cadence", label or "?", wall_ms / 1e3,
                        self.deadline_s, queued_behind,
                    )

    def check_error(self) -> None:
        """Re-raise (and clear) the held first error, non-blocking."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Block until every submitted job has finished; re-raise the first
        failure. A wait outliving ``deadline_s`` is never silent: each
        elapsed deadline logs a warning naming the in-flight job and the
        queue depth (the commit-deadline sentinel), so an
        operator tailing the log sees WHAT the shutdown is stuck on."""
        t0 = time.monotonic()
        warned = 0
        with self._lock:
            while self._jobs or self._busy:
                self._idle.wait(timeout=self.deadline_s)
                elapsed = time.monotonic() - t0
                if ((self._jobs or self._busy)
                        and elapsed >= self.deadline_s * (warned + 1)):
                    warned += 1
                    label = self._current_label
                    depth = len(self._jobs) + (1 if self._busy else 0)
                    log.warning(
                        "wait(): still blocked after %.0fs on commit %s "
                        "(%d job(s) outstanding; deadline %.0fs)",
                        elapsed, label or "?", depth, self.deadline_s,
                    )
        self.check_error()

    def pending(self) -> int:
        with self._lock:
            return len(self._jobs) + (1 if self._busy else 0)

    def close(self) -> None:
        """Drain the queue, surface any held error, and stop the thread."""
        try:
            self.wait()
        finally:
            with self._lock:
                self._closed = True
                self._idle.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
