"""Flight recorder: a bounded ring of recent events + postmortem bundles —
the port of ``dsml_tpu/obs/flight_recorder.py``.

The obs registry answers "how fast are we?"; this module answers "why did
the run die at 3am?". Every hot path appends small structured events
(step results, span closes, collective plans, serving admissions and
retirements) into a bounded, thread-safe ring buffer — a few µs
per event, nothing when the registry is disabled — and on failure the
recorder dumps a SELF-CONTAINED postmortem bundle: the trailing events,
the full registry snapshot, the Chrome span trace, a config/mesh/env
fingerprint, the log tail (``utils.logging`` ring handler), and Python
stack dumps of every live thread.

Bundles land in ``DSML_POSTMORTEM_DIR`` (default ``postmortem/``), one
directory per dump::

    postmortem/20260804T031502_12345_unhandled_exception_1/
        MANIFEST.json       # reason, time, exception, file inventory
        events.jsonl        # the ring buffer, oldest → newest
        registry.json       # Registry.collect() snapshot
        trace.json          # SpanTracer.chrome_trace()
        fingerprint.json    # python/torch/env/argv/CUDA devices and card
        stacks.txt          # all-thread Python stacks
        log_tail.jsonl      # last N log records
        memory.json         # the memory ledger's snapshot and watermarks

Dump triggers — installed by :func:`install` (which ``obs.enable()``
calls) and removed by :func:`uninstall`:

- unhandled exceptions (``sys.excepthook`` + ``threading.excepthook``,
  chaining to the previous hooks);
- SIGTERM — the preemption signal — chaining to the prior handler so the
  process still terminates;
- hard crashes via ``faulthandler`` into ``<dir>/faulthandler.log``;
- on demand (:meth:`FlightRecorder.dump`), which also backs the sentinel
  ``dump``/``halt`` policies and the hangwatch expiry path.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import re
import signal
import sys
import threading
import time
import traceback

from dsml_tpu_torch.obs.registry import Registry, get_registry

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "record",
    "install",
    "uninstall",
    "installed",
    "postmortem_dir",
]

DEFAULT_CAPACITY = 2048


def postmortem_dir() -> str:
    """Where bundles go: ``DSML_POSTMORTEM_DIR`` or ``./postmortem``."""
    return os.environ.get("DSML_POSTMORTEM_DIR", "postmortem")


def _event_capacity() -> int:
    try:
        cap = int(os.environ.get("DSML_FLIGHT_EVENTS", DEFAULT_CAPACITY))
    except ValueError:
        return DEFAULT_CAPACITY
    return cap if cap > 0 else DEFAULT_CAPACITY


def _all_thread_stacks() -> str:
    """Python stacks of every live thread, newest frame last — the
    ``py-spy dump`` a postmortem needs when the process is already gone."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        lines.extend(ln.rstrip("\n") for ln in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


def _fingerprint() -> dict:
    """Config/env identity of the process. ``torch.__version__`` always;
    CUDA facts (the toolkit, the devices, the card's name and power limit
    as ``nvidia-smi`` gives them) ONLY when CUDA is already initialised in
    this process — a dump must never initialise it (a wedged CUDA context
    is one of the hangs it exists to document)."""
    import torch

    fp = {
        "python": sys.version,
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "pid": os.getpid(),
        "torch_version": torch.__version__,
        "env": {
            k: v for k, v in sorted(os.environ.items())
            if k.startswith(("DSML_", "CUDA_", "PYTORCH_", "TORCH_", "NCCL_", "BENCH_"))
        },
    }
    if torch.cuda.is_initialized():
        fp["cuda_version"] = torch.version.cuda
        try:
            n = torch.cuda.device_count()
            fp["devices"] = {"count": n, "platform": "cuda",
                             "names": [torch.cuda.get_device_name(i) for i in range(n)]}
        except Exception as e:  # noqa: BLE001 — the CUDA context may be half-dead
            fp["devices"] = {"error": repr(e)[:200]}
        try:
            from dsml_tpu_torch.utils.platform import card_name_and_power_limit

            fp["card"] = card_name_and_power_limit()
        except Exception as e:  # noqa: BLE001 — no nvidia-smi, or it failed
            fp["card_error"] = repr(e)[:200]
    return fp


def _sanitize(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", reason)[:64] or "dump"


class FlightRecorder:
    """Bounded thread-safe event ring + bundle writer.

    :meth:`record` is the hot-path write: one enabled-check, then a dict
    build and a deque append under a lock. :meth:`dump` always works —
    even with the registry disabled an explicit dump writes whatever is
    buffered (possibly nothing) plus the live snapshots.
    """

    def __init__(self, capacity: int | None = None,
                 registry: Registry | None = None,
                 directory: str | None = None):
        self.registry = registry if registry is not None else get_registry()
        # instance-level default bundle dir (None = DSML_POSTMORTEM_DIR,
        # read at dump time so the env var can change mid-run)
        self.directory = directory
        self._events: collections.deque = collections.deque(
            maxlen=capacity if capacity else _event_capacity()
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._dump_seq = 0

    @property
    def enabled(self) -> bool:
        return self.registry.enabled

    def record(self, kind: str, **fields) -> None:
        """Append one event; no-op (one branch) when the registry is off."""
        if not self.registry.enabled:
            return
        with self._lock:
            self._seq += 1
            self._events.append(
                {"seq": self._seq, "t": round(time.time(), 6),
                 "kind": kind, **fields}
            )

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- bundles -----------------------------------------------------------

    def dump(self, reason: str, exc: BaseException | None = None,
             directory: str | None = None, extra: dict | None = None) -> str:
        """Write a complete postmortem bundle; returns its directory.

        Never raises into the failing path it documents: per-file write
        errors are swallowed into the manifest's ``errors`` list (a broken
        disk must not mask the original crash)."""
        base = (directory if directory is not None
                else self.directory if self.directory is not None
                else postmortem_dir())
        with self._lock:
            self._dump_seq += 1
            n = self._dump_seq
        stamp = time.strftime("%Y%m%dT%H%M%S")
        path = os.path.join(
            base, f"{stamp}_{os.getpid()}_{_sanitize(reason)}_{n}"
        )
        os.makedirs(path, exist_ok=True)
        errors: list[str] = []

        def write(name: str, fn) -> None:
            try:
                with open(os.path.join(path, name), "w") as f:
                    fn(f)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{name}: {e!r}"[:300])

        events = self.events()
        write("events.jsonl", lambda f: f.writelines(
            json.dumps(e) + "\n" for e in events
        ))
        write("registry.json", lambda f: json.dump(
            self.registry.collect(), f, indent=1
        ))

        def write_trace(f):
            from dsml_tpu_torch.obs.spans import get_tracer

            json.dump(get_tracer().chrome_trace(), f)

        write("trace.json", write_trace)
        write("fingerprint.json", lambda f: json.dump(_fingerprint(), f, indent=1))
        write("stacks.txt", lambda f: f.write(_all_thread_stacks()))

        def write_memory(f):
            # the ledger snapshot + watermark timeline + live source
            # readings (page-pool state rides as the kv_pages details) —
            # resolved through THIS recorder's registry, so a private
            # bench recorder never leaks the process ledger's claims
            from dsml_tpu_torch.obs.memory import get_memory_ledger

            json.dump(get_memory_ledger(self.registry).snapshot(), f, indent=1)

        write("memory.json", write_memory)

        def write_log_tail(f):
            from dsml_tpu_torch.utils.logging import get_ring_handler

            handler = get_ring_handler()
            f.writelines(
                json.dumps(r) + "\n"
                for r in (handler.records() if handler is not None else [])
            )

        write("log_tail.jsonl", write_log_tail)

        manifest = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "event_count": len(events),
            "files": sorted(
                n for n in os.listdir(path) if n != "MANIFEST.json"
            ),
        }
        if exc is not None:
            manifest["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__
                ),
            }
        if extra:
            manifest["extra"] = extra
        if errors:
            manifest["errors"] = errors
        write("MANIFEST.json", lambda f: json.dump(manifest, f, indent=1))

        # count even on a disabled registry? No: the counter write itself
        # no-ops there, which is fine — the bundle on disk is the record.
        self.registry.counter(
            "postmortem_dumps_total", "postmortem bundles written",
            labels=("reason",),
        ).inc(reason=_sanitize(reason))
        return path


_default: FlightRecorder | None = None
_default_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-default recorder (bound to the default registry)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder()
    return _default


def record(kind: str, **fields) -> None:
    """``flight_recorder.record("step", step=k, ...)`` against the default
    recorder; one branch when observability is off."""
    get_flight_recorder().record(kind, **fields)


# ---------------------------------------------------------------------------
# crash-hook installation (sys.excepthook / threading.excepthook / SIGTERM /
# faulthandler) — obs.enable() installs, obs.disable() tears down
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()
_installed = False
_prev_excepthook = None
_prev_threading_hook = None
_prev_sigterm = None
_sigterm_hooked = False
_fault_file = None
_fault_was_enabled = False


def installed() -> bool:
    return _installed


def install(recorder: FlightRecorder | None = None) -> None:
    """Install the dump triggers. Idempotent; chains previous hooks so it
    composes with pytest / user handlers. Signal installation silently
    skips off the main thread (the interpreter forbids it there)."""
    global _installed, _prev_excepthook, _prev_threading_hook
    global _prev_sigterm, _sigterm_hooked, _fault_file, _fault_was_enabled
    with _install_lock:
        if _installed:
            return
        rec = recorder if recorder is not None else get_flight_recorder()

        _prev_excepthook = sys.excepthook

        def excepthook(etype, value, tb):
            try:
                e = value if isinstance(value, BaseException) else None
                # a SentinelTripped (or any bundle-carrying exception)
                # already wrote its postmortem at trip time — a second
                # near-identical unhandled_exception bundle is pure churn
                if getattr(e, "bundle", None) is None:
                    from dsml_tpu_torch.obs.memory import is_oom

                    # an OOM-shaped death is named as one, so the bundle
                    # directory itself says "memory" before anyone opens
                    # memory.json
                    rec.dump(
                        "resource_exhausted" if is_oom(e)
                        else "unhandled_exception",
                        exc=e,
                    )
            except Exception:  # noqa: BLE001 — never mask the real crash
                pass
            _prev_excepthook(etype, value, tb)

        sys.excepthook = excepthook

        _prev_threading_hook = threading.excepthook

        def thread_hook(args):
            try:
                rec.dump(
                    "thread_exception", exc=args.exc_value,
                    extra={"thread": getattr(args.thread, "name", "?")},
                )
            except Exception:  # noqa: BLE001
                pass
            _prev_threading_hook(args)

        threading.excepthook = thread_hook

        try:
            _prev_sigterm = signal.getsignal(signal.SIGTERM)

            def on_sigterm(signum, frame):
                try:
                    rec.dump("sigterm")
                except Exception:  # noqa: BLE001
                    pass
                prev = _prev_sigterm
                if callable(prev):
                    prev(signum, frame)
                elif prev is signal.SIG_IGN:
                    # the app deliberately ignores SIGTERM; dumping must not
                    # change that — bundle written, process lives on
                    return
                else:
                    # SIG_DFL (or an unknowable C-level handler): restore the
                    # default disposition and re-deliver so the exit status
                    # still says "killed by SIGTERM"
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_sigterm)
            _sigterm_hooked = True
        except ValueError:
            _sigterm_hooked = False  # not the main thread

        # hard-crash (segfault / fatal signal) C-level stacks: faulthandler
        # into a persistent file under the postmortem base dir
        try:
            base = postmortem_dir()
            os.makedirs(base, exist_ok=True)
            _fault_was_enabled = faulthandler.is_enabled()
            _fault_file = open(  # noqa: SIM115 — must outlive this frame
                os.path.join(base, "faulthandler.log"), "a"
            )
            faulthandler.enable(file=_fault_file)
        except OSError:
            _fault_file = None

        _installed = True


def uninstall() -> None:
    """Tear down cleanly: restore prior hooks/handlers, hand faulthandler
    back to whoever (e.g. pytest) had it enabled before."""
    global _installed, _prev_excepthook, _prev_threading_hook
    global _prev_sigterm, _sigterm_hooked, _fault_file
    with _install_lock:
        if not _installed:
            return
        sys.excepthook = _prev_excepthook
        threading.excepthook = _prev_threading_hook
        if _sigterm_hooked:
            try:
                signal.signal(signal.SIGTERM, _prev_sigterm)
            except ValueError:
                pass
            _sigterm_hooked = False
        if _fault_file is not None:
            if _fault_was_enabled:
                faulthandler.enable()  # back to stderr (pytest's setup)
            else:
                faulthandler.disable()
            _fault_file.close()
            _fault_file = None
        _prev_excepthook = _prev_threading_hook = _prev_sigterm = None
        _installed = False
