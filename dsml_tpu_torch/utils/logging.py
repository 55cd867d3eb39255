"""Structured logging for multi-process runs.

A copy of ``dsml_tpu.utils.logging`` (pure Python), kept here so that the
port imports nothing of the JAX package.

The reference logs with Go's stdlib ``log.Printf`` (SURVEY.md §5.5). Here every
process (coordinator, device host, trainer) gets a namespaced logger whose
records carry the process role (``DSML_ROLE``), so interleaved multi-host
logs stay attributable.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import threading
import time

_CONFIGURED = False

RING_CAPACITY = 512  # last-N log records kept for postmortem bundles


class _Formatter(logging.Formatter):
    def formatTime(self, record, datefmt=None):  # noqa: N802 (logging API)
        ct = time.localtime(record.created)
        return time.strftime("%Y/%m/%d %H:%M:%S", ct)


def configure(level: int = logging.INFO, stream=None) -> None:
    """Install the dsml log format on the root ``dsml`` logger once."""
    global _CONFIGURED
    root = logging.getLogger("dsml")
    if _CONFIGURED:
        root.setLevel(level)
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    role = os.environ.get("DSML_ROLE", "")
    role_tag = f" [{role}]" if role else ""
    handler.setFormatter(_Formatter(f"%(asctime)s{role_tag} %(name)s: %(message)s"))
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """Return a logger under the ``dsml`` namespace, configuring on first use."""
    configure(level=getattr(logging, os.environ.get("DSML_LOG_LEVEL", "INFO").upper(), logging.INFO))
    return logging.getLogger(f"dsml.{name}")


class RingBufferHandler(logging.Handler):
    """Keeps the last ``capacity`` records as structured dicts, so a
    postmortem bundle carries the log tail even when stdout/stderr are
    already gone (redirected, truncated, or swallowed by the scheduler).

    ``obs.enable()`` installs one on the ``dsml`` root logger; the flight
    recorder snapshots :meth:`records` into ``log_tail.jsonl``."""

    def __init__(self, capacity: int = RING_CAPACITY):
        super().__init__(level=logging.DEBUG)
        self._records: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1)
        )
        self._ring_lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            rec = {
                "t": round(record.created, 6),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
            if record.exc_info and record.exc_info[1] is not None:
                rec["exc"] = repr(record.exc_info[1])[:500]
        except Exception:  # noqa: BLE001 — a bad record must not recurse
            return
        with self._ring_lock:
            self._records.append(rec)

    def records(self) -> list[dict]:
        with self._ring_lock:
            return list(self._records)

    def clear(self) -> None:
        with self._ring_lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._ring_lock:
            return len(self._records)


_ring_handler: RingBufferHandler | None = None
_ring_lock = threading.Lock()


def install_ring_handler(capacity: int = RING_CAPACITY) -> RingBufferHandler:
    """Attach (once) a :class:`RingBufferHandler` to the ``dsml`` root
    logger and return it; idempotent — repeated calls return the existing
    handler (capacity is fixed by the first call)."""
    global _ring_handler
    with _ring_lock:
        if _ring_handler is None:
            configure(level=getattr(
                logging, os.environ.get("DSML_LOG_LEVEL", "INFO").upper(),
                logging.INFO,
            ))
            _ring_handler = RingBufferHandler(capacity)
            logging.getLogger("dsml").addHandler(_ring_handler)
        return _ring_handler


def uninstall_ring_handler() -> None:
    global _ring_handler
    with _ring_lock:
        if _ring_handler is not None:
            logging.getLogger("dsml").removeHandler(_ring_handler)
            _ring_handler = None


def get_ring_handler() -> RingBufferHandler | None:
    """The installed ring handler, or ``None`` (flight-recorder probe)."""
    return _ring_handler
