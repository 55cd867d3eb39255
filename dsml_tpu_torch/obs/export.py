"""Export surfaces — the port's copy of ``dsml_tpu/obs/export.py``:
rotation-safe JSONL sink + in-process HTTP /metrics.

- :class:`MetricsLogger` — the append-only JSON-lines history (re-exported
  by ``utils.metrics``), rotation-safe: ``max_bytes`` caps the file,
  rotating ``path`` → ``path.1`` atomically so a long-running trainer
  cannot fill a disk.
- :func:`start_metrics_server` — OPT-IN in-process HTTP endpoint serving
  the registry's Prometheus text at ``/metrics`` and the JSON snapshot at
  ``/metrics.json`` (nothing listens unless a caller asks). The JAX
  package's third route, the cluster snapshot ``/cluster.json``, comes
  with the fleet's observability plane (ROADMAP.md queue 1, item 13).

Histogram records in the JSON expositions (``/metrics.json``, JSONL) carry
per-bucket trace_id EXEMPLARS when the emitting call site attached them
(``Histogram.observe(..., exemplar=trace_id)`` — the serving admission
histogram does). Prometheus 0.0.4 text has no exemplar syntax; they ride
the JSON forms only.
"""

from __future__ import annotations

import json
import os
import threading
import time

from dsml_tpu_torch.obs.registry import ObsUnavailable, Registry, get_registry

__all__ = ["MetricsLogger", "MetricsServer", "start_metrics_server"]


class MetricsLogger:
    """Append-only JSON-lines metrics history with wall-clock timestamps.

    ``path=None`` keeps records in memory only. With a path, every record
    appends a line; when ``max_bytes`` is set and the file would exceed it,
    the file rotates to ``<path>.1`` first (one generation — enough to
    bound disk while keeping the recent history greppable)."""

    def __init__(self, path: str | None = None, max_bytes: int | None = None):
        self.path = path
        self.max_bytes = max_bytes
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def log(self, **kv) -> dict:
        rec = {"time": time.time(), **kv}
        line = json.dumps(rec) + "\n"
        with self._lock:
            self.records.append(rec)
            if self.path:
                self._maybe_rotate(len(line))
                with open(self.path, "a") as f:
                    f.write(line)
        return rec

    def _maybe_rotate(self, incoming: int) -> None:
        if not self.max_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming > self.max_bytes:
            # os.replace is atomic on one filesystem: a concurrent reader
            # sees either the old full file or the fresh one, never a
            # truncated hybrid
            os.replace(self.path, self.path + ".1")

    def last(self, **match) -> dict | None:
        with self._lock:
            records = list(self.records)
        for rec in reversed(records):
            if all(rec.get(k) == v for k, v in match.items()):
                return rec
        return None


class MetricsServer:
    """Handle for a running /metrics endpoint (see
    :func:`start_metrics_server`)."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self.port = httpd.server_address[1]
        self.address = f"http://{httpd.server_address[0]}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(registry: Registry | None = None, port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Serve ``registry`` on a daemon thread. ``port=0`` picks a free
    port (read it back from the handle). Raises :class:`ObsUnavailable`
    when the port cannot be bound, with the conflicting address named."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else get_registry()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = reg.to_prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(reg.collect()).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    try:
        httpd = ThreadingHTTPServer((host, port), Handler)
    except OSError as e:
        raise ObsUnavailable(
            f"cannot bind metrics endpoint on {host}:{port}: {e}; pick a "
            "free port (port=0 auto-selects) or skip the HTTP exporter — "
            "Registry.to_prometheus_text()/dump_jsonl() need no socket"
        ) from e
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="obs-metrics-http")
    thread.start()
    return MetricsServer(httpd, thread)
