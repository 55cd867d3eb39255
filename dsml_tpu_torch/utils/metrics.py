"""Training metrics and terminal progress, the counterpart of
``dsml_tpu/utils/metrics.py``: per-epoch average loss and accuracy and a
TTY-aware progress bar. ``MetricsLogger``, the JSON-lines metrics history,
lives in the observability package (``obs.export``) and is re-exported
here, as in the JAX package."""

from __future__ import annotations

import sys
import time

from dsml_tpu_torch.obs.export import MetricsLogger

__all__ = ["EpochMetrics", "MetricsLogger", "ProgressBar"]


class EpochMetrics:
    """Running mean loss and accuracy over one epoch."""

    def __init__(self):
        self.loss_sum = 0.0
        self.correct = 0
        self.seen = 0
        self.batches = 0

    def update(self, loss: float, correct: int, batch_size: int) -> None:
        self.loss_sum += float(loss)
        self.correct += int(correct)
        self.seen += int(batch_size)
        self.batches += 1

    @property
    def avg_loss(self) -> float:
        return self.loss_sum / max(self.batches, 1)

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.seen, 1)

    def summary(self, epoch: int) -> str:
        return (
            f"Epoch {epoch}: Average Loss = {self.avg_loss:.4f}, "
            f"Accuracy = {self.accuracy * 100:.2f}%"
        )


class ProgressBar:
    """Minimal terminal progress bar. On an interactive stream it redraws in
    place with ``\\r``; on any other stream (pytest, CI logs, pipes) it stays
    silent until the bar completes or closes, then writes ONE summary line.
    ``enabled=False`` silences it."""

    def __init__(self, total: int, desc: str = "", width: int = 30, stream=None,
                 enabled: bool | None = None):
        self.total = max(total, 1)
        self.desc = desc
        self.width = width
        self.n = 0
        self.stream = stream or sys.stderr
        self.enabled = True if enabled is None else enabled
        self.interactive = bool(getattr(self.stream, "isatty", lambda: False)())
        self._t0 = time.monotonic()
        self._summarized = False
        self._last_filled = -1

    def update(self, k: int = 1) -> None:
        self.n += k
        if not self.enabled:
            return
        frac = min(self.n / self.total, 1.0)
        if not self.interactive:
            if frac >= 1.0:
                self._summary_line()
            return
        filled = int(frac * self.width)
        if filled == self._last_filled and frac < 1.0:
            return  # redraw only when the bar visibly moves
        self._last_filled = filled
        bar = "=" * filled + ">" + " " * (self.width - filled)
        rate = self.n / max(time.monotonic() - self._t0, 1e-9)
        self.stream.write(f"\r{self.desc} [{bar}] {self.n}/{self.total} ({rate:.0f}/s)")
        if frac >= 1.0:
            self.stream.write("\n")
        self.stream.flush()

    def _summary_line(self) -> None:
        if self._summarized:
            return
        self._summarized = True
        rate = self.n / max(time.monotonic() - self._t0, 1e-9)
        self.stream.write(f"{self.desc} {self.n}/{self.total} ({rate:.0f}/s)\n")
        self.stream.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        if not self.interactive:
            self._summary_line()
        elif self.n < self.total:
            self.stream.write("\n")
            self.stream.flush()

