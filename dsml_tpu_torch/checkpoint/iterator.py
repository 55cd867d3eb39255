"""Resumable data iterators — the loader-position half of a bit-identical
resume; the counterpart of ``dsml_tpu/checkpoint/iterator.py``.

Restoring (params, opt_state) alone resumes the MODEL but not the RUN: the
data loader would start over and replay batches the optimizer has already
consumed, so the post-resume loss trajectory diverges from the
uninterrupted one. The framework's batch iterators
(``utils.data.shard_batches`` / ``lm_window_batches``) are deterministic
functions of their seed, which makes position a single integer: wrap the
iterator in :class:`ResumableIterator`, persist ``state()`` with each
checkpoint (``CheckpointManager.save(..., iterator_state=...)``), and
resume by rebuilding the same factory and fast-forwarding — every batch
after the resume point is bit-identical to the batch the uninterrupted run
would have seen.

Composes with ``utils.data.prefetch_batches``: put the prefetcher INSIDE
the factory (``lambda: prefetch_batches(lm_window_batches(...))``) — the
wrapper counts batches the CONSUMER pulled, so prefetch depth never
over-advances the recorded position.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["ResumableIterator"]


class ResumableIterator:
    """Iterator wrapper that tracks consumption and replays to a position.

    ``factory`` must return a fresh, deterministic iterator each call (same
    batches in the same order). ``state()`` is JSON-serializable;
    ``ResumableIterator(factory, state=saved)`` rebuilds the stream and
    skips exactly the consumed prefix.
    """

    def __init__(self, factory: Callable[[], Iterator], state: dict | None = None):
        self._factory = factory
        self._it = iter(factory())
        self.consumed = 0
        if state:
            skip = int(state.get("consumed", 0))
            for _ in range(skip):
                next(self._it)
            self.consumed = skip

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        item = next(self._it)
        self.consumed += 1
        return item

    def state(self) -> dict:
        """Position snapshot to persist alongside the model state."""
        return {"consumed": self.consumed}

    def reset(self) -> None:
        """Restart the underlying stream from the beginning (e.g. a new
        epoch with a new factory seed: build a new ResumableIterator)."""
        self._it = iter(self._factory())
        self.consumed = 0
