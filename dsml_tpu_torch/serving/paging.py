"""Host-side page-pool accounting for the paged KV cache — the counterpart
of ``dsml_tpu/serving/paging.py``.

The device side of paged serving is the model's paged surfaces
(``GPT2.decode_step_slots_paged`` / ``prefill_chunk_paged`` /
``verify_step_paged``: attention through a page table, scatter writes at
(physical page, row)). This module is the host side they trust: a
refcounting allocator over the physical pages and the copy-on-write
admission planner. Two invariants carry the design:

- **Writes only land in private pages.** The planner shares only the FULL
  pages of a matched prefix; a prefix tail that straddles a page boundary
  gets that one page copied privately (``copy``), because the suffix
  prefill and later decode write into it. So a shared page is read-only by
  construction, and refcounts only gate reclamation.
- **Reservation up front** (the default): admission reserves every page a
  request can ever touch before its first chunk, and a request that cannot
  reserve waits. ``ContinuousBatcher(preemption=True)`` instead reserves
  the prompt grid only, grows page by page and evicts under pressure.

Page 0 is the SCRATCH page: never allocated, named by every free slot's
table entries, so a dead slot's (masked, never read) writes cannot land in
a live slot's pages.

The pool-occupancy gauges and the page-wait counter
(:func:`export_pool_gauges`, :func:`note_page_wait`) are the paged
batcher's observability hooks.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

__all__ = [
    "AdmissionPlan",
    "PagePool",
    "copy_page",
    "export_pool_gauges",
    "gather_pages",
    "note_page_wait",
    "pages_for",
    "plan_admission",
    "prefill_prefix_into_pages",
]


def pages_for(rows: int, page_size: int) -> int:
    """Physical pages needed to hold ``rows`` token rows."""
    return -(-int(rows) // int(page_size))


class PagePool:
    """Refcounting free-list allocator over ``n_pages`` physical pages.

    Page 0 is the scratch page and is never handed out. ``alloc`` gives
    fresh pages at refcount 1; ``share`` adds a reference to owned pages
    (the CoW prefix path); ``release`` drops one and frees the page at
    zero. Double frees and over-releases raise."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need n_pages >= 2 (page 0 is the scratch page), got {n_pages}")
        self.n_pages = int(n_pages)
        self._free: deque[int] = deque(range(1, self.n_pages))
        self._ref = np.zeros(self.n_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages referenced by more than one owner (live CoW sharing)."""
        return int((self._ref > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if len(self._free) < n:
            raise RuntimeError(
                f"page pool exhausted: {n} requested, {len(self._free)} free "
                f"of {self.n_pages} — callers must check can_alloc and wait"
            )
        pages = [self._free.popleft() for _ in range(n)]
        self._ref[pages] = 1
        return pages

    def share(self, pages) -> None:
        pages = list(pages)
        if any(self._ref[p] < 1 for p in pages):
            raise RuntimeError(f"sharing unowned page(s) in {pages}")
        for p in pages:
            self._ref[p] += 1

    def release(self, pages) -> None:
        for p in pages:
            if p == 0 or self._ref[p] < 1:
                raise RuntimeError(f"releasing free/scratch page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(int(p))


@dataclasses.dataclass
class AdmissionPlan:
    """One admission's pages: ``pages`` is the slot's table prefix in order
    (shared prefix pages first, then private ones); the first ``n_shared``
    are read-only shared pages; ``copy`` is the (src, dst) CoW copy of a
    straddling prefix tail (dst is ``pages[n_shared]``), else None."""

    pages: list
    n_shared: int
    copy: tuple | None


def plan_admission(pool: PagePool, page_size: int, total_rows: int,
                   prefix_pages=None, prefix_len: int = 0,
                   share_prefix: bool = True) -> AdmissionPlan | None:
    """Plan a request's pages: share the matched prefix's full pages, copy
    a straddling prefix tail page privately, allocate the rest fresh.
    ``total_rows`` covers everything the request can ever write. Returns
    None, with no count changed, when the pool cannot serve it now.
    ``share_prefix=False`` plans the same page count without sharing."""
    n_need = pages_for(total_rows, page_size)
    n_full = 0
    straddle = None
    if prefix_pages is not None and prefix_len > 0 and share_prefix:
        n_full = min(int(prefix_len) // int(page_size), len(prefix_pages))
        if prefix_len % page_size and n_full < len(prefix_pages):
            straddle = int(prefix_pages[n_full])
    n_private = n_need - n_full
    if n_private < 0:
        raise ValueError(f"prefix covers {n_full} pages but the request reserves only {n_need}")
    if not pool.can_alloc(n_private):
        return None
    shared = [int(p) for p in (prefix_pages[:n_full] if n_full else [])]
    private = pool.alloc(n_private)
    pool.share(shared)
    copy = (straddle, private[0]) if (straddle is not None and n_private) else None
    return AdmissionPlan(pages=shared + private, n_shared=n_full, copy=copy)


def copy_page(pool, src: int, dst: int) -> list:
    """Copy one physical page across every layer and entry, in place: the
    CoW copy of a straddling prefix tail."""
    for c in pool:
        for a in c.values():
            a[dst] = a[src]
    return pool


def gather_pages(pool, page_ids) -> list:
    """Copy physical pages to the host: per-layer dicts of CPU tensors with
    a leading page axis, the pool's own entry layout — the preemption
    tier's swap-out, which installs back by a scatter at new pages. A read:
    the pages stay intact."""
    idx = torch.as_tensor(list(page_ids), dtype=torch.long, device=pool[0]["k"].device)
    return [{key: arr[idx].cpu() for key, arr in c.items()} for c in pool]


def prefill_prefix_into_pages(chunk, pool, allocator: PagePool, tokens, chunk_size: int,
                              page_size: int, n_pt: int):
    """Chunk-prefill a PREFIX into freshly allocated registry pages.
    ``chunk(pool, table, padded, start, last) -> (logits, pool)`` is the
    caller's paged chunk step. Pages the padded last chunk touches past the
    prefix (pad rows only) go straight back: the registry keeps exactly
    ⌈len(tokens)/page_size⌉ pages. Returns ``(kept_pages, last_logits,
    pool)``; raises RuntimeError when the pool cannot stage the chunk
    grid."""
    n = len(tokens)
    grid_end = -(-n // chunk_size) * chunk_size
    n_keep = pages_for(n, page_size)
    n_grid = pages_for(grid_end, page_size)
    if not allocator.can_alloc(n_grid):
        raise RuntimeError(
            f"page pool too full to register a {n}-token prefix "
            f"({n_grid} pages needed, {allocator.free_pages} free)"
        )
    pages = allocator.alloc(n_grid)
    table = np.zeros((1, n_pt), np.int32)
    table[0, :n_grid] = pages
    logits = None
    for start in range(0, n, chunk_size):
        end = min(start + chunk_size, n)
        padded = np.zeros((1, chunk_size), np.int64)
        padded[0, : end - start] = tokens[start:end]
        last_local = (n - 1) - start if end >= n else chunk_size - 1
        logits, pool = chunk(pool, table, padded, start, last_local)
    if n_grid > n_keep:  # pad-only pages hold nothing shareable
        allocator.release(pages[n_keep:])
    return pages[:n_keep], logits[0], pool


def export_pool_gauges(obs, pool: PagePool, replica: str, role: str) -> None:
    """The (replica, role)-labeled occupancy/free-list/CoW gauges of a
    paged worker, written into the registry ``obs``."""
    for name, help_, value in (
        ("serving_page_pool_used", "pool pages in use", pool.used_pages),
        ("serving_page_pool_free", "pool pages on the free list", pool.free_pages),
        ("serving_page_pool_shared", "pages shared by >1 owner (CoW)", pool.shared_pages),
    ):
        obs.gauge(name, help_, labels=("replica", "role")).set(value, replica=replica, role=role)


def note_page_wait(obs, replica: str, role: str, trace=None) -> None:
    """Count one pool-pressure wait tick (an admission that could not
    reserve its page plan and stayed queued) and, when ``trace`` (a
    ``TraceContext``) is passed, mark the wait on the request's flow.
    Callers pass ``trace`` only on the FIRST blocked tick of a wait
    episode, so a request stuck for thousands of ticks does not flood its
    causal chain (the counter stays per tick)."""
    if not obs.enabled:
        return
    obs.counter(
        "serving_page_wait_total",
        "admission ticks spent waiting for pool pages",
        labels=("replica", "role"),
    ).inc(replica=replica, role=role)
    if trace is not None:
        from dsml_tpu_torch.obs import get_tracer

        get_tracer().flow("page_wait", trace, phase="step", replica=replica)
