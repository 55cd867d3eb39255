"""Prefill worker: chunked prompt prefill to completion, then hand off —
the port's counterpart of ``dsml_tpu/serving/prefill.py``.

One half of the disaggregated serving split. A ``PrefillWorker`` owns the
model's chunk step (``GPT2.prefill_chunk``, or ``prefill_chunk_paged``
into its own page pool — the paged-attention kernels on the card), runs
at most one chunk dispatch per scheduler tick, and emits a
:class:`~dsml_tpu_torch.serving.handoff.Handoff` when a prompt completes.
It never decodes: a burst of long prompts fills the prefill workers while
the decode workers keep their cadence.

The prefix registry (``register_prefix``) is the batcher's system-prompt
pattern at the fleet level: the router replicates each registration
across every prefill worker, so any worker admits a matching prompt from
the master rows and prefills only the suffix. On a paged fleet the
matched prefix's full pages are also left out of the handoff
(``ship_prefix_pages``): the decode worker shares its own registration.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from dsml_tpu_torch.obs import get_registry, get_tracer
from dsml_tpu_torch.obs.spans import synchronize
from dsml_tpu_torch.serving.batcher import QueueFull
from dsml_tpu_torch.serving.handoff import Handoff
from dsml_tpu_torch.serving.paging import (
    PagePool,
    copy_page,
    export_pool_gauges,
    note_page_wait,
    pages_for,
    plan_admission,
    prefill_prefix_into_pages,
)

__all__ = ["PrefillWorker"]


@dataclasses.dataclass
class _Job:
    frid: int
    prompt: np.ndarray
    max_new_tokens: int
    key_rid: int | None
    submitted_at: float
    # prompt tokens this job will prefill (the longest matching prefix
    # taken off at submit), summed into the worker's running load counter;
    # re-stamped when a prefix registers
    eff_tokens: int = 0
    # the request's TraceContext (or None): every chunk span and the
    # emitted handoff carry it
    trace: object = None


class PrefillWorker:
    """Chunked prefill to completion; emits handoffs, never decodes.

    ``model`` is a ``GPT2`` or ``Llama`` holding its weights on the device
    the worker runs on. ``submit`` enqueues a prompt (``frid`` is the
    fleet-wide id the handoff and the sampler identity carry;
    ``max_queue`` sheds with :class:`QueueFull` as the batcher does).
    ``step()`` runs AT MOST one chunk dispatch and returns every handoff
    completed this tick (exact-prefix hits complete with no dispatch and
    ride along). ``abandon()`` evacuates unfinished jobs for re-prefill on
    a survivor: prefill is a pure function of the prompt, so a worker
    loss costs latency, never tokens.

    Load signals for the router: :attr:`queue_tokens` (prompt tokens
    waiting or mid-flight, prefix savings taken off) and
    :meth:`estimate_ms` (that backlog priced at the measured per-chunk
    wall EWMA, ``chunk_s_ewma``).

    ``paged_kv`` ("int4"/True, "int8" or "fp") prefills into a page pool
    of ``n_pages`` pages of ``page_size`` rows (0: one full-length job in
    flight, one more, and the scratch page) and hands off the job's pages
    in the decode pool's layout."""

    def __init__(self, model, prefill_chunk: int, max_queue: int = 0, paged_kv=False,
                 page_size: int = 16, n_pages: int = 0):
        cfg = model.config
        if not 0 < prefill_chunk <= cfg.max_seq:
            raise ValueError(
                f"prefill_chunk must be in [1, max_seq={cfg.max_seq}], got {prefill_chunk}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.model = model
        self.device = model.device
        self.prefill_chunk = int(prefill_chunk)
        self.max_queue = int(max_queue)
        self.obs_replica = "0"
        self.obs_role = "prefill"
        self._obs = get_registry()
        self._queue: deque[_Job] = deque()
        self._queued_tokens = 0  # running sum of queued jobs' eff_tokens
        # the in-flight job: (job, accumulating 1-row cache, next start);
        # paged: (job, AdmissionPlan, next start)
        self._pending: tuple | None = None
        self._prefixes: list = []  # (tokens, cache1 or pages, last logits), longest first
        self._next_frid = 0
        # the queue head whose page wait is being counted (the counter is
        # per tick, the trace mark once per wait episode)
        self._page_wait_frid: int | None = None
        # measured per-chunk wall EWMA (seconds): the router's prefill cost
        # model, seeded by the first chunk
        self.chunk_s_ewma: float | None = None
        self.n_chunk_dispatches = 0
        self.n_handoffs = 0

        # paged: prefill INTO pool pages and hand off the pages (int4 pages
        # ship a fraction of dense f32 rows' bytes); the Router turns on
        # ship_prefix_pages once every decode worker holds each registration
        self.page_quant = None if paged_kv == "fp" else model._page_mode(paged_kv)
        self.paged = bool(paged_kv)
        self.page_size = int(page_size)
        self.ship_prefix_pages = False
        if self.paged:
            if cfg.max_seq % self.page_size:
                raise ValueError(
                    f"page_size must divide max_seq={cfg.max_seq}, got {self.page_size}")
            self._n_pt = cfg.max_seq // self.page_size
            self.n_pages = int(n_pages) or 2 * self._n_pt + 1
            self._pages = PagePool(self.n_pages)
            self.n_cow_copies = 0
            self._pool = model.init_page_pool(self.n_pages, self.page_size, quant=self.page_quant)
            # pages the prefix registry holds for good: the never-fits
            # checks take them off the reservable ceiling
            self._registry_pages = 0
            # pool gauges refresh at SCRAPE time (weakly held)
            self._obs.add_collect_hook(self._export_pool_gauges)
        else:
            self.n_pages = 0

    # ---- device steps ------------------------------------------------------------

    def _tokens(self, padded: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(padded, device=self.device).long()

    def _chunk_paged(self, pool, table: np.ndarray, padded: np.ndarray, start: int, last: int):
        return self.model.prefill_chunk_paged(
            pool, torch.as_tensor(table, device=self.device), self._tokens(padded), int(start),
            last_index=int(last), quant=self.page_quant)

    def _chunk_dense(self, cache1, padded: np.ndarray, start: int, last: int):
        return self.model.prefill_chunk(cache1, self._tokens(padded), int(start),
                                        last_index=int(last))

    # ---- request interface -------------------------------------------------------

    def _fits(self, prompt_len: int) -> bool:
        c = self.prefill_chunk
        return -(-prompt_len // c) * c <= self.model.config.max_seq

    def submit(self, prompt, max_new_tokens: int, frid: int | None = None,
               key_rid: int | None = None, submitted_at: float | None = None,
               trace=None) -> int:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        # the decode worker validates again at inject; checking here fails at
        # the fleet edge instead of after the prefill was spent
        self.model._check_generate_args(len(prompt), max_new_tokens, 0.0, 0, 0)
        if not self._fits(len(prompt)):
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the chunk grid for "
                f"max_seq={self.model.config.max_seq}")
        if self.paged:
            # never-fits check against the reservable ceiling (pool less the
            # scratch page and the registry's pages, a matched prefix's
            # shared pages credited): a job that could only park at the
            # queue head forever fails here
            pre0 = self._match_prefix(prompt) if self._prefixes else None
            p0 = len(pre0[0]) if pre0 else 0
            grid = (p0 + -(-(len(prompt) - p0) // self.prefill_chunk) * self.prefill_chunk
                    if len(prompt) > p0 else len(prompt))
            n_private = pages_for(grid, self.page_size) - p0 // self.page_size
            ceiling = self.n_pages - 1 - self._registry_pages
            if n_private > ceiling:
                raise ValueError(
                    f"prefill job needs {n_private} private pages but only "
                    f"{ceiling} are ever reservable ({self._registry_pages} "
                    "held by the prefix registry); raise n_pages")
        if self.max_queue and len(self._queue) >= self.max_queue:
            self._obs.counter("serving_shed_total", "requests rejected by the queue cap",
                              labels=("replica", "role")).inc(
                replica=self.obs_replica, role=self.obs_role)
            raise QueueFull(f"prefill queue at its cap ({self.max_queue} waiting)")
        if frid is None:
            frid = self._next_frid
        self._next_frid = max(self._next_frid, frid + 1)
        pre = self._match_prefix(prompt) if self._prefixes else None
        eff = len(prompt) - (len(pre[0]) if pre else 0)
        self._queue.append(_Job(
            frid=frid, prompt=prompt, max_new_tokens=int(max_new_tokens), key_rid=key_rid,
            submitted_at=time.monotonic() if submitted_at is None else submitted_at,
            eff_tokens=eff, trace=trace))
        self._queued_tokens += eff
        return frid

    def register_prefix(self, tokens) -> None:
        """Precompute and keep the KV rows and next-token logits of a shared
        prompt head — the batcher's ``register_prefix``, prefill side (a
        blocking setup call). On a paged worker the prefix lands in pages
        the registry holds for good, which matching jobs SHARE during their
        suffix prefill (copy-on-write: only a straddling tail page is
        copied), and which paged handoffs leave out when the decode side
        shares its own registration (``ship_prefix_pages``)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prefix")
        if not self._fits(n):
            raise ValueError(
                f"prefix length {n} exceeds the chunk grid for max_seq="
                f"{self.model.config.max_seq}")
        c = self.prefill_chunk
        if self.paged:
            pages, logits, self._pool = prefill_prefix_into_pages(
                self._chunk_paged, self._pool, self._pages, tokens, c, self.page_size, self._n_pt)
            self._registry_pages += len(pages)
            self._prefixes.append((tokens, pages, logits))
        else:
            cache1 = self.model.init_cache(1)
            logits = None
            for start in range(0, n, c):
                end = min(start + c, n)
                padded = np.zeros((1, c), np.int64)
                padded[0, : end - start] = tokens[start:end]
                last_local = (n - 1) - start if end >= n else c - 1
                logits, cache1 = self._chunk_dense(cache1, padded, start, last_local)
            self._prefixes.append((tokens, cache1, logits[0]))
        self._prefixes.sort(key=lambda p: -len(p[0]))  # the longest match wins
        # re-stamp queued jobs: the new prefix may cover prompts submitted
        # before it registered
        self._queued_tokens = 0
        for job in self._queue:
            pre = self._match_prefix(job.prompt)
            job.eff_tokens = len(job.prompt) - (len(pre[0]) if pre else 0)
            self._queued_tokens += job.eff_tokens

    def _match_prefix(self, prompt: np.ndarray):
        L = len(prompt)
        c = self.prefill_chunk
        max_seq = self.model.config.max_seq
        for ptoks, pcache, plogits in self._prefixes:
            p = len(ptoks)
            if p > L or not np.array_equal(prompt[:p], ptoks):
                continue
            if p < L and p + (-(-(L - p) // c)) * c > max_seq:
                continue  # the padded suffix grid would overrun the cache
            return ptoks, pcache, plogits
        return None

    # ---- load signals ------------------------------------------------------------

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_pending(self) -> int:
        return 0 if self._pending is None else 1

    @property
    def queue_tokens(self) -> int:
        """Prompt tokens this worker still has to prefill: queued prompts
        (their longest matching prefix taken off) plus the in-flight job's
        remaining tokens. O(1): the queued sum is a running counter."""
        total = self._queued_tokens
        if self._pending is not None:
            job, _, start = self._pending
            total += max(len(job.prompt) - start, 0)
        return total

    def estimate_ms(self, prompt_len: int = 0) -> float:
        """Estimated wall to drain the backlog plus a hypothetical
        ``prompt_len`` prompt: its chunks priced at the measured per-chunk
        EWMA (one chunk a tick). 0 before the first measurement: the
        router then spreads by queue depth alone."""
        if not self.chunk_s_ewma:
            return 0.0
        chunks = -(-(self.queue_tokens + prompt_len) // self.prefill_chunk)
        return chunks * self.chunk_s_ewma * 1e3

    # ---- scheduling --------------------------------------------------------------

    def _gather_pages(self, page_ids) -> list:
        """The handoff payload of ``page_ids``: per-layer dicts with a
        leading page axis, the pool's own entry layout (the layout of
        ``paging.gather_pages`` and the preemption tier's swap). A copy
        that stays on the device: the pages go back to the pool."""
        idx = torch.as_tensor(list(page_ids), dtype=torch.long, device=self.device)
        return [{key: arr[idx] for key, arr in c.items()} for c in self._pool]

    def _handoff(self, job: _Job, cache1, logits, parent_span: str, page_size=None,
                 prefix_rows: int = 0) -> Handoff:
        self.n_handoffs += 1
        if job.trace is not None:
            # a flow STEP on this worker's lane: the prefill → decode hop
            get_tracer().flow("prefill_handoff", job.trace, phase="step", frid=job.frid,
                              replica=self.obs_replica)
        return Handoff(
            frid=job.frid, prompt=job.prompt, max_new_tokens=job.max_new_tokens,
            prefill_len=len(job.prompt), cache1=cache1, logits=logits,
            submitted_at=job.submitted_at, prefill_done_at=time.monotonic(),
            key_rid=job.key_rid, page_size=page_size, prefix_rows=prefix_rows,
            trace_id=job.trace.trace_id if job.trace else None, parent_span=parent_span)

    def _paged_handoff(self, job: _Job, pages, n_full_prefix: int, logits) -> Handoff:
        """A paged handoff of a job's pages: with ``ship_prefix_pages`` the
        matched prefix's FULL pages are left out (the decode worker shares
        its own registration for those rows; ``prefix_rows`` says how
        many); otherwise every page ships. A straddling prefix page always
        ships: the suffix wrote into it."""
        n_skip = n_full_prefix if self.ship_prefix_pages else 0
        return self._handoff(job, self._gather_pages(pages[n_skip:]), logits, "prefill_chunk",
                             page_size=self.page_size, prefix_rows=n_skip * self.page_size)

    def _start(self, job: _Job):
        """Begin ``job``: an exact prefix hit completes at once (from a COPY
        of the master rows, or straight from the registry's pages);
        otherwise stage the pending chunk state (the prefix rows copied in
        as the starting cache for a partial hit). Paged: reserve the job's
        page plan first; returns ``"wait"`` when the pool cannot serve it
        yet (the job keeps its queue spot)."""
        pre = self._match_prefix(job.prompt) if self._prefixes else None
        L = len(job.prompt)
        if self.paged:
            if pre is not None and len(pre[0]) == L:
                _, ppages, plogits = pre
                n_full = L // self.page_size if self.ship_prefix_pages else 0
                return self._paged_handoff(job, list(ppages), n_full, plogits)
            p_len = len(pre[0]) if pre else 0
            c = self.prefill_chunk
            grid_end = p_len + -(-(L - p_len) // c) * c
            plan = plan_admission(self._pages, self.page_size, grid_end,
                                  prefix_pages=pre[1] if pre else None, prefix_len=p_len)
            if plan is None:
                if self._pages.used_pages == self._registry_pages:
                    # nothing in flight will free a page and the job still
                    # cannot reserve: a prefix registered after its submit
                    # shrank the ceiling past it
                    raise RuntimeError(
                        f"prefill job {job.frid} can never reserve its "
                        f"pages ({self._registry_pages} held by the prefix "
                        "registry); register prefixes before accepting "
                        "traffic, or raise n_pages")
                return "wait"
            if plan.copy is not None:
                src, dst = plan.copy
                self._pool = copy_page(self._pool, src, dst)
                self.n_cow_copies += 1
            self._pending = (job, plan, p_len)  # the suffix starts at the prefix
            return None
        if pre is not None:
            ptoks, pcache, plogits = pre
            copy = [{k: v.clone() for k, v in c.items()} for c in pcache]
            if len(ptoks) == L:
                return self._handoff(job, copy, plogits, "prefix_hit")
            self._pending = (job, copy, len(ptoks))
            return None
        self._pending = (job, self.model.init_cache(1), 0)
        return None

    def _advance(self) -> Handoff | None:
        """Run ONE chunk of the in-flight job; returns its handoff when the
        chunk completed the prompt. Paged: the chunk writes straight into
        the job's reserved pages; at completion the shipped pages are
        copied out and every page is released (shared prefix references
        included — the refcounts keep the registry's masters)."""
        job, state, start = self._pending
        c = self.prefill_chunk
        L = len(job.prompt)
        end = min(start + c, L)
        padded = np.zeros((1, c), np.int64)
        padded[0, : end - start] = job.prompt[start:end]
        is_last = end >= L
        last_local = (L - 1) - start if is_last else c - 1
        t0 = time.monotonic()
        # one span a chunk dispatch, tagged with the request's trace
        with get_tracer().request_span("prefill_chunk", job.trace, frid=job.frid,
                                       start=int(start), replica=self.obs_replica):
            if self.paged:
                table = np.zeros((1, self._n_pt), np.int32)
                table[0, : len(state.pages)] = state.pages
                logits, self._pool = self._chunk_paged(self._pool, table, padded, start,
                                                       last_local)
            else:
                logits, state = self._chunk_dense(state, padded, start, last_local)
            synchronize(logits)  # the chunk's wall is its device time
        wall = time.monotonic() - t0
        self.n_chunk_dispatches += 1
        self.chunk_s_ewma = (wall if self.chunk_s_ewma is None
                             else 0.8 * self.chunk_s_ewma + 0.2 * wall)
        if self._obs.enabled:
            self._obs.histogram("serving_prefill_chunk_ms", "one prefill chunk dispatch",
                                labels=("replica", "role")).observe(
                wall * 1e3, replica=self.obs_replica, role=self.obs_role)
        if not is_last:
            self._pending = (job, state, start + c)
            return None
        self._pending = None
        if self.paged:
            h = self._paged_handoff(job, state.pages, state.n_shared, logits[0])
            self._pages.release(state.pages)
            return h
        return self._handoff(job, state, logits[0], "prefill_chunk")

    def step(self) -> list[Handoff]:
        """One scheduler tick: at most ONE chunk dispatch, plus any
        exact-prefix completions reached on the way. Returns the handoffs
        completed this tick."""
        out: list[Handoff] = []
        while True:
            if self._pending is None:
                if not self._queue:
                    break
                job = self._queue[0]  # a paged job that cannot reserve keeps its spot
                h = self._start(job)
                if isinstance(h, str):  # "wait"
                    first = self._page_wait_frid != job.frid
                    self._page_wait_frid = job.frid
                    note_page_wait(self._obs, self.obs_replica, self.obs_role,
                                   trace=job.trace if first else None)
                    break
                self._queue.popleft()
                self._queued_tokens -= job.eff_tokens
                if h is not None:
                    out.append(h)  # an exact prefix hit: no dispatch spent
                continue
            h = self._advance()
            if h is not None:
                out.append(h)
            break  # one chunk dispatch a tick: a bounded tick
        if self._obs.enabled:
            labels = {"replica": self.obs_replica, "role": self.obs_role}
            self._obs.gauge("serving_queue_depth", "requests waiting for a slot",
                            labels=("replica", "role")).set(self.n_queued + self.n_pending,
                                                            **labels)
            self._obs.counter("serving_handoffs_total",
                              "prefilled requests handed to decode workers",
                              labels=("replica", "role")).inc(len(out), **labels)
        return out

    def _export_pool_gauges(self) -> None:
        """Collect-hook body: the pool's occupancy gauges at every
        exposition."""
        if not self._obs.enabled:
            return  # the hooks run on a disabled registry too: skip the reads
        export_pool_gauges(self._obs, self._pages, self.obs_replica, self.obs_role)

    def abandon(self) -> list[dict]:
        """Evacuate every unfinished job, queued and mid-chunk, as
        resubmittable specs (the worker-loss path; a partial cache is
        dropped and re-prefill reproduces it). The worker is reusable."""
        jobs = list(self._queue)
        self._queue.clear()
        self._queued_tokens = 0
        if self._pending is not None:
            jobs.insert(0, self._pending[0])  # it has waited longest
            if self.paged:  # the dead job's reservation returns too
                self._pages.release(self._pending[1].pages)
            self._pending = None
        return [{"frid": j.frid, "prompt": j.prompt, "max_new_tokens": j.max_new_tokens,
                 "key_rid": j.key_rid, "submitted_at": j.submitted_at} for j in jobs]
