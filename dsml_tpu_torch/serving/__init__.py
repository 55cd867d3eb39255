"""Serving: continuous batching on one device over a dense or paged KV
cache — the counterpart of ``dsml_tpu.serving``'s batcher and page-pool
modules.

- :mod:`batcher` — ``ContinuousBatcher``: slot-based continuous batching
  (bucketed or chunked prefill admission, prefix cache, decode quanta,
  paged KV with copy-on-write prefixes and preemption).
- :mod:`paging` — the paged KV cache's host side: the refcounting page
  allocator and the copy-on-write admission planner.

The fleet modules (prefill workers, KV handoff, router) come with a later
slice.
"""

from dsml_tpu_torch.serving.batcher import ContinuousBatcher, QueueFull, Request
from dsml_tpu_torch.serving.paging import AdmissionPlan, PagePool, pages_for, plan_admission

__all__ = ["AdmissionPlan", "ContinuousBatcher", "PagePool", "QueueFull", "Request", "pages_for",
           "plan_admission"]
