"""Serving: continuous batching on one device over a dense or paged KV
cache, and the disaggregated prefill/decode fleet — the counterpart of
``dsml_tpu.serving``.

- :mod:`batcher` — ``ContinuousBatcher``: slot-based continuous batching
  (bucketed or chunked prefill admission, prefix cache, decode quanta,
  paged KV with copy-on-write prefixes and preemption); also the fleet's
  DECODE worker: ``inject()`` admits a request prefilled elsewhere.
- :mod:`paging` — the paged KV cache's host side: the refcounting page
  allocator and the copy-on-write admission planner.
- :mod:`prefill` — ``PrefillWorker``: chunked prefill to completion with a
  replicated prefix registry, producing ``Handoff`` objects.
- :mod:`handoff` — the KV handoff: in-process handover (the rows stay on
  the device), the CRC32C-framed byte codec and the cross-host stream
  pull (``stream_transport``).
- :mod:`router` — ``Router``: SLO-class admission with explicit shedding,
  load-aware dispatch over N prefill and M decode workers, prefix
  replication, worker-loss hooks; ``build_fleet`` assembles one.
- :mod:`mesh_worker` — ``MeshDecodeWorker``: a tensor-parallel decode
  worker over several devices, one rank process each, driven in lockstep
  (``build_fleet(devices=)`` over slices of several devices).
"""

from dsml_tpu_torch.serving.batcher import ContinuousBatcher, QueueFull, Request
from dsml_tpu_torch.serving.paging import AdmissionPlan, PagePool, pages_for, plan_admission

# the fleet's names resolve lazily (PEP 562), as in the JAX package:
# importing the batcher does not import the fleet modules
_LAZY = {
    "Handoff": "handoff",
    "HandoffIntegrityError": "handoff",
    "decode_handoff": "handoff",
    "encode_handoff": "handoff",
    "fetch_from_migrator": "handoff",
    "frame_transport": "handoff",
    "register_with_donor": "handoff",
    "stream_transport": "handoff",
    "MeshDecodeWorker": "mesh_worker",
    "MeshWorkerError": "mesh_worker",
    "PrefillWorker": "prefill",
    "Router": "router",
    "SLOClass": "router",
    "build_fleet": "router",
}

__all__ = ["AdmissionPlan", "ContinuousBatcher", "PagePool", "QueueFull", "Request", "pages_for",
           "plan_admission", *sorted(_LAZY)]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
