"""Automatic parallelism planning — the counterpart of
``dsml_tpu/parallel/auto.py``: pick the mesh for a model and a fleet.

:func:`plan_mesh` makes the inter-op decision (which parallelism axes to
use at all) deterministically from first-order memory arithmetic and
returns a :class:`~dsml_tpu_torch.parallel.mesh.MeshSpec` that goes
straight into ``parallel.mesh.build_mesh`` → ``parallel.hybrid``'s
``hybrid_model`` / ``init_hybrid`` / ``make_hybrid_train_step``; the plan's
``pp_interleave`` goes into the model config
(``dataclasses.replace(cfg, pp_interleave=plan.pp_interleave)``). The rules,
reasons and provenance are the JAX package's, line for line:

1. training state ≈ params × (2 × weight bytes + 8: the gradients at the
   weights' width and Adam's two f32 moments); if it fits 2/3 of the
   budget (``hbm_budget`` × HBM) → pure DP;
2. else FSDP: the smallest divisor of the fleet covering the shards needed;
3. if even FSDP over every chip cannot fit a shard, the MODEL shards: pp
   first (the smallest stage count > 1 dividing the layers), then tp (the
   smallest head-divisible split), fsdp carrying the rest;
4. SP when the activation footprint crosses the other third of the budget.

A plan with ``sp > 1`` builds like any other: the sequence shards over
the ``sp`` group and attention defaults to the XLA ring there
(``parallel.hybrid.default_attn_impl``).

Capacity inputs: the per-chip memory comes from the card
(``torch.cuda.get_device_properties(dev).total_memory``, provenance
``"memory_stats"``), or an object with a ``memory_stats()`` that reports
``bytes_limit`` (the JAX device protocol), and falls back to 16 GB, with one
warning and the ``plan_hbm_bytes{source}`` gauge, where no card reports
one (the CPU). The activation footprint is the caller's (``act_bytes``),
else the memory ledger's measurement (:func:`measured_activation_bytes`
through the Trainer's ``DSML_MEASURE_ACT``) rescaled to the plan's batch,
else the analytic ~20 tensors a layer.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from dsml_tpu_torch.parallel.mesh import MeshSpec
from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["AutoPlan", "measured_activation_bytes", "meta_twin", "plan_mesh"]

log = get_logger("auto")

# used only where no card reports its memory: every plan that uses it warns
# once and stamps its provenance into the plan and the obs registry
FALLBACK_HBM_BYTES = 16e9
_warned_fallback = False


def meta_twin(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers are ``meta`` tensors
    of the same shapes and dtypes (nothing of the weights is copied) and
    whose ``device`` attribute, where it has one, is ``meta``: the model
    :func:`measured_activation_bytes` runs."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update({id(b): torch.empty_like(b, device="meta") for b in model.buffers()})
    twin = copy.deepcopy(model, memo)
    if hasattr(twin, "device"):
        twin.device = torch.device("meta")
    return twin


def measured_activation_bytes(loss_fn, *example_args) -> float | None:
    """The bytes a train step keeps for its backward, measured from shapes
    alone: call ``loss_fn(*example_args)`` once on ``meta`` tensors (a model
    from :func:`meta_twin`, or one built with ``device="meta"``, and meta
    inputs: no data, no kernel runs) with a
    ``torch.autograd.graph.saved_tensors_hooks`` that sums every storage
    autograd saves for the backward, each storage counted once, leaving out
    the storages of the parameters and of the arguments (resident state,
    as XLA's temp bytes leave out a program's arguments). Feed the result to
    :func:`plan_mesh` (``act_bytes=``).

    This is not the JAX package's number: that compiles
    ``value_and_grad(loss_fn)`` and reads XLA's ``temp_size_in_bytes``, and
    PyTorch has no compiled memory analysis. The saved tensors are the
    activations a step holds at the top of its backward; the backward's
    own transient buffers are not in them.

    Returns None where nothing can be measured: ``loss_fn`` builds no graph
    (no parameter requires a gradient). A broken ``loss_fn`` or a shape
    mismatch raises."""
    owner = getattr(loss_fn, "__self__", None)
    resident = set()
    if isinstance(owner, torch.nn.Module):
        resident |= {_storage_key(t) for t in (*owner.parameters(), *owner.buffers())}
    for a in example_args:
        if isinstance(a, torch.Tensor):
            resident.add(_storage_key(a))
    saved: dict = {}

    def pack(t):
        key = _storage_key(t)
        base = t if t._base is None else t._base
        # a parameter (or a view of one) is resident state, not an activation
        if key not in resident and not (base.is_leaf and base.requires_grad):
            saved[key] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.enable_grad():
            loss = loss_fn(*example_args)
    if not loss.requires_grad:
        return None
    return float(sum(saved.values()))


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


@dataclasses.dataclass(frozen=True)
class AutoPlan:
    spec: MeshSpec
    reasons: tuple[str, ...]  # one line per decision, in decision order
    # the suggested interleaved-virtual-stage factor (Megatron PTD-P) when
    # the plan has pp > 1: the model's ``pp_interleave`` shrinks the bubble
    # by this factor; 1 without a pipeline (or without a divisible chunking)
    pp_interleave: int = 1
    # where the per-chip memory came from: "caller" (explicit hbm_bytes=),
    # "memory_stats" (read from the card) or "fallback" (the 16 GB constant)
    hbm_source: str = "caller"


def _divisors_desc(n: int, limit: int) -> list[int]:
    return [d for d in range(min(n, limit), 0, -1) if n % d == 0]


def _device_hbm_bytes(device=None) -> tuple[float, str]:
    """Per-chip memory and its description: the card's total memory
    (``device`` a CUDA device, or None with CUDA present: the current card),
    an object's ``memory_stats()["bytes_limit"]``, or the fallback constant
    (one warning a process). Every call sets ``plan_hbm_bytes{source}`` on
    the port's obs registry."""
    global _warned_fallback
    nbytes, source = FALLBACK_HBM_BYTES, "fallback"
    try:
        if hasattr(device, "memory_stats") and not isinstance(device, torch.device):
            limit = (device.memory_stats() or {}).get("bytes_limit")
            kind = getattr(device, "device_kind", "?")
        else:
            dev = torch.device("cuda" if device is None else device)
            limit = kind = None
            if dev.type == "cuda" and torch.cuda.is_available():
                limit = torch.cuda.get_device_properties(dev).total_memory
                kind = torch.cuda.get_device_name(dev)
        if limit:
            nbytes, source = float(limit), "memory_stats"
            detail = f"memory_stats of {kind}"
    except Exception:
        pass
    if source == "fallback":
        detail = (f"fallback constant {FALLBACK_HBM_BYTES/1e9:.0f} GB "
                  "(device reports no memory_stats)")
        if not _warned_fallback:
            _warned_fallback = True
            log.warning(
                "plan_mesh: device reports no memory_stats — capacity "
                "planning assumes %.0f GB/chip; pass hbm_bytes= (or run on "
                "a stats-reporting backend) for a measured plan",
                FALLBACK_HBM_BYTES / 1e9,
            )
    from dsml_tpu_torch.obs import get_registry

    get_registry().gauge(
        "plan_hbm_bytes",
        "per-chip HBM the mesh planner used, by provenance "
        "(memory_stats = measured, fallback = the 16 GB constant)",
        labels=("source",),
    ).set(nbytes, source=source)
    return nbytes, detail


def plan_mesh(
    n_devices: int,
    n_params: int,
    n_head: int | None = None,
    seq_len: int = 0,
    d_model: int = 0,
    n_layer: int = 0,
    batch_per_device: int = 1,
    param_bytes: int = 2,
    hbm_bytes: float | None = None,
    hbm_budget: float = 0.6,
    act_bytes: float | None = None,
    device=None,
) -> AutoPlan:
    """Choose (pp, dp, fsdp, sp, tp) for ``n_devices`` chips.

    ``param_bytes`` — weight dtype width (2 = bf16). ``hbm_bytes`` — per-chip
    memory; None reads it from ``device`` (see :func:`_device_hbm_bytes`).
    ``hbm_budget`` — the share of it the plan may promise to state and
    activations. ``act_bytes`` — a measured per-device activation footprint;
    None takes the ledger's measurement, else the analytic estimate.

    Returns the spec with the reasons for each decision."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    reasons: list[str] = []
    hbm_source = "caller"
    if hbm_bytes is None:
        hbm_bytes, hbm_src = _device_hbm_bytes(device)
        hbm_source = "fallback" if "fallback" in hbm_src else "memory_stats"
        reasons.append(f"per-chip HBM {hbm_bytes/1e9:.1f} GB ({hbm_src})")
    act_src = "caller-measured"
    if act_bytes is None:
        # the ledger's measurement (the Trainer's DSML_MEASURE_ACT) beats the
        # guess below, rescaled to this plan's batch_per_device
        from dsml_tpu_torch.obs.memory import get_memory_ledger

        ledger_act = get_memory_ledger().activation_bytes_for(batch_per_device)
        if ledger_act:
            act_bytes = ledger_act
            act_src = (f"ledger-measured, rescaled to "
                       f"batch_per_device={batch_per_device}")
    # disjoint pools: 2/3 of the budget for training state, 1/3 for activations
    budget = hbm_bytes * hbm_budget * 2 / 3
    act_budget = hbm_bytes * hbm_budget / 3
    # weights + grads at param dtype, adam m/v at f32
    state_bytes = n_params * (2 * param_bytes + 8)

    remaining = n_devices
    pp = tp = fsdp = sp = 1

    if state_bytes <= budget:
        reasons.append(
            f"training state {state_bytes/1e9:.2f} GB fits one chip's "
            f"{budget/1e9:.1f} GB budget → replicate (pure DP)"
        )
    else:
        need = -(-int(state_bytes) // int(budget))  # ceil shards needed
        if need <= remaining:
            fsdp = min(c for c in _divisors_desc(remaining, remaining) if c >= need)
            reasons.append(
                f"training state {state_bytes/1e9:.2f} GB > budget → fsdp={fsdp} "
                f"(per-chip shard {state_bytes/fsdp/1e9:.2f} GB)"
            )
            remaining //= fsdp
        else:
            # the model must shard: pp first (stage boundaries move only
            # activations), then tp, fsdp carrying the rest
            if n_layer > 1:
                pp = min(
                    (c for c in _divisors_desc(remaining, remaining)
                     if c > 1 and n_layer % c == 0),
                    default=1,
                )
            if pp > 1:
                remaining //= pp
                reasons.append(
                    f"state needs {need} shards > {n_devices} chips → model "
                    f"sharding: pp={pp} ({n_layer // pp} layers/stage; stage "
                    "boundaries move activations only)"
                )
            if n_head:
                tp = min(
                    (c for c in _divisors_desc(remaining, n_head) if c > 1 and n_head % c == 0),
                    default=1,
                )
            if tp > 1:
                remaining //= tp
                reasons.append(
                    f"add tp={tp} (smallest head-divisible split; n_head={n_head})"
                    if pp > 1
                    else f"state needs {need} shards > {n_devices} chips → add tp={tp} "
                    f"(smallest head-divisible split; n_head={n_head})"
                )
            fsdp = remaining
            remaining = 1
            per_chip = state_bytes / fsdp / max(tp, 1) / max(pp, 1)
            reasons.append(
                f"fsdp={fsdp} over all remaining chips (best effort: per-chip "
                f"shard {per_chip/1e9:.2f} GB still exceeds "
                f"the budget — more chips or a smaller model needed)"
                if per_chip > budget
                else f"fsdp={fsdp} over all remaining chips"
            )

    # activations: per-device batch × seq × d × ~20 tensors/layer × layers,
    # unless measured
    if act_bytes is None and seq_len and d_model and n_layer:
        act_bytes = batch_per_device * seq_len * d_model * n_layer * 20 * param_bytes
    elif act_bytes is not None:
        reasons.append(f"activation footprint {act_bytes/1e9:.2f} GB ({act_src})")
    if act_bytes:
        if act_bytes > act_budget and remaining > 1:
            # the smallest sufficient split; the rest stays with dp
            sp = min(
                (c for c in _divisors_desc(remaining, remaining) if act_bytes / c <= act_budget),
                default=remaining,
            )
            if sp > 1:
                remaining //= sp
                shard = act_bytes / sp
                reasons.append(
                    f"sequence activations {act_bytes/1e9:.2f} GB > "
                    f"{act_budget/1e9:.1f} GB activation budget → sp={sp} "
                    f"(ring attention shards the sequence)"
                    + (
                        f" — best effort: {shard/1e9:.2f} GB/chip still exceeds the "
                        "budget; more chips or remat needed"
                        if shard > act_budget
                        else ""
                    )
                )

    dp = remaining
    if dp > 1:
        reasons.append(f"remaining {dp} devices → dp={dp}")

    # interleaved virtual stages: the largest v ≤ 4 the layer stack divides into
    interleave = 1
    if pp > 1 and n_layer:
        interleave = max(
            (v for v in (4, 3, 2) if n_layer % (pp * v) == 0), default=1
        )
        if interleave > 1:
            reasons.append(
                f"pp_interleave={interleave} ({interleave} virtual stage "
                f"chunks/rank shrink the pipeline bubble {interleave}×)"
            )

    spec = MeshSpec(pp=pp, dp=dp, fsdp=fsdp, sp=sp, tp=tp)
    total = pp * dp * fsdp * sp * tp
    if total != n_devices:
        raise AssertionError(f"planned {total} devices for {n_devices}")  # pragma: no cover
    return AutoPlan(spec=spec, reasons=tuple(reasons),
                    pp_interleave=interleave, hbm_source=hbm_source)
