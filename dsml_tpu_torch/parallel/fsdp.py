"""ZeRO over the ``fsdp`` axis — the counterpart of ``dsml_tpu/parallel/fsdp.py``.

Two formulations, as in the JAX package:

- **ZeRO-3** (:class:`Zero3`, :func:`make_fsdp_train_step`, and the hybrid
  step's fsdp axis): every parameter leaf is held as this rank's shard on
  one dim (:func:`fsdp_shardings`: the first divisible dim; the hybrid step
  takes ``param_specs(fsdp=n)``'s first FREE divisible dim, so it composes
  with tp). At the step's start each sharded leaf is all-gathered into its
  module parameter (the JAX ``gather_fsdp``); after the backward each full
  gradient is reduce-scattered back into the shard's gradient (the
  transpose of that gather), a leaf with no divisible dim all-reduced; then
  the full weights are released. The optimizer runs on the shards only, so
  its state is 1/n of the model's, as GSPMD shards optax's state. fsdp
  doubles as a data axis: each rank trains on its rows of the batch.
- **ZeRO-2** (:func:`init_zero2`, :func:`make_zero2_train_step`):
  parameters stay replicated; the gradients are flattened into
  ~``bucket_size_mb``-MiB buckets (``parallel.bucketing``) and each bucket
  reduce-scatters as its own collective, full precision
  (``ops.collectives.flat_reduce_scatter``) or block-quantized int8/int4
  (``ops.quantization.quantized_flat_reduce_scatter``, with
  ``error_feedback``); the optimizer updates this rank's flat shard of
  every bucket (padded as the JAX ``_local_shards`` pads) and the updated
  shards all-gather back into the parameters. Its state
  (:func:`zero2_optax_state`) is the JAX ``init_zero2`` tree: the moments a
  list of flat buckets sharded over the axis, which a checkpoint of either
  package restores into the other, at this width or another
  (``checkpoint.native``'s 1-D resize rule; :func:`restore_zero2`).

Observability as the JAX steps write it: ``record_collective_plan("zero2"
| "zero2_<quant>", …)`` once per batch signature, ``record_quant_sync_bytes``
after every quantized step, the memory ledger's claims at this rank's shard
bytes and one peak watermark a step.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch
from torch import nn

from dsml_tpu_torch.checkpoint.native import FlatShard
from dsml_tpu_torch.checkpoint.optim_state import nest_paths
from dsml_tpu_torch.obs import record_collective_plan, record_quant_sync_bytes
from dsml_tpu_torch.obs.memory import get_memory_ledger
from dsml_tpu_torch.ops.collectives import (ReduceOp, all_gather, all_reduce, flat_all_gather,
                                            flat_reduce_scatter, reduce_scatter)
from dsml_tpu_torch.ops.quantization import (_roundtrip_residual, quant_algorithm_for,
                                             quantized_flat_reduce_scatter)
from dsml_tpu_torch.parallel.bucketing import (_ef_plan, _q8_bucket_seed, default_bucket_mb,
                                               flatten_buckets, plan_buckets,
                                               plan_quant_wire_bytes, unflatten_buckets)
from dsml_tpu_torch.parallel.dp import named_params, rank_rows

__all__ = ["Zero2State", "Zero3", "fsdp_shardings", "init_fsdp", "init_zero2",
           "load_zero2_optax_state", "make_fsdp_train_step", "make_zero2_train_step",
           "restore_zero2", "shard_params_fsdp", "zero2_abstract_state", "zero2_optax_state"]


def fsdp_shardings(named: dict, n: int) -> dict:
    """``{name: dim or None}``: each leaf sharded on its first dim divisible
    by ``n`` (replicated when none is), the JAX ``fsdp_shardings``."""
    out = {}
    for name, t in named.items():
        out[name] = next((d for d, s in enumerate(t.shape) if s % n == 0 and s >= n), None)
    return out


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int, op: ReduceOp) -> torch.Tensor:
    moved = x.movedim(dim, 0).contiguous()
    return reduce_scatter(moved, group, op).movedim(0, dim).contiguous()


class Zero3:
    """``model``'s parameters as ZeRO-3 shards over ``group`` (see the
    module docstring). ``dims`` maps each parameter name to its fsdp dim (or
    None: replicated over fsdp). The module's parameters hold empty storage
    outside :meth:`gather` … :meth:`scatter_grads`; :attr:`shards` are what
    the optimizer updates (``shard_of[name]``)."""

    def __init__(self, model: nn.Module, group, dims: dict):
        self.model, self.group, self.n = model, group, group.size
        self.entries = []
        for name, p in named_params(model):
            dim = dims.get(name)
            with torch.no_grad():
                full = p.detach()
                shard = full.chunk(self.n, dim)[group.rank] if dim is not None else full
                shard = nn.Parameter(shard.clone(), requires_grad=p.requires_grad)
            self.entries.append((name, p, dim, shard))
            p.data = p.data.new_empty(0)
        self.shards = [s for *_, s in self.entries]
        self.shard_of = {name: s for name, _, _, s in self.entries}

    @torch.no_grad()
    def gather(self) -> None:
        """Every module parameter rebuilt from the shards (a tiled
        all-gather on its dim)."""
        for _, p, dim, shard in self.entries:
            p.data = all_gather(shard.detach(), self.group, axis=dim) if dim is not None \
                else shard.detach()
            p.grad = None

    def release(self) -> None:
        """The gathered full weights dropped again (after a forward with no
        backward: the eval loss)."""
        for _, p, _, _ in self.entries:
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def scatter_grads(self) -> None:
        """Each full gradient averaged over the group into its shard's
        gradient (reduce-scatter; all-reduce for a replicated leaf), then
        the full weights released."""
        for _, p, dim, shard in self.entries:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if dim is not None:
                shard.grad = _reduce_scatter_dim(g, self.group, dim, ReduceOp.AVG)
            else:
                shard.grad = all_reduce(g, self.group, ReduceOp.AVG,
                                        "xla" if g.is_cpu else "ring")
            p.grad = None
            p.data = p.data.new_empty(0)


def rebuild_optimizer(optimizer, params):
    """An optimizer of ``optimizer``'s class and settings over ``params``
    (the defaults its constructor takes: AdamW keeps one it sets itself)."""
    accepted = inspect.signature(type(optimizer).__init__).parameters
    kwargs = {k: v for k, v in optimizer.defaults.items() if k in accepted}
    return type(optimizer)(list(params), **kwargs)


def shard_params_fsdp(model, mesh, axis: str = "fsdp") -> Zero3:
    """ZeRO-3 shards of ``model`` over the ``axis`` group, each leaf on its
    first divisible dim."""
    group = mesh.group(axis)
    return Zero3(model, group, fsdp_shardings(dict(named_params(model)), group.size))


def init_fsdp(model, optimizer, mesh, seed: int = 0, axis: str = "fsdp"):
    """Fill ``model`` from ``seed``, shard it (:func:`shard_params_fsdp`)
    and return ``(zero3, optimizer over the shards)``."""
    model.init(seed)
    zero3 = shard_params_fsdp(model, mesh, axis)
    return zero3, rebuild_optimizer(optimizer, zero3.shards)


def make_fsdp_train_step(model, zero3: Zero3, optimizer, mesh, batch_axes=("dp", "fsdp"),
                         attn_impl: str = "xla"):
    """``step(x, y, lr=None) -> loss`` of the ZeRO-3 formulation (the JAX
    ``make_fsdp_train_step``): the batch rows shard over ``batch_axes``,
    weights gather at the step's start, gradients reduce-scatter after the
    backward, the optimizer updates the shards. Returns the global mean
    loss."""
    groups = [mesh.group(a) for a in batch_axes if mesh.group(a) is not None]
    ledger = get_memory_ledger()

    def step(x, y, lr: float | None = None):
        for g in groups:
            x, y = rank_rows(x, g), rank_rows(y, g)
        x, y = x.to(model.device).long(), y.to(model.device).long()
        zero3.gather()
        loss = model.loss(x, y, attn_impl=attn_impl)
        loss.backward()
        zero3.scatter_grads()
        for g in groups:
            if g is not zero3.group:
                for s in zero3.shards:
                    s.grad = all_reduce(s.grad, g, ReduceOp.AVG, "xla")
        if lr is not None:
            for pg in optimizer.param_groups:
                pg["lr"] = lr
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = loss.detach().float()
        for g in groups:
            loss = all_reduce(loss, g, ReduceOp.AVG, "xla" if loss.is_cpu else "ring")
        ledger.note_step_peak()
        return loss

    return step


# ---------------------------------------------------------------------------
# Explicit bucketed ZeRO-2
# ---------------------------------------------------------------------------


def _local_shard(flat: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """This rank's contiguous segment of ``flat`` zero-padded to a multiple
    of ``n`` (the JAX ``_local_shards``)."""
    padded = -(-flat.shape[0] // n) * n
    if padded != flat.shape[0]:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.shape[0])])
    seg = padded // n
    return flat[rank * seg:(rank + 1) * seg]


@dataclasses.dataclass
class Zero2State:
    """One rank's ZeRO-2 state: the bucket plan of the replicated
    parameters (tree order), this rank's flat shard of every bucket (what
    the optimizer updates), the optimizer over them, and the f32
    error-feedback residuals (one per parameter, tree order) when used."""

    plan: object
    params: list
    shards: list
    optimizer: torch.optim.Optimizer
    group: object
    ef: list | None = None

    @property
    def bucket_sizes(self) -> list[int]:
        return [sum(_numel(self.plan.shapes[i]) for i in idxs) for idxs in self.plan.buckets]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _plan_mb(bucket_size_mb):
    if bucket_size_mb == "auto":
        bucket_size_mb = default_bucket_mb()
    return float("inf") if bucket_size_mb is None else bucket_size_mb


def init_zero2(model, optimizer, mesh, seed: int | None = 0, axis: str = "fsdp",
               bucket_size_mb: float | None | str = "auto") -> Zero2State:
    """Fill ``model`` from ``seed`` (None keeps its weights) and build the
    rank's ZeRO-2 state: the optimizer (``optimizer``'s class and settings)
    over this rank's flat bucket shards. ``bucket_size_mb`` (``"auto"`` = the
    ``DSML_BUCKET_MB`` default, None = one bucket per dtype) must match the
    step's."""
    if seed is not None:
        model.init(seed)
    group = mesh.group(axis)
    named = dict(named_params(model, optimizer))
    plan = plan_buckets(named, _plan_mb(bucket_size_mb))
    params = [named[k] for k in plan.names]
    with torch.no_grad():
        shards = [nn.Parameter(_local_shard(f.detach(), group.size, group.rank).clone())
                  for f in flatten_buckets(params, plan)]
    state = Zero2State(plan, params, shards, rebuild_optimizer(optimizer, shards), group)
    ledger = get_memory_ledger()
    if ledger.enabled:
        ledger.claim_tree("params", model, detail="zero2")
    return state


def _tree_leaves(tree) -> list:
    """A plan's unflattened leaves in plan order (a named plan gives a dict)."""
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _batch_rows(t, group, device) -> torch.Tensor:
    """This rank's rows of the global batch ``t`` on ``device``; token ids
    as int64."""
    t = rank_rows(t, group).to(device)
    return t if t.is_floating_point() else t.long()


def _scheme_for(quant: str | None, dtype: torch.dtype) -> str | None:
    """The reduce-scatter scheme of a bucket (the JAX ``_zero2_scheme_for``)."""
    if quant is None or not dtype.is_floating_point:
        return None
    if quant in ("int8", "int4"):
        return quant
    if quant == "auto":
        algo = quant_algorithm_for(dtype)
        return "int8" if algo.startswith("q8") else "int4" if algo.startswith("q4") else None
    raise ValueError(f"unknown zero2 quant mode {quant!r}; use int8/int4/auto/None")


def make_zero2_train_step(model, state: Zero2State, mesh, axis: str = "fsdp",
                          bucket_size_mb: float | None | str = "auto", quant: str | None = None,
                          error_feedback: bool = False, attn_impl: str = "xla",
                          loss_fn=None):
    """``step(x, y, lr=None) -> loss`` of the explicit ZeRO-2 (see the
    module docstring; the JAX ``make_zero2_train_step``). The batch rows
    shard over ``axis``; ``loss_fn(x, y)`` (default ``model.loss``) is the
    rank's mean loss. ``quant`` is None, ``"int8"``, ``"int4"`` or
    ``"auto"``; ``error_feedback`` (requires ``quant``) keeps this rank's
    residuals in ``state.ef``. Returns the global mean loss."""
    if error_feedback and quant is None:
        raise ValueError("error_feedback=True requires quant= (int8/int4/auto)")
    if quant is not None and quant not in ("int8", "int4", "auto"):
        raise ValueError(f"unknown zero2 quant mode {quant!r}; use int8/int4/auto/None")
    group, plan = state.group, state.plan
    plan_mb = _plan_mb(bucket_size_mb)
    if plan_buckets(dict(zip(plan.names, state.params)), plan_mb).buckets != plan.buckets:
        raise ValueError("bucket_size_mb must match init_zero2's")
    if error_feedback and state.ef is None:
        state.ef = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in state.params]
    loss_fn = loss_fn or (lambda x, y: model.loss(x, y, attn_impl=attn_impl))
    label = "zero2" if quant is None else f"zero2_{quant}"
    quant_bytes = {}
    if quant is not None:
        # a reduce-scatter is the ring's scatter-reduce half: half the wire bytes
        algo = {"int8": "q8_ring", "int4": "q4_ring", "auto": "quant"}[quant]
        quant_bytes = {k: v // 2 for k, v in plan_quant_wire_bytes(plan, group.size, algo).items()}
    signatures = set()
    ledger = get_memory_ledger()
    sizes = state.bucket_sizes

    def step(x, y, lr: float | None = None):
        x, y = (_batch_rows(t, group, model.device) for t in (x, y))
        sig = (tuple(x.shape), tuple(y.shape))
        first = sig not in signatures
        if first:
            signatures.add(sig)
            record_collective_plan(label, dict(zip(plan.names, state.params)), plan_mb, axis)
        for p in state.params:
            p.grad = None
        loss = loss_fn(x, y)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
        ef_buckets = None if state.ef is None else flatten_buckets(state.ef, _ef_plan(plan))
        new_ef = []
        for b, g in enumerate(flatten_buckets(grads, plan)):
            scheme = _scheme_for(quant, g.dtype)
            if scheme is None:
                if ef_buckets is not None and g.is_floating_point():
                    # an exact exchange drains the standing residual
                    shard = flat_reduce_scatter(g.float() + ef_buckets[b], group, ReduceOp.AVG)[0]
                    new_ef.append(torch.zeros_like(ef_buckets[b]))
                else:
                    shard = flat_reduce_scatter(g, group, ReduceOp.AVG)[0]
                    if ef_buckets is not None:
                        new_ef.append(ef_buckets[b])
            elif ef_buckets is None:
                shard, _ = quantized_flat_reduce_scatter(g, group, scheme, mean=True,
                                                         stochastic=True,
                                                         seed=_q8_bucket_seed(g, b))
            else:
                adj = g.float() + ef_buckets[b]
                shard, _ = quantized_flat_reduce_scatter(adj, group, scheme, mean=True,
                                                         stochastic=False)
                new_ef.append(_roundtrip_residual(adj, scheme))
            state.shards[b].grad = shard.to(g.dtype)
        if ef_buckets is not None:
            state.ef = _tree_leaves(unflatten_buckets(new_ef, _ef_plan(plan)))
        if lr is not None:
            for pg in state.optimizer.param_groups:
                pg["lr"] = lr
        state.optimizer.step()
        with torch.no_grad():
            new = [flat_all_gather(s.detach(), group, size) for s, size in zip(state.shards, sizes)]
            for p, t in zip(state.params, _tree_leaves(unflatten_buckets(new, plan))):
                p.copy_(t)
                p.grad = None
        if first and ledger.enabled:
            ledger.claim_tree("optimizer", state.optimizer.state, detail="zero2")
        loss = all_reduce(loss.detach().float(), group, ReduceOp.AVG,
                          "xla" if loss.is_cpu else "ring")
        if quant is not None:
            record_quant_sync_bytes(quant_bytes, label, axis)
        ledger.note_step_peak()
        return loss

    return step


def zero2_optax_state(state: Zero2State, kind: str = "adamw", count: int = 0):
    """The JAX ``init_zero2`` optimizer tree of ``state`` (``kind`` "adam" or
    "adamw", the optax trees of ``checkpoint.optim_state``): the moments a
    list of flat buckets, each leaf this rank's :class:`FlatShard` of the
    bucket's padded length, zeros before the first update. Also the restore
    template of :func:`load_zero2_optax_state`."""
    if kind not in ("adam", "adamw"):
        raise ValueError(f"ZeRO-2 state of kind {kind!r}: adam | adamw")
    g = state.group
    opt = state.optimizer.state
    steps = {int(opt[s]["step"]) for s in state.shards if s in opt}
    if len(steps) > 1:
        raise ValueError(f"the shards' Adam steps differ: {sorted(steps)}")

    def moments(key):
        return [FlatShard(opt[s][key] if s in opt else torch.zeros_like(s), g.rank, g.size)
                for s in state.shards]

    adam = {"count": torch.tensor(steps.pop() if steps else 0, dtype=torch.int32),
            "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    sched = {"count": torch.tensor(int(count), dtype=torch.int32)}
    return [adam, sched] if kind == "adam" else [adam, {}, sched]


def load_zero2_optax_state(state: Zero2State, tree, kind: str = "adamw") -> int:
    """Set ``state``'s optimizer from a restored :func:`zero2_optax_state`
    tree; returns the schedule's count."""
    adam, sched = tree[0], tree[-1]
    step = float(int(adam["count"]))
    for s, mu, nu in zip(state.shards, adam["mu"], adam["nu"]):
        state.optimizer.state[s] = {"step": torch.tensor(step, dtype=torch.float32),
                                    "exp_avg": mu.to(s.device, s.dtype),
                                    "exp_avg_sq": nu.to(s.device, s.dtype)}
    return int(sched["count"])


def zero2_abstract_state(model, state: Zero2State, kind: str = "adamw", count: int = 0) -> dict:
    """The checkpoint tree ``{"params", "opt_state"}`` of a ZeRO-2 run (what
    ``CheckpointManager.save`` takes, and the restore template): the
    replicated parameter tree and :func:`zero2_optax_state` after ``count``
    updates."""
    return {"params": nest_paths({k: p.detach() for k, p in zip(state.plan.names, state.params)}),
            "opt_state": zero2_optax_state(state, kind, count)}


def restore_zero2(manager, model, state: Zero2State, step: int | None = None,
                  kind: str = "adamw") -> int:
    """Restore a ZeRO-2 checkpoint (either package's, at any fsdp width)
    into ``model`` and ``state``: the replicated parameters, and this
    rank's 1/n of every flat moment bucket re-sliced from the saved
    buckets. Returns the schedule's count."""
    tree = manager.restore(step, template=zero2_abstract_state(model, state, kind),
                           partial=True)
    flat = {}
    for path, leaf in _walk(tree["params"]):
        flat[path] = leaf
    with torch.no_grad():
        for name, p in zip(state.plan.names, state.params):
            p.copy_(flat[name])
        for s, f in zip(state.shards, flatten_buckets(state.params, state.plan)):
            s.copy_(_local_shard(f.detach(), state.group.size, state.group.rank))
    return load_zero2_optax_state(state, tree["opt_state"], kind)


def _walk(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, node
