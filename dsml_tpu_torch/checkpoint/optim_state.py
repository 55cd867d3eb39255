"""The training state of a module and its ``torch.optim`` optimizer as the
trees the JAX package checkpoints: ``params`` (the parameter tree) and
``opt_state`` (the optax state of the same optimizer), so that a checkpoint
written by either package restores in the other.

Parameter paths are the module's ``state_dict`` keys with ``.`` read as a
tree level (``layers.0.attn.wqkv`` → ``layers/0/attn/wqkv``; a level whose
keys are 0..n-1 is a list, as the JAX trees hold layer stacks).

The optax trees, by ``kind`` (``<p>`` is every parameter path), as the
JAX package builds each optimizer:

- ``sgd`` — ``optax.sgd(schedule)``: ``1/count``;
- ``momentum`` — ``optax.sgd(schedule, momentum=0.9)``: ``0/trace/<p>``,
  ``1/count``;
- ``adam`` — ``optax.adam(schedule)``: ``0/count``, ``0/mu/<p>``,
  ``0/nu/<p>``, ``1/count``;
- ``adamw`` — ``optax.adamw(schedule, ...)``: ``0/count``, ``0/mu/<p>``,
  ``0/nu/<p>``, ``2/count``;
- ``clip_adamw`` — ``optax.chain(clip or identity, adamw(schedule))``
  (``train_gpt2``): ``1/0/count``, ``1/0/mu/<p>``, ``1/0/nu/<p>``,
  ``1/2/count``.

With the reduce-on-plateau scheduler (``utils.schedules.adaptive_plateau``;
the JAX trainer's ``chain(<opt>, reduce_on_plateau)``) the tree is
``0/<the optimizer's tree above>`` and ``1/{scale, best_value,
plateau_count, cooldown_count, count, avg_value}``
(``utils.schedules.PlateauState``, in optax's field order).

``exp_avg`` is ``mu``, ``exp_avg_sq`` is ``nu``, ``momentum_buffer`` is
``trace`` (torch's ``None`` before the first step is optax's zero trace),
torch's per-parameter float ``step`` is Adam's int32 ``count``. The
schedule's ``count`` (the updates done) is the caller's: ``torch.optim``
keeps none for SGD. Moments keep the parameter's dtype, as optax's do.

On a process mesh (``parallel.mesh``; one process a rank),
:func:`mesh_state` gives the same two trees in the layout of the JAX
``init_hybrid``: every leaf at its global shape, as a
``native.MeshShard`` holding this rank's block (its tp shard, its fsdp
shard, and under pp its stage's block of the layer list stacked on a
leading axis in the ``parallel.pp.stage_layer_ids`` order, which is
``interleave_layer_order`` when ``pp_interleave > 1``; replicated over
dp and the sequence axis, sp or cp), so every rank writes only the blocks
it is the lowest rank to hold and restores only its own; :func:`load_mesh_state` puts a restored tree back into the model (or
its ZeRO-3 shards) and the optimizer. As the JAX restore, a restore
needs the template's paths and global shapes: any tp, fsdp or dp width
restores (where the model's splits divide), pp = 1 (a list of layers) and
pp > 1 (a stacked axis) are different trees and raise, and the layer
order of another ``pp_interleave`` or another pp under interleave is not
checked (the JAX package's restore does not check it either).
"""

from __future__ import annotations

import torch

from dsml_tpu_torch.checkpoint.native import MeshShard, tree_leaves_with_path

__all__ = ["KINDS", "flat_paths", "load_mesh_state", "load_optax_state", "load_param_tree",
           "mesh_state", "nest_paths", "optax_state", "param_tree", "restore_params"]

KINDS = ("sgd", "momentum", "adam", "adamw", "clip_adamw")


def nest_paths(flat: dict) -> dict:
    """``{dotted path: leaf}`` → nested dicts, with lists where a level's
    keys are 0..n-1."""
    root: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def flat_paths(tree) -> dict:
    """Inverse of :func:`nest_paths`: ``{dotted path: leaf}``."""
    return {path.replace("/", "."): leaf for path, leaf in tree_leaves_with_path(tree)}


def param_tree(model) -> dict:
    """``model``'s ``state_dict`` as the JAX parameter tree (the module's
    own tensors, detached: a checkpoint snapshot copies them)."""
    return nest_paths(model.state_dict())


def load_param_tree(model, tree) -> None:
    """Copy a parameter tree into ``model`` (every key, in place, onto the
    module's devices and dtypes)."""
    model.load_state_dict(flat_paths(tree))


def restore_params(manager, model, step: int | None = None) -> None:
    """The weights-only partial restore of a checkpoint's ``params``
    subtree (either package's; ``manager`` a ``CheckpointManager`` or a
    ``utils.checkpoint.Checkpointer``) into ``model``, cast to its dtype. A
    whole model is its own template and restores in place; a tp shard or a
    pipeline stage reads the whole model's arrays on the host and keeps its
    own blocks of them (``load_full``), the JAX restore onto a
    ``shard_params`` template."""
    if not model.is_partial:
        load_param_tree(model, manager.restore(step, template={"params": param_tree(model)},
                                               partial=True)["params"])
        return
    whole = type(model)(model.config, device="meta")
    template = nest_paths({name: torch.empty(p.shape, dtype=p.dtype)
                           for name, p in whole.state_dict().items()})
    model.load_full(flat_paths(manager.restore(step, template={"params": template},
                                               partial=True)["params"]))


def _named_state(optimizer, model) -> list:
    """``[(dotted name, param, torch state)]`` of the parameters
    ``optimizer`` updates, which must be all of ``model``'s."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    missing = sorted(set(names.values()) - {names.get(id(p)) for p in params})
    if missing or any(id(p) not in names for p in params):
        raise ValueError("the optimizer must update exactly the model's parameters "
                         f"(not updated: {missing[:4]})")
    return [(names[id(p)], p, optimizer.state.get(p, {})) for p in params]


def _schedule(count) -> dict:
    return {"count": torch.tensor(int(count), dtype=torch.int32)}


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer state kind {kind!r}; choose from {KINDS}")


def _optax_tree(kind: str, count: int, adam_step: int, moments):
    """The optax state tree of ``kind`` after ``count`` updates, Adam's
    count ``adam_step``, ``moments(key)`` the tree of torch state ``key``."""
    if kind == "sgd":
        return [{}, _schedule(count)]
    if kind == "momentum":
        return [{"trace": moments("momentum_buffer")}, _schedule(count)]
    adam = {"count": torch.tensor(adam_step, dtype=torch.int32),
            "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    if kind == "adam":
        return [adam, _schedule(count)]
    adamw = [adam, {}, _schedule(count)]
    return adamw if kind == "adamw" else [{}, adamw]


def _adam_step(states) -> int:
    steps = {int(st["step"]) for st in states if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    return steps.pop() if steps else 0


def optax_state(optimizer, model, kind: str, count: int, plateau=None):
    """The optax state tree of ``optimizer`` (see the module table) after
    ``count`` updates: the live moments, zeros where torch has none yet;
    chained with ``plateau``'s state when given. Also the restore template
    of :func:`load_optax_state`."""
    _check_kind(kind)
    named = _named_state(optimizer, model)

    def moments(key):
        return nest_paths({n: st[key] if st.get(key) is not None else torch.zeros_like(p)
                           for n, p, st in named})

    tree = _optax_tree(kind, count, _adam_step(st for _, _, st in named), moments)
    return tree if plateau is None else [tree, plateau.state()]


def _unpack_optax(kind: str, tree):
    """(the schedule's count, Adam's count or None, {torch key: flat
    moments}) of an optax state tree of ``kind``."""
    if kind == "clip_adamw":
        tree = tree[1]
    sched = tree[2] if kind in ("adamw", "clip_adamw") else tree[1]
    if kind == "sgd":
        return int(sched["count"]), None, {}
    if kind == "momentum":
        return int(sched["count"]), None, {"momentum_buffer": flat_paths(tree[0]["trace"])}
    adam = tree[0]
    return int(sched["count"]), int(adam["count"]), {"exp_avg": flat_paths(adam["mu"]),
                                                     "exp_avg_sq": flat_paths(adam["nu"])}


def _set_state(optimizer, groups, p, adam_step, moments: dict) -> None:
    """``optimizer``'s state of parameter ``p``: its moments and, for Adam,
    the step (on the host unless a fused or capturable Adam reads it on
    the device)."""
    if adam_step is None:
        optimizer.state[p] = dict(moments)
        return
    g = groups[id(p)]
    on_device = g.get("fused") or g.get("capturable")
    optimizer.state[p] = {"step": torch.tensor(float(adam_step), dtype=torch.float32,
                                               device=p.device if on_device else "cpu"),
                          **moments}


def load_optax_state(optimizer, model, kind: str, tree, plateau=None) -> int:
    """Set ``optimizer``'s state (and ``plateau``'s, when given) from an
    optax state tree of ``kind`` (restored into :func:`optax_state`'s
    template, so every tensor is on its parameter's device and in its
    dtype). Returns the schedule's ``count``: the updates done."""
    _check_kind(kind)
    if plateau is not None:
        tree, plateau_state = tree
        plateau.load_state(plateau_state)
    named = _named_state(optimizer, model)
    count, adam_step, moments = _unpack_optax(kind, tree)
    if moments:
        groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
        for n, p, _ in named:
            _set_state(optimizer, groups, p, adam_step, {k: m[n] for k, m in moments.items()})
    return count


# ---------------------------------------------------------------------------
# the JAX init_hybrid layout on a process mesh
# ---------------------------------------------------------------------------


def _block_index(shape, spec, sizes: dict, coords: dict) -> list:
    """``[[start, stop], ...]`` of the block a rank at ``coords`` holds of a
    leaf of ``shape`` laid out by ``spec`` (a mesh axis or None per leading
    dim)."""
    index = []
    for i, g in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if axis is None:
            index.append([0, int(g)])
        else:
            n = g // sizes[axis]
            index.append([coords[axis] * n, (coords[axis] + 1) * n])
    return index


def _mesh_layout(model, mesh) -> dict:
    """``{JAX tree name: (this rank's tensors, spec, global shape)}`` of the
    ``init_hybrid`` tree: the tensors the optimizer updates (ZeRO-3 shards
    under fsdp), one a leaf, or under pp the stage's layers of a stacked
    leaf in stacked order."""
    cfg = model.config
    pp = mesh.shape.get("pp", 1) > 1
    specs = model.param_specs(fsdp=mesh.shape.get("fsdp", 1))
    shapes = {n: tuple(p.shape) for n, p in type(model)(cfg, device="meta").named_parameters()}
    zero3 = getattr(model, "fsdp", None)
    layout: dict = {}
    for name, p in model.named_parameters():
        target = p if zero3 is None else zero3.shard_of[name]
        if name.startswith("layers."):
            _, pos, rest = name.split(".", 2)
            gname = f"layers.{model.layer_ids[int(pos)]}.{rest}"
            if pp:
                entry = layout.setdefault(f"layers.{rest}", (
                    [], ("pp", *specs[gname]), (cfg.n_layer, *shapes[gname])))
                entry[0].append(target)
                continue
        else:
            gname = name
        layout[gname] = ([target], specs[gname], shapes[gname])
    return layout


def _mesh_leaves(mesh, layout: dict, block) -> dict:
    """``{JAX tree name: MeshShard}`` of ``block(name, tensors)`` (this
    rank's block of each leaf of ``layout``), with every leaf's pieces and
    this rank's ownership."""
    from dsml_tpu_torch.parallel.mesh import AXES, rank_coords

    sizes = mesh.shape
    world = 1
    for n in sizes.values():
        world *= n
    all_coords = [rank_coords(mesh.spec, r) for r in range(world)]
    sharding_of = {}
    out = {}
    for name, (tensors, spec, shape) in layout.items():
        key = (spec, shape)
        if key not in sharding_of:
            holders: dict = {}
            for r, c in enumerate(all_coords):
                idx = _block_index(shape, spec, sizes, c)
                holders.setdefault(tuple(map(tuple, idx)), r)  # ranks ascend: the first is lowest
            pieces = [[list(ab) for ab in k] for k in sorted(holders)]
            sharding = {"spec": [None if a is None else [a] for a in spec],
                        "mesh_axes": list(AXES), "mesh_shape": [sizes[a] for a in AXES]}
            sharding_of[key] = (holders, pieces, sharding)
        holders, pieces, sharding = sharding_of[key]
        index = _block_index(shape, spec, sizes, mesh.coords)
        out[name] = MeshShard(block(name, tensors), shape, index, pieces,
                              holders[tuple(map(tuple, index))] == mesh.rank, sharding)
    return out


def _stacked(tensors, stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


def mesh_state(model, optimizer, mesh, kind: str, count: int) -> dict:
    """``{"params", "opt_state"}`` of this rank of ``mesh`` in the JAX
    ``init_hybrid`` layout (see the module docstring): the parameter tree
    and the optax state tree of ``kind`` after ``count`` updates, every
    array leaf a ``native.MeshShard``. Also the restore template of
    :func:`load_mesh_state`."""
    _check_kind(kind)
    pp = mesh.shape.get("pp", 1) > 1
    layout = _mesh_layout(model, mesh)
    states = [optimizer.state.get(t, {}) for ts, _, _ in layout.values() for t in ts]

    def tree(leaf_of):
        """The tree whose leaf ``name`` is ``leaf_of(t)`` of each tensor,
        stacked under pp."""
        return nest_paths(_mesh_leaves(mesh, layout, lambda name, tensors: _stacked(
            [leaf_of(t) for t in tensors], pp and name.startswith("layers."))))

    def moments(key):
        def leaf_of(t):
            m = optimizer.state.get(t, {}).get(key)
            return torch.zeros_like(t) if m is None else m
        return tree(leaf_of)

    params = tree(lambda t: t.detach())
    return {"params": params,
            "opt_state": _optax_tree(kind, count, _adam_step(states), moments)}


@torch.no_grad()
def load_mesh_state(model, optimizer, mesh, kind: str, state) -> int:
    """Put a :func:`mesh_state` tree restored into that template back into
    the model (its ZeRO-3 shards under fsdp) and ``optimizer``. Returns
    the schedule's ``count``."""
    _check_kind(kind)
    layout = _mesh_layout(model, mesh)
    pp = mesh.shape.get("pp", 1) > 1

    def blocks(name, block):
        return list(block.unbind(0)) if pp and name.startswith("layers.") else [block]

    params = flat_paths(state["params"])
    for name, (tensors, _, _) in layout.items():
        for t, b in zip(tensors, blocks(name, params[name]), strict=True):
            t.copy_(b)
    count, adam_step, moments = _unpack_optax(kind, state["opt_state"])
    if moments:
        groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
        for name, (tensors, _, _) in layout.items():
            per = {k: blocks(name, m[name]) for k, m in moments.items()}
            for i, t in enumerate(tensors):
                _set_state(optimizer, groups, t, adam_step, {k: v[i] for k, v in per.items()})
    return count
