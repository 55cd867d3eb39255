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

``exp_avg`` is ``mu``, ``exp_avg_sq`` is ``nu``, ``momentum_buffer`` is
``trace`` (torch's ``None`` before the first step is optax's zero trace),
torch's per-parameter float ``step`` is Adam's int32 ``count``. The
schedule's ``count`` (the updates done) is the caller's: ``torch.optim``
keeps none for SGD. Moments keep the parameter's dtype, as optax's do.
"""

from __future__ import annotations

import torch

from dsml_tpu_torch.checkpoint.native import tree_leaves_with_path

__all__ = ["KINDS", "flat_paths", "load_optax_state", "load_param_tree", "nest_paths",
           "optax_state", "param_tree", "restore_params"]

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


def optax_state(optimizer, model, kind: str, count: int):
    """The optax state tree of ``optimizer`` (see the module table) after
    ``count`` updates: the live moments, zeros where torch has none yet.
    Also the restore template of :func:`load_optax_state`."""
    _check_kind(kind)
    named = _named_state(optimizer, model)

    def moments(key):
        return nest_paths({n: st[key] if st.get(key) is not None else torch.zeros_like(p)
                           for n, p, st in named})

    if kind == "sgd":
        return [{}, _schedule(count)]
    if kind == "momentum":
        return [{"trace": moments("momentum_buffer")}, _schedule(count)]
    steps = {int(st["step"]) for _, _, st in named if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    adam = {"count": torch.tensor(steps.pop() if steps else 0, dtype=torch.int32),
            "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    if kind == "adam":
        return [adam, _schedule(count)]
    adamw = [adam, {}, _schedule(count)]
    return adamw if kind == "adamw" else [{}, adamw]


def load_optax_state(optimizer, model, kind: str, tree) -> int:
    """Set ``optimizer``'s state from an optax state tree of ``kind``
    (restored into :func:`optax_state`'s template, so every tensor is on
    its parameter's device and in its dtype). Returns the schedule's
    ``count``: the updates done."""
    _check_kind(kind)
    named = _named_state(optimizer, model)
    if kind == "clip_adamw":
        tree = tree[1]
    sched = tree[2] if kind in ("adamw", "clip_adamw") else tree[1]
    if kind == "momentum":
        trace = flat_paths(tree[0]["trace"])
        for n, p, _ in named:
            optimizer.state[p] = {"momentum_buffer": trace[n]}
    elif kind != "sgd":
        adam = tree[0]
        mu, nu = flat_paths(adam["mu"]), flat_paths(adam["nu"])
        step = float(int(adam["count"]))
        groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
        for n, p, _ in named:
            g = groups[id(p)]
            # torch keeps the step on the host unless a fused or capturable
            # Adam reads it on the device
            on_device = g.get("fused") or g.get("capturable")
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    return int(sched["count"])
