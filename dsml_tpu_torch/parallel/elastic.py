"""Elastic training: survive the loss of rank slots by re-planning the mesh
mid-run — the counterpart of ``dsml_tpu/parallel/elastic.py``.

The reference marks a communicator dead for good on its first failure
(``gpu_coordinator_server.go:114-118``; recovery "none", SURVEY.md §5.3).
This module is the half that continues the job on the survivors:

- :func:`reconfigure` takes the live state of a world (``parallel.world``)
  that lost slots, re-plans the parallelism for the survivors
  (``parallel.auto.plan_mesh`` over the new count, Oobleck's template
  re-instantiation) and moves the state onto a new world over them: no
  restart, no checkpoint round trip.
- :func:`check_recoverable` audits, from the world's layout alone, which
  leaves a loss would tear: a piece of a leaf is torn iff every rank that
  holds its block was lost. Under ``ElasticPolicy.require_full_state`` a
  torn state raises :class:`StateNotRecoverable` (the checkpoint fallback,
  :func:`restore_from_checkpoint`, is the caller's move); otherwise the
  torn pieces are zero-filled and the substitution recorded.

The JAX package moves state between device sets inside one process; here
the state lives in rank processes, so every host round trip of the JAX
code is one export from the survivors into a host state
(``parallel.world.HostState``, the JAX ``init_hybrid`` layout, one
``.npy`` per leaf) and one load into the new world's ranks: one pull and
one push per recovery, each timed into the returned state's ``timings``.
The layout is JAX's, so a pipeline's stacked layer axis unstacks (in the
old stage count's interleave order) and restacks (in the new one's) on the
host exactly as the JAX ``_unstack_state`` / ``_restack_state`` do.

Slots stand where the JAX package has devices: a slot id is the device id
of the JAX code, and the survivor world's rank r is the r-th survivor in
slot order, the JAX survivor mesh's device r.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np

from dsml_tpu_torch.parallel.auto import plan_mesh
from dsml_tpu_torch.parallel.mesh import MeshSpec

__all__ = [
    "ElasticPolicy",
    "ElasticState",
    "StateNotRecoverable",
    "check_recoverable",
    "reconfigure",
    "remap_error_feedback",
    "reshard_onto",
    "restore_from_checkpoint",
]


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """What to do when slots are lost.

    ``allow_shrink`` — re-plan onto the survivors (False = fail fast, the
    reference's behavior). ``require_full_state`` — refuse to continue if
    any state leaf was exclusively held by lost slots (True means: fall
    back to the checkpoint instead of silently training on a torn state;
    False means: continue anyway, with torn pieces explicitly ZERO-FILLED —
    never read from dead ranks — and the substitution recorded in the
    reconfiguration's audit trail).
    """

    allow_shrink: bool = True
    require_full_state: bool = True


@dataclasses.dataclass
class ElasticState:
    """Result of a reconfiguration: the new world (``parallel.world.World``)
    holding the state, its spec, the planner's audit trail, the restored
    checkpoint step (None for live reconfigurations), the remapped
    error-feedback residuals, and ``timings`` (seconds: ``pull_s``,
    ``push_s``, ``join_s``, and ``restore_s`` for a checkpoint restore)."""

    world: object
    spec: MeshSpec
    reasons: tuple
    step: int | None = None
    error_feedback: object = None
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def mesh(self):
        return self.world

    def host_tree(self) -> dict:
        """The state on the host, ``{"params", "opt_state"}`` as numpy."""
        host = self.world.state()
        try:
            return host.tree()
        finally:
            host.remove()

    @property
    def params(self):
        return self.host_tree()["params"]

    @property
    def opt_state(self):
        return self.host_tree()["opt_state"]


# ---------------------------------------------------------------------------
# layouts and the audit
# ---------------------------------------------------------------------------


class StateNotRecoverable(RuntimeError):
    """The survivors cannot give back the whole state: a piece is held only
    by lost slots (torn), or only by slots of another host with no
    ``ShardMigrator`` wired. The caller's move is the checkpoint fallback
    (:func:`restore_from_checkpoint`)."""


def _torn_leaves(state, lost) -> list[tuple[str, str]]:
    """(path, description) of every leaf with at least one piece held ONLY
    by lost slots. Shared by the audit (:func:`check_recoverable`) and the
    torn-state continuation in :func:`reconfigure`, so the two can never
    disagree about what "torn" means."""
    lost = set(lost)
    torn = []
    for path, (shape, _, _) in state.layout.items():
        for piece, slots in state.holders(path).items():
            if all(s in lost for s in slots):
                torn.append((path, f"{path} shape={tuple(shape)} piece={piece} "
                                   f"only on lost slots {slots}"))
                break
    return torn


def check_recoverable(state, lost_slots) -> list[str]:
    """Which state leaves would be LOST if ``lost_slots`` die right now?
    ``state`` is a ``parallel.world.World`` (its ``layout``, as its ranks
    report it, and its ``slots``). A leaf survives iff every piece of it
    has a holder outside ``lost_slots``. Returns human-readable descriptions of the torn leaves
    (empty = fully recoverable, what every dp layout gives)."""
    return [d for _, d in _torn_leaves(state, lost_slots)]


def remap_error_feedback(ef: dict, new_n: int, lost_ranks=()) -> dict:
    """Carry error-feedback residual mass across a width change.

    ``ef`` is ``{name: [old_n, *grad_shape]}`` (row i is rank i's residual,
    ``parallel.bucketing.init_error_feedback`` per rank). Under AVG each
    rank's residual enters the synced mean as ``r_i / old_n``, so the
    standing uncommitted mass is ``Σ r_i / old_n``; every new rank gets
    ``Σ_surviving r_i / old_n``, and the next sync injects exactly the mass
    the compressor still owed, at any new width. Rows of lost ranks are
    gone (their uncommitted gradient mass is lost, like their local
    gradients) and drop out of the sum. Returns ``{name: [new_n, ...]}``
    float32."""
    lost = set(lost_ranks)
    out = {}
    for name, leaf in ef.items():
        leaf = np.asarray(leaf, np.float32)
        old_n = leaf.shape[0]
        total = np.zeros(leaf.shape[1:], np.float32)
        for i in range(old_n):
            if i not in lost:
                total += leaf[i]
        row = total / old_n
        out[name] = np.broadcast_to(row, (new_n, *row.shape)).copy()
    return out


# ---------------------------------------------------------------------------
# re-planning
# ---------------------------------------------------------------------------


def _plan_for_survivors(recipe, n_params: int, survivors: list, batch_per_device: int,
                        global_batch: int | None, planner_overrides: dict | None,
                        device=None):
    """Re-instantiate the parallelism template on the survivors (the Oobleck
    choice): the capacity-rule plan for the largest slot subset whose
    dp×fsdp width divides ``global_batch``. The planner reads a survivor's
    device (``device``) unless ``planner_overrides`` gives ``hbm_bytes``
    (slots sharing one card pass their share). Returns (plan,
    survivors_used)."""
    cfg = recipe.config
    overrides = dict(planner_overrides or {})
    if survivors and device is not None:
        overrides.setdefault("device", device)
    for n_use in range(len(survivors), 0, -1):
        candidate = plan_mesh(
            n_devices=n_use, n_params=n_params, n_head=getattr(cfg, "n_head", None),
            seq_len=getattr(cfg, "max_seq", 0), d_model=getattr(cfg, "d_model", 0),
            n_layer=getattr(cfg, "n_layer", 0), batch_per_device=batch_per_device, **overrides)
        if global_batch is None or global_batch % (candidate.spec.dp * candidate.spec.fsdp) == 0:
            plan = candidate
            if n_use < len(survivors):
                plan = dataclasses.replace(plan, reasons=plan.reasons + (
                    f"global batch {global_batch} not divisible by the {len(survivors)}-chip "
                    f"plan's dp×fsdp → instantiated on {n_use} chips, "
                    f"{len(survivors) - n_use} idle",))
            return plan, survivors[:n_use]
    raise AssertionError("unreachable: the n_use=1 plan always divides")


# ---------------------------------------------------------------------------
# the host round trip
# ---------------------------------------------------------------------------


def _pull_host_state(world, lost_slots=(), migrator=None, non_addressable=(),
                     directory: str | None = None):
    """One export of the whole state into a host state, never reading a
    lost slot: each piece comes from its lowest reachable holder; pieces
    whose holders ALL died stay zero (the audited torn-state
    substitution). A piece that survives only on a NON-addressable slot
    (another host) is pulled with ``migrator`` (``comm.migration.
    ShardMigrator``; the key is the tree path, ``params/layers/0/attn/
    wqkv``); without one the refusal is loud."""
    from dsml_tpu_torch.parallel.world import HostState

    lost = set(lost_slots)
    remote = set(non_addressable)
    unreachable = lost | remote
    assignments: dict = {}
    remote_pieces = []
    for path in world.layout:
        for piece, holders in world.holders(path).items():
            src = next((s for s in holders if s not in unreachable
                        and world.pool.is_alive(s)), None)
            if src is not None:
                assignments.setdefault(src, []).append(path)
            elif all(s in lost or not world.pool.is_alive(s) for s in holders):
                continue  # torn: stays zero
            else:
                if migrator is None:
                    raise StateNotRecoverable(
                        f"piece {piece} of {path} (shape {world.layout[path][0]}) survives only "
                        f"on non-addressable slots {holders}; no ShardMigrator is wired — "
                        "restore from checkpoint on this host instead")
                remote_pieces.append((path, piece))
    host = HostState.create(directory or world.pool.new_state_dir(),
                            {p: (shape, dt) for p, (shape, dt, _) in world.layout.items()},
                            world.scalars)
    try:
        for path, piece in remote_pieces:
            dtype = world.layout[path][1]
            data = migrator.fetch_piece(path, piece, dtype)
            dst = host.array(path, mode="r+")
            arr = data.cpu().contiguous()
            arr = arr.view(np.int16).numpy() if dtype == "bfloat16" else arr.numpy()
            dst[tuple(slice(a, b) for a, b in piece)] = arr.view(dst.dtype)
            dst.flush()
            del dst
        scalars = world.export(assignments, host)
    except BaseException:
        host.remove()
        raise
    host.scalars = {**host.scalars, **scalars}
    return host


_STACKED = re.compile(r"^(.*/layers)/([^/0-9][^/]*(?:/.*)?)$")
_LISTED = re.compile(r"^(.*/layers)/(\d+)/(.*)$")


def _unstack_arrays(arrays: dict, cfg, old_pp: int) -> dict:
    """Stacked layer axis (interleave-permuted for the OLD stage count) →
    the canonical per-layer list form, for params and every params-shaped
    optimizer subtree (the JAX ``_unstack_state``)."""
    from dsml_tpu_torch.parallel.pp import interleave_layer_order

    n_layer = cfg.n_layer
    v = getattr(cfg, "pp_interleave", 1)
    order = interleave_layer_order(n_layer, old_pp, v) if v > 1 else list(range(n_layer))
    out = {}
    for path, arr in arrays.items():
        m = _STACKED.match(path)
        if m is None:
            out[path] = arr
            continue
        for pos, layer in enumerate(order):
            out[f"{m.group(1)}/{layer}/{m.group(2)}"] = np.ascontiguousarray(arr[pos])
    return out


def _restack_arrays(arrays: dict, cfg, new_pp: int) -> dict:
    """Per-layer list form → stacked layer axis in the NEW stage count's
    interleave order (identity for ``new_pp <= 1``; the JAX
    ``_restack_state``)."""
    if new_pp <= 1:
        return arrays
    from dsml_tpu_torch.parallel.pp import interleave_layer_order

    n_layer = cfg.n_layer
    v = getattr(cfg, "pp_interleave", 1)
    order = interleave_layer_order(n_layer, new_pp, v) if v > 1 else list(range(n_layer))
    groups: dict = {}
    out = {}
    for path, arr in arrays.items():
        m = _LISTED.match(path)
        if m is None:
            out[path] = arr
            continue
        groups.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = arr
    for (head, rest), layers in groups.items():
        out[f"{head}/{rest}"] = np.stack([layers[i] for i in order])
    return out


def _relayout(host, cfg, old_pp: int, new_pp: int, directory: str):
    """The host state in the new pp form (a new host state under
    ``directory``), or ``host`` itself when the form is unchanged."""
    if old_pp <= 1 and new_pp <= 1:
        return host
    arrays = host.arrays()
    if old_pp > 1:
        arrays = _unstack_arrays(arrays, cfg, old_pp)
    arrays = _restack_arrays(arrays, cfg, new_pp)
    return host.write_arrays(directory, arrays)


def _move(host, pool, slots, spec, recipe, old_pp: int, ckpt_dir: str | None, timings: dict):
    """Form ``recipe``'s world over ``slots`` and load ``host`` into it
    (relaid out for its pp first)."""
    moved = _relayout(host, recipe.config, old_pp, spec.pp, pool.new_state_dir())
    try:
        t0 = time.perf_counter()
        world = pool.form(slots, spec, seed=None, ckpt_dir=ckpt_dir, recipe=recipe)
        timings["join_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            world.load(moved)
        except BaseException:
            world.leave()
            raise
        timings["push_s"] = time.perf_counter() - t0
    finally:
        if moved is not host:
            moved.remove()
    return world


def reconfigure(
    world,
    surviving_slots,
    lost_slots=(),
    policy: ElasticPolicy = ElasticPolicy(),
    batch_per_device: int = 1,
    global_batch: int | None = None,
    planner_overrides: dict | None = None,
    migrator=None,
    non_addressable=(),
    error_feedback=None,
    ef_axis: str = "dp",
) -> ElasticState:
    """Continue training on the survivors of ``world``.

    1. Audit recoverability (:func:`check_recoverable`) — under
       ``require_full_state`` a torn state raises instead of continuing.
    2. Re-plan for ``len(surviving_slots)`` slots with the capacity-rule
       planner; with ``global_batch`` the plan must keep the batch
       divisible by its dp×fsdp width, and survivor counts that cannot
       instantiate the template on the largest workable subset and idle the
       rest (Oobleck's choice).
    3. Pull the state to the host once (survivors only), leave the old
       world, form the new one over the used survivors (rank r = the r-th
       in slot order) and push the state into it once.

    ``error_feedback`` (``{name: [old_n, ...]}`` residual rows) is remapped
    onto the new ``ef_axis`` width (:func:`remap_error_feedback`).
    Returns :class:`ElasticState` with the new world."""
    if not policy.allow_shrink:
        raise RuntimeError(
            f"{len(lost_slots)} slot(s) lost and ElasticPolicy.allow_shrink=False "
            "(reference semantics: communicator FAILED, job dead)")
    torn_note: tuple = ()
    lost = [s for s in lost_slots if s in world.slots]
    if lost:
        torn = _torn_leaves(world, lost)
        if torn and policy.require_full_state:
            raise StateNotRecoverable(
                "training state not recoverable from survivors — restore from checkpoint "
                f"instead; torn leaves: {[d for _, d in torn[:3]]}")
        if torn:
            torn_note = (f"require_full_state=False: zero-filled the lost pieces of {len(torn)} "
                         "torn leaf/leaves: " + "; ".join(d for _, d in torn[:3]),)
    pool = world.pool
    recipe = world.recipe
    plan, used = _plan_for_survivors(recipe, recipe.n_params(), sorted(surviving_slots),
                                     batch_per_device, global_batch, planner_overrides,
                                     pool.device)
    timings: dict = {}
    t0 = time.perf_counter()
    host = _pull_host_state(world, lost, migrator=migrator, non_addressable=non_addressable)
    timings["pull_s"] = time.perf_counter() - t0
    timings["bytes"] = host.nbytes()
    try:
        world.leave()
        new_world = _move(host, pool, used, plan.spec, recipe, world.spec.pp,
                          world.ckpt_dir, timings)
    finally:
        host.remove()
    new_ef = None
    if error_feedback is not None:
        new_ef = remap_error_feedback(error_feedback, getattr(plan.spec, ef_axis),
                                      [world.slots.index(s) for s in lost])
    return ElasticState(world=new_world, spec=plan.spec, reasons=plan.reasons + torn_note,
                        error_feedback=new_ef, timings=timings)


def reshard_onto(world, slots, spec: MeshSpec, lost_slots=(), migrator=None,
                 non_addressable=()) -> ElasticState:
    """Move LIVE state onto a KNOWN topology — the grow-back primitive:
    :func:`reconfigure` re-plans, this does not (the controller returns to
    the pre-failure full world). Same pull / leave / form / push."""
    pool = world.pool
    timings: dict = {}
    t0 = time.perf_counter()
    host = _pull_host_state(world, lost_slots, migrator=migrator,
                            non_addressable=non_addressable)
    timings["pull_s"] = time.perf_counter() - t0
    timings["bytes"] = host.nbytes()
    try:
        world.leave()
        new_world = _move(host, pool, list(slots), spec.resolved(len(slots)),
                          world.recipe, world.spec.pp, world.ckpt_dir, timings)
    finally:
        host.remove()
    return ElasticState(world=new_world, spec=spec.resolved(len(slots)),
                        reasons=(f"resharded live state onto the given mesh {spec.sizes_dict()}",),
                        timings=timings)


def _saved_form(manifest: dict) -> tuple[bool, int]:
    """(stacked, pp width) of a checkpoint's params, from its manifest."""
    stacked, saved_pp = False, 1
    for e in manifest["leaves"]:
        parts = e["path"].split("/")
        if len(parts) > 2 and parts[0] == "params" and parts[1] == "layers":
            stacked = not parts[2].isdigit()
        sh = e.get("sharding")
        if sh and "pp" in sh.get("mesh_axes", []):
            saved_pp = max(saved_pp, sh["mesh_shape"][sh["mesh_axes"].index("pp")])
    return stacked, saved_pp


def restore_from_checkpoint(manager, pool, surviving_slots, step: int | None = None,
                            batch_per_device: int = 1, global_batch: int | None = None,
                            planner_overrides: dict | None = None,
                            recipe=None) -> ElasticState:
    """The Varuna-style fallback :func:`reconfigure` points at, as one call:
    re-plan for the survivors and restore the checkpoint ONTO the new
    topology. ``manager`` is a ``checkpoint.CheckpointManager`` (or a
    directory). A checkpoint of the same pp form restores rank by rank
    (every rank reads its own blocks, any dp / fsdp / tp width); one of
    another pp form goes through the host (restored whole, unstacked /
    restacked, pushed). ``recipe`` defaults to the pool's."""
    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.checkpoint import native as ckpt_native

    if isinstance(manager, str):
        manager = CheckpointManager(manager, max_to_keep=None)
    if step is None:  # resolve "latest" ONCE
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {manager.directory}")
    recipe = recipe or pool.recipe
    plan, used = _plan_for_survivors(recipe, recipe.n_params(), sorted(surviving_slots),
                                     batch_per_device, global_batch, planner_overrides,
                                     pool.device)
    manifest = ckpt_native.read_manifest(manager._step_dir(step))
    saved_stacked, saved_pp = _saved_form(manifest)
    new_pp = plan.spec.pp
    timings: dict = {}
    t0 = time.perf_counter()
    if saved_stacked == (new_pp > 1) and (not saved_stacked or saved_pp == new_pp):
        world = pool.form(used, plan.spec, seed=None, ckpt_dir=manager.directory, recipe=recipe)
        timings["join_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        try:
            world.restore(step)
        except BaseException:
            world.leave()
            raise
        timings["restore_s"] = time.perf_counter() - t1
    else:
        host = _host_from_checkpoint(manager, step, pool)
        try:
            world = _move(host, pool, used, plan.spec, recipe,
                          saved_pp if saved_stacked else 1, manager.directory, timings)
        finally:
            host.remove()
        timings["restore_s"] = time.perf_counter() - t0
    return ElasticState(
        world=world, spec=plan.spec, step=int(manifest["step"]), timings=timings,
        reasons=plan.reasons + (f"restored from checkpoint step {manifest['step']} (saved "
                                f"pp={saved_pp}, {'stacked' if saved_stacked else 'list'} form)",))


def _host_from_checkpoint(manager, step: int, pool):
    """A whole checkpoint as a host state (its saved form)."""
    import torch

    from dsml_tpu_torch.checkpoint import native as ckpt_native
    from dsml_tpu_torch.checkpoint.native import tree_leaves_with_path
    from dsml_tpu_torch.parallel.world import HostState

    tree = ckpt_native.restore_tree(manager._step_dir(step))
    arrays, scalars, leaves = {}, {}, {}
    for path, leaf in tree_leaves_with_path({"params": tree["params"],
                                            "opt_state": tree["opt_state"]}):
        if isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
            dtype = str(leaf.dtype).replace("torch.", "")
            arr = leaf.float().numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
            arrays[path] = arr
            leaves[path] = (tuple(arr.shape), dtype)
        elif isinstance(leaf, np.ndarray) and leaf.ndim > 0:
            arrays[path] = leaf
            leaves[path] = (tuple(leaf.shape), str(leaf.dtype))
        elif leaf is not None:
            scalars[path] = int(leaf)
    proto = HostState(pool.new_state_dir(), leaves, scalars)
    return proto.write_arrays(proto.directory, arrays)
