"""The port's model-parallel training, finished, against the JAX package on
the CPU: checkpoints of tp / pp / fsdp shards in the JAX ``init_hybrid``
layout (``checkpoint.optim_state.mesh_state``, ``native.MeshShard``), the
eval loss on pp and fsdp meshes (``parallel.hybrid.hybrid_eval_loss``), and
the model-parallel step's ``grad_accum`` and global-norm clip pinned against
the JAX hybrid step.

One module fixture starts a spawn of four gloo ranks that run the
programs of ``ROUNDS`` (two 2-rank meshes side by side, or one 4-rank
mesh), each one step of AdamW (eps 1e-3, so that the first update is
nearly linear in the gradient and shows its scale) under a 0.05 global-norm
clip with ``grad_accum`` 2 from the weights of ``SEED``; GPT-2 programs
save their step, the pp = 2 × tp = 2 program resumes from it, the pp = 2 and
fsdp = 2 programs evaluate first. The JAX references (the same step on the
virtual mesh, the example's eval) and a JAX-written checkpoint are made in
this process meanwhile. Cross-mesh restores run here, on rank meshes whose
groups only carry a size and a rank (a restore communicates nothing)."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.checkpoint import native
from dsml_tpu_torch.checkpoint.optim_state import (_mesh_layout, _mesh_leaves, load_mesh_state,
                                                   load_optax_state, load_param_tree, mesh_state,
                                                   optax_state, param_tree)
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.parallel.hybrid import (hybrid_eval_loss, hybrid_model, init_hybrid,
                                            make_hybrid_train_step)
from dsml_tpu_torch.parallel.mesh import AXES, Mesh, MeshSpec, build_mesh, rank_coords
from dsml_tpu_torch.utils.checkpoint import Checkpointer

SEED = 5
LR, EPS, WD, CLIP = 1e-3, 1e-3, 1e-4, 0.05
KIND = "clip_adamw"
B, S = 8, 32
# one step's weights against the JAX hybrid step's: the two packages' f32
# gradients differ in summation order (~1e-6 relative); the update is
# lr·g/(|g| + eps) with |g| ≲ eps here, so its error stays below
# lr·1e-6·|g|/eps ≈ 1e-9, far under this bound, while a gradient off by
# grad_accum× or unclipped moves a weight by ~lr = 1e-3
STEP_ATOL = 2e-7
EVAL_RTOL = 1e-6  # f32 eval loss against the JAX example's pmean(hybrid_loss_fn)
NORM_RTOL = 1e-5  # the clipped gradient's global norm against CLIP (f32 sums)

# the clip of the "accum" programs: never reached (the gradients' norm is
# O(1)), so their step shows the gradient's scale, which a clip that
# engages divides away
NO_CLIP = 1e3

# program name -> (family, mesh spec, pp_interleave, clip, saves a checkpoint, evaluates)
PROGRAMS = {
    "gpt2_pp2tp2": ("gpt2", dict(pp=2, tp=2), 1, CLIP, True, False),
    "gpt2_tp2": ("gpt2", dict(tp=2), 1, CLIP, True, False),
    "gpt2_pp2": ("gpt2", dict(pp=2), 1, CLIP, True, True),
    "gpt2_pp2v2": ("gpt2", dict(pp=2), 2, CLIP, True, False),
    "gpt2_fsdp2": ("gpt2", dict(fsdp=2), 1, CLIP, True, True),
}
MESHES = {"tp2": dict(tp=2), "pp2": dict(pp=2), "fsdp2": dict(fsdp=2),
          "pp2tp2": dict(pp=2, tp=2)}
for _mesh, _sizes in MESHES.items():
    PROGRAMS.setdefault(f"llama_{_mesh}", ("llama", _sizes, 1, CLIP, False, False))
# the grad_accum division is one line of the mp step for every family and
# mesh, after the pipelined or the plain backward: GPT-2 pins it on both
ACCUM = ("fsdp2", "pp2tp2")
for _mesh in ACCUM:
    PROGRAMS[f"gpt2_{_mesh}_accum"] = ("gpt2", MESHES[_mesh], 1, NO_CLIP, False, False)
# each round: (program, its ranks of the four) run side by side
ROUNDS = [[("gpt2_pp2tp2", (0, 1, 2, 3))],
          [("gpt2_tp2", (0, 1)), ("gpt2_pp2", (2, 3))],
          [("gpt2_pp2v2", (0, 1)), ("gpt2_fsdp2", (2, 3))],
          [("llama_tp2", (0, 1)), ("llama_pp2", (2, 3))],
          [("llama_pp2tp2", (0, 1, 2, 3))],
          [("llama_fsdp2", (0, 1)), ("gpt2_fsdp2_accum", (2, 3))],
          [("gpt2_pp2tp2_accum", (0, 1, 2, 3))]]


def _config(fam, v=1, port=True):
    """The tiny model of ``fam`` (GPT-2 at four layers: pp = 2 under v = 2)."""
    if fam == "gpt2":
        cfg = tgpt2.GPT2Config.tiny() if port else _jax_cls("gpt2")[1].tiny()
        return dataclasses.replace(cfg, n_layer=4, pp_interleave=v, max_seq=S)
    cfg = tllama.LlamaConfig.tiny() if port else _jax_cls("llama")[1].tiny()
    return dataclasses.replace(cfg, pp_interleave=v, max_seq=S)


def _jax_cls(fam):
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import Llama, LlamaConfig

    return (GPT2, GPT2Config) if fam == "gpt2" else (Llama, LlamaConfig)


def _port_cls(fam):
    return tgpt2.GPT2 if fam == "gpt2" else tllama.Llama


def _batches():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(2):
        x = rng.integers(0, 512, (B, S)).astype(np.int32)
        out.append((x, np.roll(x, -1, 1).astype(np.int32)))
    return out


def _spec(sizes):
    n = int(np.prod(list(sizes.values())))
    return MeshSpec(**{"dp": 1, **sizes}).resolved(n), n


def _adamw(params):
    return torch.optim.AdamW(params, lr=LR, eps=EPS, weight_decay=WD)


def _blocks(tree) -> dict:
    """``{path: (index, shape, tensor)}`` of the MeshShard leaves of a
    :func:`mesh_state` tree, other leaves as ``(None, None, value)``."""
    out = {}
    for path, leaf in native.tree_leaves_with_path(tree):
        if isinstance(leaf, native.MeshShard):
            out[path] = (leaf.index, tuple(leaf.shape), leaf.tensor.detach().clone())
        else:
            out[path] = (None, None, leaf.clone() if torch.is_tensor(leaf) else leaf)
    return out


def _grad_blocks(model, mesh) -> dict:
    """This rank's blocks of the step's (clipped) gradient, in the
    ``init_hybrid`` layout."""
    pp = mesh.shape["pp"] > 1
    leaves = _mesh_leaves(mesh, _mesh_layout(model, mesh), lambda name, ts: (
        torch.stack([t.grad for t in ts]) if pp and name.startswith("layers.") else ts[0].grad))
    return {k: (v.index, tuple(v.shape), v.tensor.clone()) for k, v in leaves.items()}


def _run_program(name, rank, world, tmp):
    fam, sizes, v, clip, saves, evaluates = PROGRAMS[name]
    spec, n = _spec(sizes)
    assert n == world
    workdir = os.path.join(tmp, name)  # the program's rendezvous and notice boards
    os.makedirs(workdir, exist_ok=True)
    mesh = build_mesh(spec, rank, world, os.path.join(workdir, "rendezvous"), "cpu")
    cls, cfg = _port_cls(fam), _config(fam, v)
    (x, y), (x2, y2) = _batches()
    out = {"coords": mesh.coords}

    def fresh(seed):
        model = hybrid_model(cls, cfg, mesh)
        model, opt = init_hybrid(model, _adamw(model.parameters()), mesh, seed)
        step = make_hybrid_train_step(model, opt, mesh, attn_impl="xla", grad_accum=2,
                                      n_microbatches=2, clip_norm=clip)
        return model, opt, step

    model, opt, step = fresh(SEED)
    if evaluates:
        out["eval"] = float(hybrid_eval_loss(model, mesh, "xla", x, y, n_microbatches=2))
    out["loss"] = float(step(x, y, lr=LR))
    out["state"] = _blocks(mesh_state(model, opt, mesh, KIND, 1))
    out["grads"] = _grad_blocks(model, mesh)
    if saves:
        ckpt = Checkpointer(os.path.join(tmp, "ckpt", name), mesh=mesh)
        ckpt.save(1, **mesh_state(model, opt, mesh, KIND, 1))
        ckpt.close()
    if name == "gpt2_pp2tp2":  # straight on, then step 2 again from the checkpoint
        out["loss2"] = float(step(x2, y2, lr=LR))
        out["state2"] = _blocks(mesh_state(model, opt, mesh, KIND, 2))
        model, opt, step = fresh(SEED + 1)
        ckpt = Checkpointer(os.path.join(tmp, "ckpt", name), mesh=mesh)
        restored = ckpt.restore(template=mesh_state(model, opt, mesh, KIND, 0))
        ckpt.close()
        out["count"] = load_mesh_state(model, opt, mesh, KIND, restored)
        out["resumed_loss2"] = float(step(x2, y2, lr=LR))
        out["resumed_state2"] = _blocks(mesh_state(model, opt, mesh, KIND, 2))
    mesh.close()
    dist.destroy_process_group()
    return out


def _worker(rank, tmp):
    torch.set_num_threads(1)
    res = {}
    for round_ in ROUNDS:
        for name, ranks in round_:
            if rank in ranks:
                res[name] = _run_program(name, ranks.index(rank), len(ranks), tmp)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def _assemble(ranks, key) -> dict:
    """``{path: global numpy array}`` from every rank's blocks of ``key``."""
    out = {}
    for r in ranks:
        for path, (index, shape, t) in r[key].items():
            if index is None:
                out[path] = t.numpy() if torch.is_tensor(t) else t
                continue
            arr = out.setdefault(path, np.zeros(shape, np.float32))
            arr[tuple(slice(a, b) for a, b in index)] = t.numpy()
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_optimizer(clip=CLIP):
    import optax

    return optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(optax.constant_schedule(LR), eps=EPS, weight_decay=WD))


def _jax_mesh(sizes, devices):
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    n = int(np.prod(list(sizes.values())))
    return jax_build_mesh(JaxMeshSpec(**{"dp": 1, **sizes}), devices[:n])


def _flat(tree) -> dict:
    import jax

    from dsml_tpu.checkpoint.native import _path_str

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v) for p, v in leaves}


def _jax_eval(model, mesh, params, x, y):
    """The JAX example's eval on a pp mesh (``examples/train_gpt2.py``):
    ``pmean`` over dp and the sequence axis of ``hybrid_loss_fn`` with the
    pipeline over ``pp``, 2 microbatches."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.parallel.hybrid import hybrid_loss_fn

    lf = hybrid_loss_fn(model, "xla", "pp", 2, "sp")
    fn = jax.jit(jax.shard_map(
        lambda p, a, b: lax.pmean(lf(p, a, b), ("dp", "sp")), mesh=mesh,
        in_specs=(model.param_specs(pp=True), P("dp", "sp"), P("dp", "sp")), out_specs=P(),
        check_vma=False))
    return float(fn(params, x, y))


# the mesh of the JAX hybrid step, the oracle: its result is the same on any
# mesh up to f32 summation order (far under STEP_ATOL), so every port
# program is held against it in the program's layout
REF_SIZES = dict(pp=2, tp=2)


def _jax_refs(devices):
    """Per family and clip: the loss and the state after the JAX hybrid
    step from ``SEED`` on the ``REF_SIZES`` mesh; the example's eval loss
    of GPT-2's initial weights there (pp × tp: the pipelined, tp-sharded
    forward)."""
    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid
    from dsml_tpu.parallel.hybrid import make_hybrid_train_step as jax_step

    (x, y), _ = _batches()
    out = {}
    mesh = _jax_mesh(REF_SIZES, devices)
    for fam, clip in sorted({(fam, clip) for fam, _, _, clip, _, _ in PROGRAMS.values()}):
        model = _jax_cls(fam)[0](_config(fam, port=False))
        opt = _jax_optimizer(clip)
        params, state = jax_init_hybrid(model, opt, mesh, seed=SEED)
        step = jax_step(model, opt, mesh, attn_impl="xla", grad_accum=2, n_microbatches=2)
        params, state, loss = step(params, state, x, y)
        out[(fam, clip)] = {
            "loss": float(loss),
            "state": {**{f"params/{k}": a for k, a in _flat(params).items()},
                      **{f"opt_state/{k}": a for k, a in _flat(state).items()}}}
    model = _jax_cls("gpt2")[0](_config("gpt2", port=False))
    params, _ = jax_init_hybrid(model, _jax_optimizer(), mesh, seed=SEED)
    out["eval"] = _jax_eval(model, mesh, params, x, y)
    return out


def _reference(refs, name) -> dict:
    """The JAX hybrid step's loss and state in program ``name``'s layout:
    the stacked layer axis permuted by the JAX ``interleave_layer_order``
    under ``pp_interleave > 1``, and unstacked into the layer list without
    pp."""
    from dsml_tpu.parallel.pp import interleave_layer_order

    fam, sizes, v, clip, _, _ = PROGRAMS[name]
    ref = refs[(fam, clip)]
    n_layer = _config(fam).n_layer
    state = {}
    for key, a in ref["state"].items():
        if "/layers/" not in key:
            state[key] = a
        elif sizes.get("pp", 1) > 1:
            state[key] = a[interleave_layer_order(n_layer, sizes["pp"], v)] if v > 1 else a
        else:
            head, rest = key.split("/layers/", 1)
            state.update({f"{head}/layers/{i}/{rest}": a[i] for i in range(n_layer)})
    return {**ref, "state": state}


def _jax_written_checkpoint(path, devices):
    """A JAX checkpoint of the GPT-2 ``init_hybrid`` tree at pp = 2 × tp = 2
    and at fsdp = 2 whose every float leaf is random (distinct bytes in
    every block) and whose counts are 3; returns, for each tree, every
    leaf's global array and the block of it each device holds of the
    matching parameter (``init_hybrid`` shards the parameters; optax's
    moments come out of ``jit(optimizer.init)`` replicated, and a rank
    keeps the block of its parameter's)."""
    import jax
    import jax.numpy as jnp

    from dsml_tpu.checkpoint import CheckpointManager as JaxManager
    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid

    rng = np.random.default_rng(21)
    out = {}
    for name, sizes in (("pp2tp2", dict(pp=2, tp=2)), ("fsdp2", dict(fsdp=2))):
        model = _jax_cls("gpt2")[0](_config("gpt2", port=False))
        mesh = _jax_mesh(sizes, devices)
        params, state = jax_init_hybrid(model, _jax_optimizer(), mesh, seed=SEED)

        def randomize(a):
            if jnp.issubdtype(a.dtype, jnp.floating):
                return jax.device_put(rng.standard_normal(a.shape).astype(np.float32), a.sharding)
            return jax.device_put(np.full(a.shape, 3, a.dtype), a.sharding)

        tree = jax.tree.map(randomize, {"params": params, "opt_state": state})
        with JaxManager(os.path.join(path, name)) as m:
            m.save(3, tree)
        flat = {f"params/{k}": a for k, a in _flat(tree["params"]).items()}
        flat |= {f"opt_state/{k}": a for k, a in _flat(tree["opt_state"]).items()}
        index = {}
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
            from dsml_tpu.checkpoint.native import _path_str

            index["params/" + _path_str(p)] = {devices.index(s.device): s.index
                                                for s in leaf.addressable_shards}
        out[name] = {"flat": flat, "index": index}
    return out


def _param_path(path: str) -> str:
    """The parameter a state leaf belongs to (``opt_state/1/0/mu/<p>`` →
    ``params/<p>``)."""
    for moment in ("/mu/", "/nu/"):
        if moment in path:
            return "params/" + path.split(moment, 1)[1]
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices8):
    """The spawn, started first; the JAX references and the JAX-written
    checkpoint in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("mp")
    jax_ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    ctx = mp.start_processes(_worker, args=(str(tmp),), nprocs=4, join=False,
                             start_method="spawn")
    try:
        refs = _jax_refs(devices8)
        jax_shards = _jax_written_checkpoint(jax_ckpt, devices8)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    by_program = {}
    for round_ in ROUNDS:
        for name, members in round_:
            by_program[name] = [ranks[r][name] for r in members]
    return {"ranks": by_program, "refs": refs, "ckpt": os.path.join(tmp, "ckpt"),
            "jax_ckpt": jax_ckpt, "jax_shards": jax_shards}


# ---------------------------------------------------------------------------
# rank meshes of sizes and coordinates alone (restores communicate nothing)
# ---------------------------------------------------------------------------


def _rank_mesh(sizes, rank):
    spec, _ = _spec(sizes)
    coords = rank_coords(spec, rank)
    groups = {a: types.SimpleNamespace(size=getattr(spec, a), rank=coords[a])
              for a in AXES if getattr(spec, a) > 1}
    return Mesh(spec, rank, torch.device("cpu"), groups, coords)


def _rank_model(fam, sizes, rank, v=1):
    mesh = _rank_mesh(sizes, rank)
    model = hybrid_model(_port_cls(fam), _config(fam, v), mesh)
    model, opt = init_hybrid(model, _adamw(model.parameters()), mesh, SEED + 7)
    return mesh, model, opt


def _restore_rank(ckpt_dir, fam, sizes, rank, v=1):
    """Rank ``rank`` of ``sizes`` restores ``ckpt_dir``: the restored
    state's blocks (as :func:`_blocks`) and the schedule's count."""
    mesh, model, opt = _rank_model(fam, sizes, rank, v)
    state = native.restore_tree(ckpt_dir, template=mesh_state(model, opt, mesh, KIND, 0))
    count = load_mesh_state(model, opt, mesh, KIND, state)
    return _blocks(mesh_state(model, opt, mesh, KIND, count)), count


def _step_dir(run, name, step=1):
    return os.path.join(run["ckpt"], name, native.step_dirname(step))


def _jax_restore(ckpt_dir, fam, sizes, devices, v=1):
    """The JAX package's native restore into the ``init_hybrid`` template."""
    from dsml_tpu.checkpoint.native import restore_tree as jax_restore_tree
    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid

    model = _jax_cls(fam)[0](_config(fam, v, port=False))
    params, state = jax_init_hybrid(model, _jax_optimizer(), _jax_mesh(sizes, devices), seed=0)
    tree = jax_restore_tree(ckpt_dir, template={"params": params, "opt_state": state})
    return {"params/" + k: a for k, a in _flat(tree["params"]).items()} | {
        "opt_state/" + k: a for k, a in _flat(tree["opt_state"]).items()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

SAVED = ["gpt2_tp2", "gpt2_pp2", "gpt2_pp2v2", "gpt2_pp2tp2", "gpt2_fsdp2"]


@pytest.mark.parametrize("name", SAVED)
def test_port_checkpoint_restores_in_jax_bit_for_bit(run, devices8, name):
    """A port checkpoint of a tp / pp / pp × tp / fsdp mesh (every rank its
    own blocks) restores in the JAX package's native restore into the
    ``init_hybrid`` template: every leaf equals the port ranks' state
    assembled to global shape bit for bit, and the JAX hybrid step's state
    after the same step within ``STEP_ATOL`` (the stacked, interleave-
    permuted layer axis included)."""
    fam, sizes, v, _, _, _ = PROGRAMS[name]
    got = _jax_restore(_step_dir(run, name), fam, sizes, devices8, v)
    port = _assemble(run["ranks"][name], "state")
    want = _reference(run["refs"], name)["state"]
    assert set(got) == set(port) == set(want)
    for path, arr in got.items():
        np.testing.assert_array_equal(arr, np.asarray(port[path]), err_msg=path)
        np.testing.assert_allclose(arr, want[path], atol=STEP_ATOL, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ["pp2tp2", "fsdp2"])
def test_jax_checkpoint_restores_into_port_rank_slices(run, name):
    """A checkpoint the JAX package wrote from a pp = 2 × tp = 2 (or fsdp =
    2) mesh, every leaf random: each port rank restores exactly the block
    JAX device r holds, every leaf bit for bit, and the counts."""
    sizes = dict(pp=2, tp=2) if name == "pp2tp2" else dict(fsdp=2)
    ckpt_dir = os.path.join(run["jax_ckpt"], name, native.step_dirname(3))
    flat, index = run["jax_shards"][name]["flat"], run["jax_shards"][name]["index"]
    for rank in range(int(np.prod(list(sizes.values())))):
        blocks, count = _restore_rank(ckpt_dir, "gpt2", sizes, rank)
        assert count == 3 and set(blocks) == set(flat)
        for path, (_, _, t) in blocks.items():
            at = index.get(_param_path(path), {}).get(rank, ())
            np.testing.assert_array_equal(np.asarray(t), flat[path][at], err_msg=path)


def test_resume_is_bit_identical(run):
    """pp = 2 × tp = 2: step 2 from fresh model and optimizer objects
    restored from the step-1 checkpoint equals the uninterrupted step 2:
    the loss and every leaf (weights, AdamW moments, counts) bit for bit."""
    for r in run["ranks"]["gpt2_pp2tp2"]:
        assert r["count"] == 1
        assert r["resumed_loss2"] == r["loss2"]
        assert set(r["resumed_state2"]) == set(r["state2"])
        for path, (_, _, t) in r["state2"].items():
            assert torch.equal(r["resumed_state2"][path][2], t), path


# (saved program, restoring family sizes, interleave, JAX accepts)
CROSS = {
    "tp2_at_tp4": ("gpt2_tp2", dict(tp=4), 1, True),
    "tp2_at_dp2": ("gpt2_tp2", dict(dp=2), 1, True),
    "pp2_at_pp4": ("gpt2_pp2", dict(pp=4), 1, True),
    "pp2tp2_at_pp4": ("gpt2_pp2tp2", dict(pp=4), 1, True),
    "fsdp2_at_fsdp4_tp2": ("gpt2_fsdp2", dict(fsdp=4, tp=2), 1, True),
    "pp2v2_at_pp2v1": ("gpt2_pp2v2", dict(pp=2), 1, True),
    "pp2_at_tp2": ("gpt2_pp2", dict(tp=2), 1, False),
    "tp2_at_pp2": ("gpt2_tp2", dict(pp=2), 1, False),
}


@pytest.mark.parametrize("case", list(CROSS))
def test_cross_mesh_restore_accepts_what_jax_accepts(run, devices8, case):
    """A checkpoint restores on another mesh exactly where the JAX
    package's restore accepts it: the global arrays are the same at any tp,
    fsdp or dp width and any pp of the stacked axis (each rank then holds
    its block of the JAX restore's arrays, bit for bit); another
    ``pp_interleave`` restores unchecked in both packages (the stacked
    axis's bytes as saved); pp = 1 (a layer list) and pp > 1 (a stacked
    axis) are different trees, and both packages raise."""
    saved, sizes, v, accepts = CROSS[case]
    ckpt_dir = _step_dir(run, saved)
    n = int(np.prod(list(sizes.values())))
    if not accepts:
        with pytest.raises(KeyError):
            _jax_restore(ckpt_dir, "gpt2", sizes, devices8, v)
        with pytest.raises(KeyError):
            _restore_rank(ckpt_dir, "gpt2", sizes, 0, v)
        return
    want = _jax_restore(ckpt_dir, "gpt2", sizes, devices8, v)
    for rank in range(n):
        blocks, count = _restore_rank(ckpt_dir, "gpt2", sizes, rank, v)
        assert count == 1 and set(blocks) == set(want)
        for path, (index, _, t) in blocks.items():
            cut = want[path] if index is None else want[path][tuple(slice(a, b) for a, b in index)]
            np.testing.assert_array_equal(np.asarray(t), cut, err_msg=f"rank {rank} {path}")


def test_mesh_checkpoint_restores_on_one_device(run):
    """A tp = 2 checkpoint restores into the whole single-device model
    (``param_tree`` / ``optax_state`` templates): the global arrays."""
    model = tgpt2.GPT2(_config("gpt2"), device="cpu").init(0)
    opt = _adamw(model.parameters())
    state = native.restore_tree(_step_dir(run, "gpt2_tp2"), template={
        "params": param_tree(model), "opt_state": optax_state(opt, model, KIND, 0)})
    load_param_tree(model, state["params"])
    assert load_optax_state(opt, model, KIND, state["opt_state"]) == 1
    want = _assemble(run["ranks"]["gpt2_tp2"], "state")
    got = {"params/" + k.replace(".", "/"): p.detach().numpy()
           for k, p in model.named_parameters()}
    for path, arr in got.items():
        np.testing.assert_array_equal(arr, want[path], err_msg=path)


@pytest.mark.parametrize("name", ["gpt2_pp2", "gpt2_fsdp2"])
def test_eval_loss_on_pp_and_fsdp_matches_jax(run, name):
    """``hybrid_eval_loss`` on a pp = 2 mesh (the pipelined forward over 2
    microbatches) and an fsdp = 2 mesh (the gathered weights) equals the
    JAX example's ``pmean(hybrid_loss_fn)`` (on the pp = 2 × tp = 2 mesh,
    the same value on any mesh up to f32 summation order) within
    ``EVAL_RTOL``, the same on every rank."""
    want = run["refs"]["eval"]
    ranks = run["ranks"][name]
    for r in ranks:
        assert r["eval"] == ranks[0]["eval"]
        assert abs(r["eval"] - want) <= EVAL_RTOL * abs(want), (r["eval"], want)


PINNED = [f"{fam}_{mesh}" for fam in ("gpt2", "llama") for mesh in MESHES]
PINNED += [f"gpt2_{mesh}_accum" for mesh in ACCUM]


@pytest.mark.parametrize("name", PINNED)
def test_grad_accum_and_clip_match_jax_hybrid_step(run, name):
    """``grad_accum`` 2 on the model-parallel step at tp, pp, fsdp and
    pp × tp, under a 0.05 global-norm clip (GPT-2 and Llama) and, for GPT-2
    at fsdp and pp × tp, under a clip the gradients never reach (``_accum``: a clip that
    engages divides the gradient's scale away, so only these show a wrong
    ``grad_accum`` division): the loss and every updated weight and moment
    equal the JAX hybrid step's (``optax.chain(clip_by_global_norm,
    adamw)``) within ``STEP_ATOL``; the gradient the optimizer saw,
    assembled to global shape, has global norm 0.05 when clipped and more
    without."""
    ranks = run["ranks"][name]
    ref = _reference(run["refs"], name)
    got = _assemble(ranks, "state")
    assert set(got) == set(ref["state"])
    for path, arr in got.items():
        np.testing.assert_allclose(np.asarray(arr), ref["state"][path], atol=STEP_ATOL, rtol=0,
                                   err_msg=path)
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    grads = _assemble(ranks, "grads")
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in grads.values()))
    if PROGRAMS[name][3] == CLIP:
        assert abs(norm - CLIP) <= NORM_RTOL * CLIP, norm
    else:
        assert 10 * CLIP < norm < NO_CLIP, norm
