"""The port's hybrid train step with a sequence axis (``sp`` or ``cp``),
alone and composed with dp, fsdp, tp and pp, against the JAX package's
hybrid step on the CPU in f32; the eval loss on those meshes, a cp × dp
checkpoint restored elsewhere, and ``train_gpt2 --sp``.

One module fixture starts a spawn of four gloo ranks that run the
programs of ``ROUNDS`` (two 2-rank meshes side by side, or one 4-rank
mesh): two Adam steps of a tiny model (one layer, two under a pipeline)
from the weights of ``SEED`` on one batch, the first step's gradients,
the eval loss after them and the final weights, every rank its own
pieces. The JAX hybrid step compiles and runs on the ``devices8`` virtual
mesh of each program's spec in this process meanwhile, one oracle a mesh:
the XLA ring ``"ring"`` under GPipe, whatever the program's impl and
schedule. The JAX package's sequence impls and schedules agree to
rounding (its own suite pins that); its Pallas ring2 costs more than ten
seconds a compile in interpret mode and its 1F1B step cannot lower a
Pallas call under ``check_vma``; the port's flash impls are held against
the JAX flash functions in ``tests/test_torch_long_context.py``."""

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.checkpoint import native
from dsml_tpu_torch.checkpoint.optim_state import (load_mesh_state, load_optax_state,
                                                   load_param_tree, mesh_state, optax_state,
                                                   param_tree)
from dsml_tpu_torch.cli import train_gpt2
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models.common import shard_leaf
from dsml_tpu_torch.models.convert import params_to_numpy
from dsml_tpu_torch.parallel.hybrid import (_global_name, default_attn_impl, hybrid_eval_loss,
                                            hybrid_model, init_hybrid, make_hybrid_train_step)
from dsml_tpu_torch.parallel.mesh import AXES, Mesh, MeshSpec, build_mesh, rank_coords
from dsml_tpu_torch.utils.checkpoint import Checkpointer

SEED, LR = 3, 1e-3
B, S = 4, 32
KIND = "adam"
# the step losses against the JAX hybrid step's (the JAX suite's bound for
# a sequence-parallel step tracking another, tests/test_torch_hybrid_cp.py)
LOSS_RTOL = 1e-3
# f32 gradients of a mesh step against the single-device step's, as a
# share of each tensor's largest entry (sums in another order)
GRAD_REL_TOL = 1e-4
EVAL_RTOL = 1e-5  # the eval loss against the JAX loss of the same weights
# the JAX oracles compile without XLA's backend optimizations: a third
# less compile time, the same arithmetic up to summation order
FAST_COMPILE = {"xla_backend_optimization_level": 0}

# name -> (family, mesh sizes, attn_impl (None: the mesh's default), schedule)
PROGRAMS = {
    **{f"sp2_{impl}": ("gpt2", {"sp": 2}, impl, "gpipe")
       for impl in ("ring", "ring2", "ulysses", "ulysses_flash", "ring_flash", "flash")},
    "llama_cp2": ("llama", {"cp": 2}, None, "gpipe"),
    "llama_sp2_ulysses": ("llama", {"sp": 2}, "ulysses", "gpipe"),
    "moe_sp2": ("moe", {"sp": 2}, None, "gpipe"),
    "cp2dp2": ("gpt2", {"dp": 2, "cp": 2}, None, "gpipe"),
    "fsdp2sp2": ("gpt2", {"fsdp": 2, "sp": 2}, None, "gpipe"),
    "tp2sp2": ("gpt2", {"tp": 2, "sp": 2}, "ulysses", "gpipe"),
    "pp2cp2_gpipe": ("gpt2", {"pp": 2, "cp": 2}, None, "gpipe"),
    "pp2cp2_1f1b": ("gpt2", {"pp": 2, "cp": 2}, None, "1f1b"),
}
_TWO = [n for n, p in PROGRAMS.items() if len(p[1]) == 1]
ROUNDS = [[(a, (0, 1)), (b, (2, 3))] for a, b in zip(_TWO[::2], _TWO[1::2])]
ROUNDS += [[(_TWO[-1], (0, 1))]] if len(_TWO) % 2 else []
ROUNDS += [[(n, (0, 1, 2, 3))] for n, p in PROGRAMS.items() if len(p[1]) == 2]
# the capacity of the expert layer is a token shard's: no single-device oracle
NO_SINGLE = {"moe_sp2"}


def _config(fam, port=True, n_layer=1):
    """The tiny model of ``fam`` at ``n_layer`` layers (one, or two for a
    pipeline: the JAX oracles compile in a fraction of the time)."""
    if fam == "llama":
        cfg = tllama.LlamaConfig.tiny() if port else _jax_cls(fam)[1].tiny()
    else:
        cls = tgpt2.GPT2Config if port else _jax_cls(fam)[1]
        cfg = cls.tiny(n_experts=4 if fam == "moe" else 0)
    return dataclasses.replace(cfg, max_seq=S, n_layer=n_layer)


def _layers(name):
    return 2 if "pp" in PROGRAMS[name][1] else 1


def _program_config(name):
    return _config(PROGRAMS[name][0], n_layer=_layers(name))


def _port_cls(fam):
    return tllama.Llama if fam == "llama" else tgpt2.GPT2


def _jax_cls(fam):
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import Llama, LlamaConfig

    return (Llama, LlamaConfig) if fam == "llama" else (GPT2, GPT2Config)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (B, S)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _spec(sizes):
    n = int(np.prod(list(sizes.values())))
    return MeshSpec(**{"dp": 1, **sizes}).resolved(n), n


def _targets(model):
    """{global name: the tensor the optimizer updates} (ZeRO-3 shards under
    fsdp, this rank's tp shard and pp stage otherwise)."""
    zero3 = getattr(model, "fsdp", None)
    if zero3 is not None:
        return {_global_name(model, n): s for n, _, _, s in zero3.entries}
    return {_global_name(model, n): p for n, p in model.named_parameters()}


def _run_program(name, rank, world, tmp):
    fam, sizes, impl, schedule = PROGRAMS[name]
    spec, n = _spec(sizes)
    assert n == world
    workdir = os.path.join(tmp, name)  # the program's rendezvous and notice boards
    os.makedirs(workdir, exist_ok=True)
    mesh = build_mesh(spec, rank, world, os.path.join(workdir, "rendezvous"), "cpu")
    model = hybrid_model(_port_cls(fam), _program_config(name), mesh)
    model, opt = init_hybrid(model, torch.optim.Adam(model.parameters(), lr=LR), mesh, SEED)
    n_micro = 2 if spec.pp > 1 else 1
    step = make_hybrid_train_step(model, opt, mesh, attn_impl=impl, n_microbatches=n_micro,
                                  schedule=schedule)
    x, y = (torch.from_numpy(t) for t in _batch())
    losses = [float(step(x, y))]
    grads = {k: t.grad.clone() for k, t in _targets(model).items()}
    losses.append(float(step(x, y)))
    out = {"coords": mesh.coords, "losses": losses, "grads": grads,
           "eval": float(hybrid_eval_loss(model, mesh, impl or default_attn_impl(mesh), x, y,
                                          n_micro)),
           "weights": {k: t.detach().clone() for k, t in _targets(model).items()}}
    if name == "cp2dp2":
        ckpt = Checkpointer(os.path.join(tmp, "ckpt"), mesh=mesh)
        ckpt.save(2, **mesh_state(model, opt, mesh, KIND, 2))
        ckpt.close()
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


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_key(name):
    """The JAX oracle's (family, sizes, layers) of a program: one oracle a
    mesh, whatever the impl and schedule (see the module docstring)."""
    fam, sizes = PROGRAMS[name][:2]
    return fam, tuple(sorted(sizes.items())), _layers(name)


def _jax_losses(key, devices):
    """Two steps of the JAX hybrid step (Adam, the same seed and batch,
    the XLA ring, GPipe) on the JAX mesh of the same spec."""
    import jax
    import jax.numpy as jnp
    import optax

    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid
    from dsml_tpu.parallel.hybrid import make_hybrid_train_step as jax_step
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    fam, sizes, n_layer = key
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    mesh = jax_build_mesh(JaxMeshSpec(**{"dp": 1, **sizes}), devices[:n])
    model = _jax_cls(fam)[0](_config(fam, port=False, n_layer=n_layer))
    opt = optax.adam(LR)
    params, state = jax_init_hybrid(model, opt, mesh, seed=SEED)
    step = jax_step(model, opt, mesh, attn_impl="ring",
                    n_microbatches=2 if sizes.get("pp", 1) > 1 else 1)
    x, y = (jnp.asarray(t) for t in _batch())
    compiled = step.lower(params, state, x, y).compile(compiler_options=FAST_COMPILE)
    placed = compiled.input_shardings[0][:2]  # the updated state back onto them
    losses = []
    for _ in range(2):
        params, state, loss = compiled(*jax.device_put((params, state), placed), x, y)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("hybrid_sp")
    ranks = mp.spawn(_worker, args=(str(tmp),), nprocs=4, join=False)
    keys = list(dict.fromkeys(_jax_key(name) for name in PROGRAMS))
    # XLA compiles outside the GIL: three at a time
    with ThreadPoolExecutor(3) as pool:
        jax_losses = dict(zip(keys, pool.map(lambda k: _jax_losses(k, devices8), keys)))
    while not ranks.join():
        pass
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    by_program = {}
    for round_ in ROUNDS:
        for name, members in round_:
            by_program[name] = [res[r][name] for r in members]
    return {"ranks": by_program, "jax": jax_losses, "ckpt": os.path.join(tmp, "ckpt")}


@pytest.fixture(scope="module")
def single():
    """The port's single-device step of each family and depth (plain
    attention, the same seed and batch): the first step's gradients."""
    x, y = (torch.from_numpy(t).long() for t in _batch())
    out = {}
    for fam, n_layer in {(PROGRAMS[n][0], _layers(n)) for n in PROGRAMS if n not in NO_SINGLE}:
        model = _port_cls(fam)(_config(fam, n_layer=n_layer), device="cpu").init(SEED)
        model.loss(x, y, attn_impl="xla").backward()
        out[fam, n_layer] = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out


def _sizes(name):
    spec, _ = _spec(PROGRAMS[name][1])
    return spec.sizes_dict()


def _global_weights(name, ranks):
    """{name: full tensor} reassembled from every rank's pieces."""
    fam, sizes = PROGRAMS[name][0], _sizes(name)
    meta = _port_cls(fam)(_program_config(name), device="meta")
    specs = meta.param_specs(fsdp=sizes["fsdp"])
    shapes = {n: p.shape for n, p in meta.named_parameters()}
    full = {}
    for r in ranks:
        for n, piece in r["weights"].items():
            t = full.setdefault(n, torch.zeros(shapes[n]))
            index = []
            for dim, axis in enumerate(specs[n]):
                k = sizes.get(axis, 1) if axis is not None else 1
                step = shapes[n][dim] // k
                c = r["coords"][axis] if k > 1 else 0
                index.append(slice(c * step, (c + 1) * step))
            t[tuple(index)] = piece
    return full


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_step_losses_match_the_jax_hybrid_step(run, name):
    """Two updates of the port's step on the program's mesh track the JAX
    hybrid step on the same mesh, on every rank."""
    want = run["jax"][_jax_key(name)]
    for r in run["ranks"][name]:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
    assert run["ranks"][name][0]["losses"][1] < run["ranks"][name][0]["losses"][0]


@pytest.mark.parametrize("name", [n for n in PROGRAMS if n not in NO_SINGLE])
def test_first_step_gradients_equal_the_single_device_gradients(run, single, name):
    """Every rank's gradient (its tp shard, ZeRO-3 shard or pp stage) after
    the sync is its piece of the full-sequence, full-batch gradient: the
    sequence-parallel attention carried the K/V cotangents home, the
    sequence axis summed the replicated parameters' shares (each seeded
    with 1/n_seq), and dp averaged."""
    fam, sizes = PROGRAMS[name][0], _sizes(name)
    specs = _port_cls(fam)(_program_config(name), device="meta").param_specs(fsdp=sizes["fsdp"])
    for r in run["ranks"][name]:
        for n, got in r["grads"].items():
            full = single[fam, _layers(name)][n]
            want = shard_leaf(full, specs[n], r["coords"], sizes)
            err = (got - want).abs().max().item()
            assert err <= GRAD_REL_TOL * full.abs().max().item() + 1e-12, (n, r["coords"], err)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_eval_loss_matches_jax(run, name):
    """``hybrid_eval_loss`` after the two updates: the mean over the mesh's
    sequence shards and rows equals the JAX model's loss of the same
    weights (reassembled from the ranks' pieces) on the whole batch, and
    every rank reports it."""
    fam = PROGRAMS[name][0]
    ranks = run["ranks"][name]
    params = params_to_numpy(_global_weights(name, ranks))
    want = float(_jax_loss(fam, _layers(name))(params, *_batch()))
    for r in ranks:
        assert r["eval"] == ranks[0]["eval"]
    np.testing.assert_allclose(ranks[0]["eval"], want, rtol=EVAL_RTOL)


@functools.cache
def _jax_loss(fam, n_layer):
    """The JAX model's jitted loss (one compile a family and depth); for
    the expert model, whose capacity is a token shard's, the JAX example's
    eval on an sp = 2 mesh: ``pmean`` of ``hybrid_loss_fn`` over the
    sequence shards."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.parallel.hybrid import hybrid_loss_fn
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    model = _jax_cls(fam)[0](_config(fam, port=False, n_layer=n_layer))
    if fam != "moe":
        return jax.jit(model.loss)
    mesh = jax_build_mesh(JaxMeshSpec(dp=1, sp=2), jax.devices()[:2])
    lf = hybrid_loss_fn(model, "ring", None, 1, "sp")
    return jax.jit(jax.shard_map(lambda p, a, b: jax.lax.pmean(lf(p, a, b), ("dp", "sp")),
                                 mesh=mesh, in_specs=(model.param_specs(), P("dp", "sp"),
                                                      P("dp", "sp")),
                                 out_specs=P(), check_vma=False))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_replicas_stay_identical(run, name):
    """Ranks that hold the same piece (the same tp, fsdp and pp
    coordinates: replicas over the sequence axis and dp) end the two
    updates with bit-identical weights, and report the same losses."""
    ranks = run["ranks"][name]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for s in ranks:
            if all(r["coords"][a] == s["coords"][a] for a in ("pp", "fsdp", "tp")):
                for n, t in r["weights"].items():
                    assert torch.equal(t, s["weights"][n]), (n, r["coords"], s["coords"])


def _rank_mesh(sizes, rank):
    """Rank ``rank``'s mesh of ``sizes`` with groups that carry only a size
    and a rank (a restore communicates nothing)."""
    import types

    spec, _ = _spec(sizes)
    coords = rank_coords(spec, rank)
    groups = {a: types.SimpleNamespace(size=getattr(spec, a), rank=coords[a])
              for a in AXES if getattr(spec, a) > 1}
    return Mesh(spec, rank, torch.device("cpu"), groups, coords)


def test_cp_dp_checkpoint_restores_on_cp_and_one_device(run, devices8):
    """The cp = 2 × dp = 2 checkpoint (parameters replicated over cp and
    dp: rank 0 wrote every block): each rank of a cp = 2 mesh and the
    single-device model restore the trained weights and moments bit for
    bit, and so does the JAX package's native restore into the
    ``init_hybrid`` template on a cp = 2 mesh and on one device."""
    import jax
    import optax

    from dsml_tpu.checkpoint.native import restore_tree as jax_restore_tree
    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    step_dir = os.path.join(run["ckpt"], native.step_dirname(2))
    want = run["ranks"]["cp2dp2"][0]["weights"]
    for rank in range(2):
        mesh = _rank_mesh({"cp": 2}, rank)
        model = hybrid_model(tgpt2.GPT2, _config("gpt2"), mesh)
        model, opt = init_hybrid(model, torch.optim.Adam(model.parameters(), lr=LR), mesh, 0)
        state = native.restore_tree(step_dir, template=mesh_state(model, opt, mesh, KIND, 0))
        assert load_mesh_state(model, opt, mesh, KIND, state) == 2
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), want[n]), n
    model = tgpt2.GPT2(_config("gpt2"), device="cpu").init(0)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    state = native.restore_tree(step_dir, template={
        "params": param_tree(model), "opt_state": optax_state(opt, model, KIND, 0)})
    load_param_tree(model, state["params"])
    assert load_optax_state(opt, model, KIND, state["opt_state"]) == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    jmodel = _jax_cls("gpt2")[0](_config("gpt2", port=False))
    for spec, devs in ((JaxMeshSpec(dp=1, cp=2), devices8[:2]), (JaxMeshSpec(dp=1), devices8[:1])):
        params, ostate = jax_init_hybrid(jmodel, optax.adam(optax.constant_schedule(LR)),
                                         jax_build_mesh(spec, devs), seed=0)
        tree = jax_restore_tree(step_dir, template={"params": params, "opt_state": ostate})
        flat = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
        got = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
               for path, v in flat.items()}
        assert set(got) == set(want)
        for n, arr in got.items():
            np.testing.assert_array_equal(arr, want[n].numpy(), err_msg=n)


def test_train_gpt2_cli_sp2_saves_and_resumes(tmp_path):
    """``train_gpt2 --sp 2 --device cpu``: two spawned ranks over the XLA
    ring, with the eval loss, save step 2 (every leaf replicated over sp);
    a run on one device resumes from it and saves step 3."""
    data = tmp_path / "stories.txt"  # a small corpus: no 1 MB draw on every rank
    data.write_bytes(train_gpt2._generated_stories(1 << 15, 0))
    args = ["--device", "cpu", "--model", "tiny", "--seq_len", "64", "--batch_size", "4",
            "--log_every", "1", "--warmup_steps", "1", "--data", str(data)]
    ckpt = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    sp = train_gpt2.main(args + ["--sp", "2", "--steps", "2", "--eval_every", "2"] + ckpt)
    resumed = train_gpt2.main(args + ["--steps", "1"] + ckpt)
    assert np.isfinite(sp["first_loss"]) and sp["last_loss"] < sp["first_loss"]
    assert np.isfinite(resumed["first_loss"]) and np.isfinite(resumed["last_loss"])
    # the resumed run started at step 2: it saved step 2 + 1
    assert sorted(os.listdir(tmp_path / "ckpt")) == [native.step_dirname(2),
                                                      native.step_dirname(3)]
