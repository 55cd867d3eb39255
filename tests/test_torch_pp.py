"""The port's pipeline parallelism (``parallel.pp``: GPipe, the interleaved
schedule and 1F1B; the pp path of ``parallel.hybrid``; ``train_gpt2 --pp``)
against the JAX package, on the CPU.

Module-scoped fixtures spawn a pp = 2 and a pp = 2 × tp = 2 mesh over gloo;
each rank builds its stage of 4-layer tiny GPT-2 and tiny Llama
(``hybrid_model``: the layers in the interleave order at v = 2), takes its
shard of the JAX ``init`` weights and runs the hybrid step once per
schedule with a zero learning rate, saving the loss and its gradients.
The tests gather them to full shape and hold them to the single-device JAX
model's, with the JAX suite's bounds (the JAX pipelines are held to the
same single-device reference there)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.cli import train_gpt2
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel import pp as tpp
from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from dsml_tpu_torch.parallel.peer import RingGroup

SEED = 23
N_LAYER = 4
LOSS_RTOL = 5e-4  # tests/test_gpt2.py::test_pp_hybrid_loss_and_grads_match_single_device
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)  # the same test's gradient bound
# (schedule, n_microbatches, pp_interleave, remat)
RUNS = {"gpipe": ("gpipe", 2, 1, False), "1f1b": ("1f1b", 4, 1, False),
        "interleaved": ("gpipe", 2, 2, False), "gpipe_remat": ("gpipe", 2, 1, True),
        "gpipe_int8": ("gpipe", 2, 1, "int8")}
MESHES = {"pp2": dict(pp=2), "pp2_tp2": dict(pp=2, tp=2)}
# every schedule on both families, the remat modes on GPT-2
CASES = [(fam, run) for fam in ("gpt2", "llama") for run in ("gpipe", "1f1b", "interleaved")] + \
    [("gpt2", "gpipe_remat"), ("gpt2", "gpipe_int8")]


def _configs():
    from dsml_tpu.models.gpt2 import GPT2Config
    from dsml_tpu.models.llama import LlamaConfig

    return {
        "gpt2": (tgpt2.GPT2, dataclasses.replace(tgpt2.GPT2Config.tiny(), n_layer=N_LAYER),
                 dataclasses.replace(GPT2Config.tiny(), n_layer=N_LAYER)),
        "llama": (tllama.Llama, dataclasses.replace(tllama.LlamaConfig.tiny(), n_layer=N_LAYER),
                  dataclasses.replace(LlamaConfig.tiny(), n_layer=N_LAYER)),
    }


def _batch(seed=24, batch=8, seq=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from dsml_tpu.models.gpt2 import GPT2
    from dsml_tpu.models.llama import Llama

    x, y = _batch()
    out = {}
    for fam, (_, _, jcfg) in _configs().items():
        model = (GPT2 if fam == "gpt2" else Llama)(jcfg)
        params = model.init(SEED)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, x, y)
        out[fam] = {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
                    "grads": params_from_jax(jax.tree.map(np.asarray, grads))}
    return out


def _pp_worker(rank, tmp, spec, trees):
    torch.set_num_threads(1)
    world = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), rank, world, os.path.join(tmp, "rendezvous"), "cpu")
    x, y = (torch.from_numpy(t) for t in _batch())
    res = {"coords": mesh.coords}
    for fam, run in CASES:
        cls, cfg, _ = _configs()[fam]
        schedule, n_micro, v, remat = RUNS[run]
        model = thybrid.hybrid_model(cls, dataclasses.replace(cfg, pp_interleave=v, remat=remat),
                                     mesh)
        model.load_state_dict(params_from_jax(trees[fam], model=model))
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = thybrid.make_hybrid_train_step(model, opt, mesh, n_microbatches=n_micro,
                                              schedule=schedule)
        loss = step(x, y)
        res[(fam, run)] = {"loss": float(loss), "layer_ids": model.layer_ids,
                           "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    # the forward schedules alone, GPipe and interleaved, on GPT-2's blocks
    group = mesh.group("pp")
    for run, v in (("apply", 1), ("apply_interleaved", 2)):
        cls, cfg, _ = _configs()["gpt2"]
        model = thybrid.hybrid_model(cls, dataclasses.replace(cfg, pp_interleave=v), mesh)
        model.load_state_dict(params_from_jax(trees["gpt2"], model=model))
        rot = model._rotary(0, x.shape[1])

        def layer_fn(layer, h):
            return model._block(layer, h, model._attend("xla"), rot)

        with torch.no_grad():
            micros = model._embed(x.long()).view(2, 4, *x.shape[1:], -1)
        layers = list(model.layers)
        if v == 1:
            res[run] = tpp.pipeline_apply(layer_fn, layers, micros, group)
        else:
            res[run] = tpp.pipeline_apply_interleaved(
                layer_fn, [layers[:len(layers) // 2], layers[len(layers) // 2:]], micros, group)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(MESHES))
def pp_run(request, tmp_path_factory, jax_side):
    spec = MESHES[request.param]
    n = int(np.prod(list(spec.values())))
    tmp = tmp_path_factory.mktemp(request.param)
    trees = {fam: side["params"] for fam, side in jax_side.items()}
    mp.spawn(_pp_worker, args=(str(tmp), spec, trees), nprocs=n, join=True)
    return spec, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                  for r in range(n)]


def _gathered(ranks, fam, run, specs):
    """Every parameter's gradient at full shape, from the stages that hold
    it (tp shards concatenated in tp order); non-layer leaves from pp stage
    0, after checking every stage holds the same."""
    out = {}
    for name, spec in specs.items():
        holders = []
        for r in ranks:
            rec = r[(fam, run)]
            local = name
            if name.startswith("layers."):
                _, lid, rest = name.split(".", 2)
                if int(lid) not in rec["layer_ids"]:
                    continue
                local = f"layers.{rec['layer_ids'].index(int(lid))}.{rest}"
            holders.append((r["coords"], rec["grads"][local]))
        stage = min(c["pp"] for c, _ in holders)
        for c, g in holders:  # every stage's copy of a non-layer leaf is the same
            twin = next(t for c2, t in holders if c2["pp"] == stage and c2["tp"] == c["tp"])
            assert torch.equal(g, twin), (name, c)
        parts = sorted((c["tp"], g) for c, g in holders if c["pp"] == stage)
        tensors = [g for _, g in parts]
        out[name] = torch.cat(tensors, spec.index("tp")) if "tp" in spec else tensors[0]
    return out


@pytest.mark.parametrize("fam,run", CASES)
def test_pipeline_loss_and_grads_match_jax(pp_run, jax_side, fam, run):
    """GPipe, interleaved (v = 2) and 1F1B: the loss on every rank and every
    gradient gathered to full shape equal the single-device JAX model's —
    the tied ``wte`` carries both its stage-0 (embedding) and last-stage
    (unembedding) shares. ``remat=True`` changes no gradient; ``"int8"``
    leaves the forward exact."""
    spec, ranks = pp_run
    want = jax_side[fam]
    for r in ranks:
        assert np.isclose(r[(fam, run)]["loss"], want["loss"], rtol=LOSS_RTOL), (run, r["coords"])
    if run == "gpipe_int8":
        return  # gradients off by the int8 stash's rounding noise
    cls, cfg, _ = _configs()[fam]
    specs = cls(cfg, device="meta").param_specs()
    got = _gathered(ranks, fam, run, specs)
    for name in specs:
        np.testing.assert_allclose(got[name].numpy(), want["grads"][name].numpy(),
                                   err_msg=f"{run} {name}", **GRAD_TOL)


@pytest.mark.parametrize("run", ["apply", "apply_interleaved"])
def test_forward_schedules_match_single_device(pp_run, jax_side, run):
    """``pipeline_apply`` / ``pipeline_apply_interleaved``: every rank gets
    every microbatch's output, equal to the single-device block stack's."""
    _, ranks = pp_run
    cls, cfg, _ = _configs()["gpt2"]
    ref = cls(cfg, device="cpu")
    ref.load_state_dict(params_from_jax(jax_side["gpt2"]["params"]))
    with torch.no_grad():
        want = ref._blocks(torch.from_numpy(_batch()[0]).long(), "xla")
    for r in ranks:
        np.testing.assert_allclose(r[run].reshape(want.shape).numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_layer,n_stage,v", [(4, 2, 1), (4, 2, 2), (8, 2, 2), (8, 2, 4),
                                               (12, 3, 2), (12, 2, 3), (16, 4, 2)])
def test_interleave_layer_order_matches_jax(n_layer, n_stage, v):
    """The permutation, and each stage's block of the permuted stacked axis
    (what ``P('pp')`` hands it in the JAX ``init_hybrid``)."""
    from dsml_tpu.parallel.pp import interleave_layer_order

    order = interleave_layer_order(n_layer, n_stage, v)
    assert tpp.interleave_layer_order(n_layer, n_stage, v) == order
    per = n_layer // n_stage
    for r in range(n_stage):
        assert tpp.stage_layer_ids(n_layer, n_stage, r, v) == order[r * per:(r + 1) * per]


def test_stacked_params_cross_into_stages(jax_side):
    """``params_from_jax`` reads the JAX stacked, interleave-permuted layer
    axis into a stage's layer positions."""
    from dsml_tpu.parallel.pp import interleave_layer_order

    cls, cfg, _ = _configs()["gpt2"]
    tree = jax_side["gpt2"]["params"]
    order = interleave_layer_order(N_LAYER, 2, 2)
    stacked = {**tree, "layers": {k: np.stack([tree["layers"][i][k.split(".")[0]][k.split(".")[1]]
                                               for i in order])
                                  for k in ("attn.wqkv", "ln_1.scale")}}
    stacked["layers"] = {"attn": {"wqkv": stacked["layers"]["attn.wqkv"]},
                         "ln_1": {"scale": stacked["layers"]["ln_1.scale"]}}
    stage = cls(dataclasses.replace(cfg, pp_interleave=2), device="meta",
                layer_ids=tpp.stage_layer_ids(N_LAYER, 2, 1, 2))
    got = params_from_jax(stacked, model=stage, layer_order=order)
    for pos, lid in enumerate(stage.layer_ids):
        np.testing.assert_array_equal(got[f"layers.{pos}.attn.wqkv"].numpy(),
                                      tree["layers"][lid]["attn"]["wqkv"])


def test_pipeline_divisibility_and_schedule_errors():
    """The JAX package's errors: layers over stages (× interleave),
    microbatches over stages for the interleave, rows over microbatches,
    and the schedule guards."""
    from dsml_tpu.parallel.pp import interleave_layer_order

    for fn in (interleave_layer_order, tpp.interleave_layer_order):
        with pytest.raises(ValueError, match="not divisible by stages×interleave=4"):
            fn(6, 2, 2)
    with pytest.raises(ValueError, match="n_layer=5 not divisible by pp=2"):
        tpp.stage_layer_ids(5, 2, 0)
    group = RingGroup(None, [0, 1], 0, "cpu")
    with pytest.raises(ValueError, match="divisible by stages: 3 % 2"):
        tpp.pipeline_train([lambda x: x, lambda x: x], None, torch.zeros(3, 1, 4), None, group)
    cls, cfg, _ = _configs()["gpt2"]
    mesh = Mesh(MeshSpec(pp=2).resolved(2), 0, torch.device("cpu"), {"pp": group},
                {"pp": 0, "dp": 0, "fsdp": 0, "sp": 0, "cp": 0, "tp": 0})
    model = thybrid.hybrid_model(cls, cfg, mesh).init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = thybrid.make_hybrid_train_step(model, opt, mesh, n_microbatches=4)
    with pytest.raises(ValueError, match="per-rank batch 6 not divisible by n_micro=4"):
        step(*(torch.zeros(6, 16, dtype=torch.long),) * 2)
    inter = thybrid.hybrid_model(cls, dataclasses.replace(cfg, pp_interleave=2), mesh)
    with pytest.raises(ValueError, match="gpipe schedule only"):
        thybrid.make_hybrid_train_step(inter, opt, mesh, schedule="1f1b")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        thybrid.make_hybrid_train_step(model, opt, mesh, schedule="zb")
    with pytest.raises(ValueError, match="pipeline stage"):
        model.loss(torch.zeros(1, 8, dtype=torch.long), torch.zeros(1, 8, dtype=torch.long))


def test_train_gpt2_cli_pp_1f1b(capsys):
    """``train_gpt2 --pp 2 --schedule 1f1b`` spawns two stages and trains;
    an ``--n_micro`` that does not divide the rows falls back, with the JAX
    example's note."""
    out = train_gpt2.main(["--device", "cpu", "--model", "tiny", "--steps", "3", "--pp", "2",
                           "--schedule", "1f1b", "--n_micro", "3", "--batch_size", "8",
                           "--grad_accum", "1", "--seq_len", "64", "--log_every", "1"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert "using n_micro=2" in capsys.readouterr().out
