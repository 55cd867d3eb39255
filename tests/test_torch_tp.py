"""The port's tensor parallelism (``parallel.tp``, the tp shards of
``models.gpt2`` / ``models.llama``, the multi-axis ``parallel.mesh`` and
``train_gpt2 --tp``) against the JAX package, on the CPU.

Module-scoped fixtures spawn a tp = 2 and a tp = 4 group over gloo; each
rank takes its shard of the JAX ``init`` weights (``params_from_jax(tree,
model=...)``) for tiny GPT-2 and tiny Llama (four kv heads at tp = 4),
computes the loss, every gradient and the vocab-shard logits, and saves
them. The tests gather the shards to full shape and hold them to the JAX
model's with the JAX suite's bounds, and the replicated leaves' gradients
against each other across ranks."""

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
from dsml_tpu_torch.parallel import tp as ttp
from dsml_tpu_torch.parallel.mesh import AXES, MeshSpec, axis_group_ranks, build_mesh, rank_coords
from dsml_tpu_torch.parallel.peer import RingGroup

SEED = 11
LOSS_RTOL = 5e-4  # tests/test_gpt2.py::test_hybrid_loss_matches_single_device
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)  # tests/test_gpt2.py::test_hybrid_gradients_match_single_device
LOGIT_TOL = dict(rtol=1e-3, atol=2e-4)  # tests/test_gpt2.py::test_tp_logits_match_single_device_exactly


def _configs():
    """(family, port class, port config, JAX config) of the tiny models."""
    from dsml_tpu.models.gpt2 import GPT2Config
    from dsml_tpu.models.llama import LlamaConfig

    return {
        "gpt2": (tgpt2.GPT2, tgpt2.GPT2Config.tiny(), GPT2Config.tiny()),
        # four kv heads, so that tp = 4 divides them
        "llama": (tllama.Llama, dataclasses.replace(tllama.LlamaConfig.tiny(), n_kv_head=4),
                  dataclasses.replace(LlamaConfig.tiny(), n_kv_head=4)),
    }


def _batch(seed=12, batch=4, seq=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX weights, loss, gradients and logits of each tiny model."""
    import jax

    from dsml_tpu.models.gpt2 import GPT2
    from dsml_tpu.models.llama import Llama

    x, y = _batch()
    out = {}
    for fam, (_, _, jcfg) in _configs().items():
        model = (GPT2 if fam == "gpt2" else Llama)(jcfg)
        params = model.init(SEED)
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, x, y)
        out[fam] = {
            "params": jax.tree.map(np.asarray, params),
            "loss": float(loss),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "logits": np.asarray(jax.jit(model.apply)(params, x)),
        }
    return out


def _tp_worker(rank, tmp, n, trees):
    torch.set_num_threads(1)
    mesh = build_mesh(MeshSpec(tp=n), rank, n, os.path.join(tmp, "rendezvous"), "cpu")
    x, y = (torch.from_numpy(t).long() for t in _batch())
    res = {"coords": mesh.coords}
    for fam, (cls, cfg, _) in _configs().items():
        model = cls(cfg, device="cpu", tp_group=mesh.group("tp"))
        model.load_state_dict(params_from_jax(trees[fam], model=model))
        ttp.reset_stats()
        loss = model.loss(x, y)
        loss.backward()
        res[fam] = {"loss": float(loss), "all_reduces": ttp.STATS["all_reduce"],
                    "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
        with torch.no_grad():
            res[fam]["logits"] = model.apply(x)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _spawn(fn, n, tmp, *args):
    mp.spawn(fn, args=(str(tmp), *args), nprocs=n, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def tp_run(request, tmp_path_factory, jax_side):
    n = request.param
    trees = {fam: side["params"] for fam, side in jax_side.items()}
    return n, _spawn(_tp_worker, n, tmp_path_factory.mktemp(f"tp{n}"), n, trees)


def _gather(ranks, fam, name, spec):
    """The full tensor from every tp rank's shard of ``name``."""
    parts = [r[fam]["grads"][name] for r in ranks]
    dim = spec.index("tp") if "tp" in spec else None
    return parts[0] if dim is None else torch.cat(parts, dim)


@pytest.mark.parametrize("fam", ["gpt2", "llama"])
def test_tp_loss_matches_jax(tp_run, jax_side, fam):
    _, ranks = tp_run
    for r in ranks:
        assert np.isclose(r[fam]["loss"], jax_side[fam]["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("fam", ["gpt2", "llama"])
def test_tp_gradients_gathered_match_jax(tp_run, jax_side, fam):
    """Every gradient, gathered to full shape, equals the single-device JAX
    gradient: the replicated leaves carry no tp× scale, the sharded ones
    are its slices (the outer-grad rule of ``dsml_tpu/parallel/hybrid.py``)."""
    n, ranks = tp_run
    cls, cfg, _ = _configs()[fam]
    specs = cls(cfg, device="meta").param_specs()
    want = jax_side[fam]["grads"]
    assert set(ranks[0][fam]["grads"]) == set(want)
    for name, spec in specs.items():
        got = _gather(ranks, fam, name, spec)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
        if "tp" not in spec:  # replicated: the same on every rank, bit for bit
            for r in ranks[1:]:
                assert torch.equal(r[fam]["grads"][name], ranks[0][fam]["grads"][name]), name


@pytest.mark.parametrize("fam", ["gpt2", "llama"])
def test_tp_logits_match_jax(tp_run, jax_side, fam):
    _, ranks = tp_run
    got = torch.cat([r[fam]["logits"] for r in ranks], -1).numpy()
    np.testing.assert_allclose(got, jax_side[fam]["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("fam", ["gpt2", "llama"])
def test_tp_all_reduce_count(tp_run, fam):
    """The JAX block's psums: embedding 1, two a layer, and the
    vocab-parallel loss's max, sum-exp and target logit; the backward's
    copies (two a layer and the unembedding's input) — the forward's count
    is 1 + 2L + 3, the backward's 2L + 1."""
    _, ranks = tp_run
    layers = _configs()[fam][1].n_layer
    for r in ranks:
        assert r[fam]["all_reduces"] == (1 + 2 * layers + 3) + (2 * layers + 1)


def test_tp_divisibility_raises():
    group = RingGroup(None, [0, 1, 2, 3], 0, "cpu")
    with pytest.raises(ValueError, match="n_head=6 not divisible by tp=4"):
        tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), n_head=6, d_model=48),
                   device="meta", tp_group=group)
    with pytest.raises(ValueError, match="vocab_size=510 not divisible by tp=4"):
        tgpt2.GPT2(tgpt2.GPT2Config.tiny(vocab_size=510), device="meta", tp_group=group)
    with pytest.raises(ValueError, match="n_head=8/n_kv_head=2 not divisible by tp=4"):
        tllama.Llama(tllama.LlamaConfig.tiny(), device="meta", tp_group=group)
    # a tp shard serves with its 1/tp of the heads; a pipeline stage does not serve
    shard = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="meta", tp_group=RingGroup(None, [0, 1], 0,
                                                                                  "cpu"))
    assert shard.init_cache(1)[0]["k"].shape[1] == tgpt2.GPT2Config.tiny().n_head // 2
    stage = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="meta", layer_ids=[1])
    with pytest.raises(NotImplementedError, match="pipeline stage"):
        stage.init_cache(1)


@pytest.mark.parametrize("spec", [dict(tp=2, pp=2), dict(pp=2, dp=2, fsdp=2), dict(dp=2, tp=4),
                                  dict(fsdp=2, tp=2, dp=2)])
def test_rank_coords_match_jax_device_order(devices8, spec):
    """Rank r takes the coordinates ``jax.devices()[r]`` takes in the JAX
    mesh (``build_mesh`` reshapes the devices in ``AXES`` order), and each
    axis group lists its ranks in coordinate order."""
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    n = int(np.prod(list(spec.values())))
    spec = {"dp": 1, **spec}
    jmesh = jax_build_mesh(JaxMeshSpec(**spec), devices8[:n])
    tspec = MeshSpec(**spec).resolved(n)
    for idx in np.ndindex(jmesh.devices.shape):
        rank = devices8.index(jmesh.devices[idx])
        assert rank_coords(tspec, rank) == dict(zip(AXES, idx))
    for axis in AXES:
        for ranks in axis_group_ranks(tspec, axis):
            assert [rank_coords(tspec, r)[axis] for r in ranks] == list(range(len(ranks)))


def test_train_gpt2_cli_tp(tmp_path):
    """``train_gpt2 --tp 2`` spawns two tensor-parallel ranks and trains;
    with ``--checkpoint_dir`` each rank saves its shards in the JAX
    ``init_hybrid`` layout, and a second run resumes from them (its
    checkpoint's update count goes on from 3)."""
    from dsml_tpu_torch.checkpoint import native

    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--model", "tiny", "--tp", "2", "--batch_size", "4",
            "--seq_len", "64", "--log_every", "1", "--checkpoint_dir", ck]
    out = train_gpt2.main(args + ["--steps", "3"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    wte = [e for e in native.read_manifest(os.path.join(ck, native.step_dirname(3)))["leaves"]
           if e["path"] == "params/wte"][0]
    assert wte["shape"] == [256, 64] and len(wte["pieces"]) == 2  # vocab rows, one piece a rank
    out = train_gpt2.main(args + ["--steps", "1"])
    assert np.isfinite(out["last_loss"])
    state = native.restore_tree(os.path.join(ck, native.step_dirname(4)))
    assert int(state["opt_state"]["1"]["2"]["count"]) == 4
