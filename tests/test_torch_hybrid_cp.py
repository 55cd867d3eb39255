"""The port's context-parallel train step (``dsml_tpu_torch.parallel.hybrid``
over ``parallel.mesh``) against the JAX package's hybrid step on a cp mesh,
on the CPU in f32.

One module-scoped fixture spawns a cp = 2 ring (gloo, rendezvous through a
file under ``tmp_path``) that takes three updates of GPT-2-tiny with
``make_hybrid_train_step`` and saves each rank's losses, first-step
gradients and final weights; the tests hold them against the JAX step on a
cp = 2 virtual CPU mesh, against the single-device step of both packages,
and against each other (the replicas must stay identical). The
``train_gpt2 --cp 2`` entry point runs here too, on the CPU."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.cli import train_gpt2
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh

SEED, LR, STEPS = 3, 1e-3, 3
# the JAX suite's bound for the cp step tracking the single-device step
# (tests/test_ring_attention.py::test_hybrid_cp_train_step_matches_single_device)
LOSS_RTOL = 1e-3
# f32 gradients of the ring step against the single-device step, as a share
# of each tensor's largest entry (sums in another order; the port's train
# tests hold flash against plain attention to the same bound)
GRAD_REL_TOL = 1e-4


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (4, 128)).astype(np.int32)
    return x, np.roll(x, -1, 1)


def _cp_worker(rank, tmp):
    torch.set_num_threads(1)
    mesh = build_mesh(MeshSpec(dp=1, cp=2), rank, 2, os.path.join(tmp, "rendezvous"), "cpu")
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    thybrid.init_hybrid(model, opt, mesh, seed=SEED)
    step = thybrid.make_hybrid_train_step(model, opt, mesh)
    x, y = (torch.from_numpy(t) for t in _batch())
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(step(x, y)))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    eval_loss = float(thybrid.hybrid_eval_loss(model, mesh, "ring2", x, y))
    torch.save({"losses": losses, "grads": grads, "eval_loss": eval_loss,
                "state": {n: t.clone() for n, t in model.state_dict().items()}},
               os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_cp")
    mp.spawn(_cp_worker, args=(str(tmp),), nprocs=2, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def single_run():
    """The port's single-device step (plain attention, Adam) on the same
    batch: losses and first-step gradients."""
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(SEED)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    x, y = (torch.from_numpy(t).long() for t in _batch())
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(train_gpt2.train_step(model, opt, LR, x, y, attn_impl="xla")))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads}


@pytest.fixture(scope="module")
def jax_runs(devices8):
    """Losses of the JAX hybrid step on a cp = 2 mesh and on one device."""
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.hybrid import init_hybrid, make_hybrid_train_step
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    model = GPT2(GPT2Config.tiny())
    x, y = (jnp.asarray(t) for t in _batch())
    out = {}
    for name, spec, devs in (("cp", JaxMeshSpec(dp=1, cp=2), devices8[:2]),
                             ("single", JaxMeshSpec(dp=1), devices8[:1])):
        opt = optax.adam(LR)
        mesh = jax_build_mesh(spec, devs)
        p, o = init_hybrid(model, opt, mesh, seed=SEED)
        step = make_hybrid_train_step(model, opt, mesh)
        out[name] = []
        for _ in range(STEPS):
            p, o, loss = step(p, o, x, y)
            out[name].append(float(loss))
    return out


@pytest.mark.parametrize("oracle", ["cp", "single"])
def test_cp_step_tracks_the_jax_steps(cp_run, jax_runs, oracle):
    """Three updates of the port's cp = 2 step track the JAX cp = 2 step and
    the JAX single-device step (rtol 1e-3, the JAX suite's bound)."""
    for r in cp_run:
        np.testing.assert_allclose(r["losses"], jax_runs[oracle], rtol=LOSS_RTOL)


def test_cp_step_tracks_the_single_device_step(cp_run, single_run):
    for r in cp_run:
        np.testing.assert_allclose(r["losses"], single_run["losses"], rtol=LOSS_RTOL)
    assert cp_run[0]["losses"][-1] < cp_run[0]["losses"][0]


def test_cp_gradients_equal_the_single_device_gradients(cp_run, single_run):
    """The summed ring gradients of the first step are the full-sequence
    gradients: the ring's backward carried every rank's K/V cotangents
    home, and the all-reduce summed the replicated parameters'."""
    for r in cp_run:
        for name, want in single_run["grads"].items():
            err = (r["grads"][name] - want).abs().max().item()
            assert err <= GRAD_REL_TOL * want.abs().max().item() + 1e-12, (name, err)


def test_cp_replicas_stay_identical(cp_run):
    """Identical summed gradients and the same optimizer on every rank: the
    replicated weights agree bit for bit after three updates, and so do the
    losses and the eval loss."""
    a, b = cp_run
    assert a["losses"] == b["losses"] and a["eval_loss"] == b["eval_loss"]
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name


def test_cp_eval_loss_matches_the_single_device_loss(cp_run):
    """``hybrid_eval_loss`` after the updates: the global mean of the two
    shards' losses equals the full-sequence loss of the same weights."""
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    model.load_state_dict(cp_run[0]["state"])
    x, y = (torch.from_numpy(t).long() for t in _batch())
    with torch.no_grad():
        want = float(model.loss(x, y, attn_impl="xla"))
    np.testing.assert_allclose(cp_run[0]["eval_loss"], want, rtol=1e-5)


def test_train_gpt2_cli_cp2_on_cpu():
    """``train_gpt2 --cp 2 --device cpu``: two spawned ranks over gloo,
    rank 0's losses returned and logged; the first loss equals the
    single-device run's (same weights, same batch)."""
    handler = _Lines()
    logger = logging.getLogger("dsml.gpt2")
    logger.addHandler(handler)
    args = ["--device", "cpu", "--model", "tiny", "--steps", "2", "--seq_len", "64",
            "--batch_size", "4", "--log_every", "1", "--warmup_steps", "1"]
    try:
        cp = train_gpt2.main(args + ["--cp", "2"])
        single = train_gpt2.main(args)
    finally:
        logger.removeHandler(handler)
    assert set(cp) == {"first_loss", "last_loss"} and np.isfinite(cp["last_loss"])
    np.testing.assert_allclose(cp["first_loss"], single["first_loss"], rtol=1e-5)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_default_attn_impl_matches_jax(devices8):
    from dsml_tpu.parallel.hybrid import default_attn_impl as jax_default
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    for cp in (1, 2):
        spec = MeshSpec(dp=1, cp=cp)
        mesh = Mesh(spec, 0, torch.device("cpu"), {})
        want = jax_default(jax_build_mesh(JaxMeshSpec(dp=1, cp=cp), devices8[:cp]))
        assert thybrid.default_attn_impl(mesh) == want


@pytest.mark.parametrize("spec,world,axis", [
    (MeshSpec(dp=2, cp=2), 4, "dp"), (MeshSpec(tp=2, cp=2), 4, "tp"),
    (MeshSpec(pp=2, cp=2), 4, "pp"), (MeshSpec(fsdp=2, cp=2), 4, "fsdp"), (MeshSpec(sp=2), 2, "sp"),
])
def test_build_mesh_raises_for_unported_axes(spec, world, axis, devices8):
    """sp, and cp composed with pp, dp, fsdp or tp, are ported (they raised
    until the long-context slice; the spawned meshes of
    ``tests/test_torch_hybrid_sp.py`` train on them): rank r takes the
    coordinates of ``jax.devices()[r]`` in the JAX mesh of the same spec,
    and each axis group holds the ranks of that axis' device rows, in ring
    order. No process group is joined."""
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    from dsml_tpu_torch.parallel.mesh import AXES, axis_group_ranks, rank_coords

    jmesh = jax_build_mesh(JaxMeshSpec(**spec.sizes_dict()), devices8[:world])
    ids = np.vectorize(lambda d: devices8.index(d))(jmesh.devices)
    resolved = spec.resolved(world)
    for rank in range(world):
        at = np.argwhere(ids == rank)[0]
        assert rank_coords(resolved, rank) == dict(zip(AXES, map(int, at)))
    for a in (a for a in AXES if getattr(resolved, a) > 1):
        rows = np.moveaxis(ids, AXES.index(a), -1).reshape(-1, getattr(resolved, a))
        assert axis_group_ranks(resolved, a) == sorted(row.tolist() for row in rows), a
    assert getattr(resolved, axis) == 2 and not dist.is_initialized()


def test_mesh_spec_matches_jax():
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    for kw, n in (({"cp": 2}, 2), ({"cp": 4, "dp": 0}, 8), ({"tp": 2, "pp": 2}, 8)):
        assert MeshSpec(**kw).resolved(n).sizes_dict() == JaxMeshSpec(**kw).resolved(n).sizes_dict()
    with pytest.raises(ValueError, match="ONE sequence"):
        MeshSpec(sp=2, cp=2).seq_axis()
    with pytest.raises(ValueError, match="needs"):
        MeshSpec(dp=2, cp=2).resolved(2)


def test_hybrid_step_raises_for_unported_options():
    mesh = Mesh(MeshSpec(dp=1, cp=1).resolved(1), 0, torch.device("cpu"), {})
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    opt = torch.optim.Adam(model.parameters())
    # the pipeline schedules are ported: 1f1b without a pipeline raises as in
    # the JAX package, and microbatches without one are ignored, as there
    with pytest.raises(ValueError, match="pp > 1"):
        thybrid.make_hybrid_train_step(model, opt, mesh, schedule="1f1b")
    assert callable(thybrid.make_hybrid_train_step(model, opt, mesh, n_microbatches=2))
    # a quantized dp_sync is ported (item 10): it builds on a dp-only mesh
    assert callable(thybrid.make_hybrid_train_step(model, opt, mesh, dp_sync="q8"))


def test_gpt2_ring2_without_a_ring_is_flash():
    """``attn_impl="ring2"`` with no sequence group (or a group of one) is
    single-device flash, as the JAX ``_route_attention``; so are
    ``"ring_flash"`` and ``"ulysses_flash"``, while the XLA ring and
    Ulysses are plain attention (they raised before the long-context
    slice). An unknown impl raises."""
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(0)
    tokens = torch.from_numpy(_batch()[0][:2, :96]).long()

    class One:
        size, rank = 1, 0

    with torch.no_grad():
        flash = model.apply(tokens, attn_impl="flash")
        plain = model.apply(tokens, attn_impl="xla")
        assert torch.equal(model.apply(tokens, attn_impl="ring2"), flash)
        for impl, want in (("ring_flash", flash), ("ulysses_flash", flash), ("ring", plain),
                           ("ulysses", plain)):
            for group in (None, One()):
                assert torch.equal(model.apply(tokens, attn_impl=impl, sp_group=group), want), impl
    with pytest.raises(ValueError, match="unknown attn_impl"):
        model.apply(tokens, attn_impl="bogus")
