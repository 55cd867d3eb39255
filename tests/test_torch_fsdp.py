"""The port's ZeRO (``parallel.fsdp``: the hybrid step's ZeRO-3 fsdp axis and
the explicit bucketed ZeRO-2, full precision and int8/int4 with error
feedback, and its checkpoints) against the JAX package, on the CPU.

Module-scoped fixtures run the JAX side first (the pure-dp hybrid
trajectory, ``make_zero2_train_step`` runs, a ZeRO-2 checkpoint at fsdp =
2), then spawn the port's meshes over gloo: fsdp = 2 (the hybrid ZeRO-3
trajectory, ZeRO-2 on GPT-2-tiny, the ZeRO-2 sync on a tree whose gradients
are exact, and a ZeRO-2 checkpoint), dp = 2 × fsdp = 2 and fsdp = 2 × tp =
2 (ZeRO-3 trajectories), and fsdp = 4 (the JAX checkpoint restored at
another width)."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from dsml_tpu_torch.checkpoint import CheckpointManager
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.parallel import fsdp as tfsdp
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

HYBRID_RTOL = 2e-3  # tests/test_fsdp.py::test_hybrid_fsdp_matches_pure_dp
ZERO2_RTOL = 1e-4  # tests/test_bucketing.py::test_zero2_matches_dp (the ZeRO-2 trajectory)
LR, STEPS, BUCKET_MB = 1e-2, 3, 0.01
ADAMW_LR, ADAMW_WD = 1e-2, 0.01
QUANTS = [None, "int8", "int4"]
# exact-gradient tree for the sync check: loss = Σ leaf · x[0]
SYNC_SHAPES = {"a": (37, 11), "b": (5000,), "c": (64,)}
SYNC_MB = 4e-3  # ~4 KiB: "a" and "c" share a bucket, "b" has its own


def _batch(step=0, batch=8):
    rng = np.random.default_rng(100 + step)
    x = rng.integers(0, 512, (batch, 128)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _sync_batch(step, n=2):
    rng = np.random.default_rng(200 + step)
    total = sum(int(np.prod(s)) for s in SYNC_SHAPES.values())
    return rng.standard_normal((n, total)).astype(np.float32), np.zeros((n, 1), np.float32)


def _jax_sync_loss(params, x, y):
    import jax.numpy as jnp

    off, total = 0, 0.0
    for k in sorted(SYNC_SHAPES):
        n = int(np.prod(SYNC_SHAPES[k]))
        total = total + jnp.sum(params[k].reshape(-1) * x[0, off:off + n])
        off += n
    return total


@pytest.fixture(scope="module")
def jax_side(devices8, tmp_path_factory):
    import jax
    import optax

    from dsml_tpu.checkpoint import CheckpointManager as JaxManager
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.bucketing import init_error_feedback
    from dsml_tpu.parallel.fsdp import init_zero2, make_zero2_train_step
    from dsml_tpu.parallel.hybrid import init_hybrid, make_hybrid_train_step
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    model = GPT2(GPT2Config.tiny())
    out = {"params": jax.tree.map(np.asarray, model.init(0))}
    # the pure-dp hybrid trajectory (the JAX fsdp tests' reference)
    mesh = jax_build_mesh(JaxMeshSpec(dp=8), devices8)
    step = make_hybrid_train_step(model, optax.adam(LR), mesh, attn_impl="ring")
    params, ostate = init_hybrid(model, optax.adam(LR), mesh, seed=0)
    out["dp"] = []
    for i in range(STEPS):
        params, ostate, loss = step(params, ostate, *_batch(i))
        out["dp"].append(float(loss))
    # ZeRO-2 at fsdp = 2: the Adam trajectory
    mesh2 = jax_build_mesh(JaxMeshSpec(dp=1, fsdp=2), devices8[:2])
    step = make_zero2_train_step(model.loss, optax.adam(LR), mesh2, bucket_size_mb=BUCKET_MB,
                                 donate=False)
    params, ostate = init_zero2(model, optax.adam(LR), mesh2, bucket_size_mb=BUCKET_MB)
    out["zero2"] = []
    for i in range(STEPS):
        params, ostate, loss = step(params, ostate, *_batch(i))
        out["zero2"].append(float(loss))
    # the ZeRO-2 sync on exact gradients: SGD(1) from zeros, two steps, at
    # fsdp = 2 and 4 (four rows summed in rank order, as psum_scatter sums)
    sync = {k: np.zeros(s, np.float32) for k, s in SYNC_SHAPES.items()}
    mesh4 = jax_build_mesh(JaxMeshSpec(dp=1, fsdp=4), devices8[:4])
    for n, mesh_n, key in ((2, mesh2, "sync"), (4, mesh4, "sync4")):
        for quant in QUANTS:
            opt = optax.sgd(1.0)
            p = jax.device_put(sync)
            o = opt.init(p)
            ef = init_error_feedback(p, mesh_n, "fsdp") if quant else None
            zstep = make_zero2_train_step(_jax_sync_loss, opt, mesh_n, bucket_size_mb=SYNC_MB,
                                          donate=False, quant=quant, error_feedback=bool(quant))
            for i in range(2):
                if quant:
                    p, o, ef, _ = zstep(p, o, ef, *_sync_batch(i, n))
                else:
                    p, o, _ = zstep(p, o, *_sync_batch(i, n))
            out[f"{key}_{quant}"] = {"params": jax.tree.map(np.asarray, p),
                                     "ef": None if ef is None else jax.tree.map(np.asarray, ef)}
    # a ZeRO-2 AdamW checkpoint at fsdp = 2, and the next step's loss
    opt = optax.adamw(optax.constant_schedule(ADAMW_LR), weight_decay=ADAMW_WD)
    zstep = make_zero2_train_step(model.loss, opt, mesh2, bucket_size_mb=BUCKET_MB, donate=False)
    params, ostate = init_zero2(model, opt, mesh2, bucket_size_mb=BUCKET_MB)
    for i in range(2):
        params, ostate, _ = zstep(params, ostate, *_batch(i))
    ckpt = str(tmp_path_factory.mktemp("jax_zero2"))
    with JaxManager(ckpt) as m:
        m.save(2, {"params": params, "opt_state": ostate})
    out["ckpt"] = ckpt
    out["ckpt_next"] = float(zstep(params, ostate, *_batch(2))[2])
    return out


class _SyncTree(nn.Module):
    """The exact-gradient tree as a module (parameters in tree order)."""

    def __init__(self):
        super().__init__()
        for k, s in SYNC_SHAPES.items():
            setattr(self, k, nn.Parameter(torch.zeros(s)))
        self.device = torch.device("cpu")

    def sync_loss(self, x, y):
        off, total = 0, 0.0
        for k in sorted(SYNC_SHAPES):
            p = getattr(self, k)
            total = total + (p.reshape(-1) * x[0, off:off + p.numel()]).sum()
            off += p.numel()
        return total


def _tiny():
    return tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")


def _hybrid_losses(mesh, cfg=None):
    model = thybrid.hybrid_model(tgpt2.GPT2, cfg or tgpt2.GPT2Config.tiny(), mesh)
    model, opt = thybrid.init_hybrid(model, torch.optim.Adam(model.parameters(), lr=LR), mesh, 0)
    step = thybrid.make_hybrid_train_step(model, opt, mesh, attn_impl="ring")
    losses = [float(step(*_batch(i))) for i in range(STEPS)]
    shard = model.fsdp.shard_of["layers.0.attn.wqkv"]
    return {"losses": losses, "wqkv_shard": tuple(shard.shape),
            "opt_bytes": sum(t.numel() * t.element_size() for st in opt.state.values()
                             for t in st.values() if t.ndim)}


def _obs_series(pkg) -> dict:
    """{(name, labels): value, or a histogram's buckets} of the
    ``collective_`` metrics."""
    return {(rec["name"], tuple(sorted(rec["labels"].items()))): rec.get("value", rec.get("buckets"))
            for rec in pkg.get_registry().collect() if rec["name"].startswith("collective_")}


def _zero2_obs_series(mesh):
    """Two ZeRO-2 int8 + EF steps on the sync tree with the port's obs on:
    its ``collective_`` metrics."""
    from dsml_tpu_torch import obs as tobs

    tobs.enable(forensics=False)
    tobs.get_registry().reset()
    tree = _SyncTree()
    state = tfsdp.init_zero2(tree, torch.optim.SGD(tree.parameters(), lr=1.0), mesh, None,
                             bucket_size_mb=SYNC_MB)
    step = tfsdp.make_zero2_train_step(tree, state, mesh, bucket_size_mb=SYNC_MB, quant="int8",
                                       error_feedback=True, loss_fn=tree.sync_loss)
    for i in range(2):
        step(*(torch.from_numpy(t) for t in _sync_batch(i)))
    out = _obs_series(tobs)
    tobs.disable()
    return out


def _sync_runs(mesh, n):
    """The ZeRO-2 sync on the exact-gradient tree at fsdp = ``n``: SGD(1)
    from zeros, two steps, full precision and int8/int4 + error feedback."""
    res = {}
    for quant in QUANTS:
        tree = _SyncTree()
        state = tfsdp.init_zero2(tree, torch.optim.SGD(tree.parameters(), lr=1.0), mesh,
                                 None, bucket_size_mb=SYNC_MB)
        step = tfsdp.make_zero2_train_step(tree, state, mesh, bucket_size_mb=SYNC_MB,
                                           quant=quant, error_feedback=bool(quant),
                                           loss_fn=tree.sync_loss)
        for i in range(2):
            step(*(torch.from_numpy(t) for t in _sync_batch(i, n)))
        res[f"sync_{quant}"] = {"params": {k: p.detach().clone()
                                           for k, p in tree.named_parameters()},
                                "ef": state.ef}
    return res


def _fsdp_worker(rank, tmp, spec, payload):
    torch.set_num_threads(1)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), rank, n, os.path.join(tmp, "rendezvous"), "cpu")
    res = {"hybrid": _hybrid_losses(mesh)} if spec != {"fsdp": 4} else {}
    if spec == {"fsdp": 2}:
        model = _tiny()
        zero3, opt = tfsdp.init_fsdp(model, torch.optim.Adam(model.parameters(), lr=LR), mesh, 0)
        step = tfsdp.make_fsdp_train_step(model, zero3, opt, mesh, attn_impl="xla")
        res["fsdp_step"] = [float(step(*_batch(i))) for i in range(STEPS)]
        model = _tiny()
        state = tfsdp.init_zero2(model, torch.optim.Adam(model.parameters(), lr=LR), mesh, 0,
                                 bucket_size_mb=BUCKET_MB)
        step = tfsdp.make_zero2_train_step(model, state, mesh, bucket_size_mb=BUCKET_MB)
        res["zero2"] = [float(step(*_batch(i))) for i in range(STEPS)]
        res["zero2_opt_bytes"] = sum(t.numel() * t.element_size()
                                     for st in state.optimizer.state.values()
                                     for t in st.values() if t.ndim)
        res.update(_sync_runs(mesh, 2))
        # a port ZeRO-2 AdamW checkpoint at fsdp = 2, and the next step
        model = _tiny()
        opt = torch.optim.AdamW(model.parameters(), lr=ADAMW_LR, weight_decay=ADAMW_WD)
        state = tfsdp.init_zero2(model, opt, mesh, 0, bucket_size_mb=BUCKET_MB)
        step = tfsdp.make_zero2_train_step(model, state, mesh, bucket_size_mb=BUCKET_MB)
        for i in range(2):
            step(*_batch(i))
        with CheckpointManager(os.path.join(tmp, "port_ckpt"), mesh=mesh) as m:
            m.save(2, tfsdp.zero2_abstract_state(model, state, "adamw", 2))
        res["ckpt_next"] = float(step(*_batch(2)))
        res["obs"] = _zero2_obs_series(mesh)
    if spec == {"fsdp": 4}:  # the JAX fsdp = 2 checkpoint restored at width 4
        model = _tiny()
        opt = torch.optim.AdamW(model.parameters(), lr=ADAMW_LR, weight_decay=ADAMW_WD)
        state = tfsdp.init_zero2(model, opt, mesh, 0, bucket_size_mb=BUCKET_MB)
        with CheckpointManager(payload, mesh=mesh) as m:
            res["restored_count"] = tfsdp.restore_zero2(m, model, state)
        step = tfsdp.make_zero2_train_step(model, state, mesh, bucket_size_mb=BUCKET_MB)
        res["restored_next"] = float(step(*_batch(2)))
        res.update(_sync_runs(mesh, 4))
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _spawn(spec, tmp, payload=None):
    n = int(np.prod(list(spec.values())))
    mp.spawn(_fsdp_worker, args=(str(tmp), spec, payload), nprocs=n, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def fsdp2_run(tmp_path_factory, jax_side):
    tmp = tmp_path_factory.mktemp("fsdp2")
    return tmp, _spawn({"fsdp": 2}, tmp)


@pytest.fixture(scope="module")
def fsdp4_run(tmp_path_factory, jax_side):
    """fsdp = 4: the JAX fsdp = 2 checkpoint restored at width 4, and the
    ZeRO-2 sync runs."""
    return _spawn({"fsdp": 4}, tmp_path_factory.mktemp("fsdp4"), jax_side["ckpt"])


MESHES = {"fsdp2": {"fsdp": 2}, "dp2_fsdp2": {"dp": 2, "fsdp": 2},
          "fsdp2_tp2": {"fsdp": 2, "tp": 2}}


@pytest.fixture(scope="module", params=list(MESHES))
def hybrid_run(request, tmp_path_factory, fsdp2_run):
    if request.param == "fsdp2":
        return MESHES["fsdp2"], fsdp2_run[1]
    return MESHES[request.param], _spawn(MESHES[request.param],
                                         tmp_path_factory.mktemp(request.param))


def test_hybrid_fsdp_matches_jax_pure_dp(hybrid_run, jax_side):
    """The hybrid step on fsdp = 2, dp = 2 × fsdp = 2 and fsdp = 2 × tp = 2
    follows the JAX pure-dp trajectory, with every leaf held as a shard."""
    spec, ranks = hybrid_run
    for r in ranks:
        np.testing.assert_allclose(r["hybrid"]["losses"], jax_side["dp"], rtol=HYBRID_RTOL)
        # wqkv [d, 3, d/tp]: fsdp takes its first free dim, d
        assert r["hybrid"]["wqkv_shard"] == (64 // spec["fsdp"], 3, 64 // spec.get("tp", 1))


def test_fsdp_step_matches_jax_pure_dp(fsdp2_run, jax_side):
    """The annotation-driven ZeRO-3 step (``make_fsdp_train_step``: every
    leaf on its first divisible dim) follows the JAX pure-dp trajectory."""
    _, ranks = fsdp2_run
    for r in ranks:
        np.testing.assert_allclose(r["fsdp_step"], jax_side["dp"], rtol=HYBRID_RTOL)


def test_zero2_matches_jax(fsdp2_run, jax_side):
    """ZeRO-2 at full precision: the Adam trajectory of the JAX
    ``make_zero2_train_step``, and the optimizer state 1/2 of a replica's."""
    _, ranks = fsdp2_run
    full = sum(p.numel() for p in _tiny().parameters()) * 4 * 2  # mu + nu, f32
    for r in ranks:
        np.testing.assert_allclose(r["zero2"], jax_side["zero2"], rtol=ZERO2_RTOL)
        assert abs(r["zero2_opt_bytes"] - full / 2) <= 2 * 4 * 2 * 8  # padding only


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8_ef", "int4_ef"])
def test_zero2_sync_bit_for_bit(fsdp2_run, jax_side, quant):
    """The ZeRO-2 sync on gradients both packages compute exactly (loss =
    Σ leaf · x): two SGD(1) steps from zeros leave the same parameter bits,
    and under int8/int4 + error feedback the same residual bits — the
    reduce-scatter (quantized or not), the residual and the update are the
    JAX package's, bit for bit."""
    _assert_sync_bits(fsdp2_run[1], jax_side[f"sync_{quant}"], quant)


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8_ef", "int4_ef"])
def test_zero2_sync_bit_for_bit_at_fsdp4(fsdp4_run, jax_side, quant):
    """The same sync at fsdp = 4: each bucket's four gradient rows summed in
    rank order, as the JAX ``psum_scatter`` sums them (ROADMAP queue 3,
    fault 4: the ring's order left 34–46% of the parameters different),
    and 1/4 exact, so the mean's multiply and the update agree however XLA
    fuses them."""
    _assert_sync_bits(fsdp4_run, jax_side[f"sync4_{quant}"], quant)


def _assert_sync_bits(ranks, want, quant):
    for rank, r in enumerate(ranks):
        got = r[f"sync_{quant}"]
        for k in SYNC_SHAPES:
            np.testing.assert_array_equal(got["params"][k].numpy(), want["params"][k])
        if quant:
            for i, k in enumerate(sorted(SYNC_SHAPES)):
                np.testing.assert_array_equal(got["ef"][i].numpy(), want["ef"][k][rank])


def test_zero2_obs_matches_jax(fsdp2_run, devices8):
    """The ZeRO-2 step's metrics as the JAX step writes them: one
    ``"zero2_int8"`` bucket plan (recorded once, at the first batch
    signature where jit traces) and the quantized wire bytes after every
    step, the same series and values."""
    import jax
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from dsml_tpu import obs as jobs
    from dsml_tpu.parallel.bucketing import init_error_feedback
    from dsml_tpu.parallel.fsdp import make_zero2_train_step
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    mesh2 = jax_build_mesh(JaxMeshSpec(dp=1, fsdp=2), devices8[:2])
    jobs.enable(forensics=False)
    try:
        jobs.get_registry().reset()
        opt = optax.sgd(1.0)
        # placed as the step's outputs are, so jit traces once (it keys on placement)
        p = jax.device_put({k: np.zeros(s, np.float32) for k, s in SYNC_SHAPES.items()},
                           NamedSharding(mesh2, P()))
        o, ef = opt.init(p), init_error_feedback(p, mesh2, "fsdp")
        zstep = make_zero2_train_step(_jax_sync_loss, opt, mesh2, bucket_size_mb=SYNC_MB,
                                      donate=False, quant="int8", error_feedback=True)
        for i in range(2):
            p, o, ef, _ = zstep(p, o, ef, *_sync_batch(i))
        want = _obs_series(jobs)
    finally:
        jobs.disable()
        jobs.get_registry().reset()
    labels = (("algorithm", "zero2_int8"), ("axis", "fsdp"))
    assert want[("collective_sync_compiles_total", labels)] == 1
    assert any(k[0] == "collective_quant_bytes_total" for k in want)
    for r in fsdp2_run[1]:
        assert r["obs"] == want


def test_zero2_checkpoint_crosses_packages_and_widths(fsdp2_run, fsdp4_run, jax_side,
                                                      devices8):
    """A JAX ZeRO-2 checkpoint at fsdp = 2 restores in the port at fsdp = 4,
    and the port's at fsdp = 2 in the JAX package at fsdp = 4; the next
    step's loss equals the saving run's."""
    import optax

    from dsml_tpu.checkpoint import CheckpointManager as JaxManager
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.fsdp import make_zero2_train_step, restore_zero2
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    for r in fsdp4_run:
        assert r["restored_count"] == 2
        np.testing.assert_allclose(r["restored_next"], jax_side["ckpt_next"], rtol=ZERO2_RTOL)
    tmp, port = fsdp2_run
    model = GPT2(GPT2Config.tiny())
    opt = optax.adamw(optax.constant_schedule(ADAMW_LR), weight_decay=ADAMW_WD)
    mesh4 = jax_build_mesh(JaxMeshSpec(dp=1, fsdp=4), devices8[:4])
    with JaxManager(str(tmp / "port_ckpt")) as m:
        params, ostate = restore_zero2(m, model, opt, mesh4, bucket_size_mb=BUCKET_MB)
    step = make_zero2_train_step(model.loss, opt, mesh4, bucket_size_mb=BUCKET_MB, donate=False)
    np.testing.assert_allclose(float(step(params, ostate, *_batch(2))[2]), port[0]["ckpt_next"],
                               rtol=ZERO2_RTOL)


def test_zero2_guards_and_flat_shards():
    """The JAX step's argument errors, and the flat bucket shards
    ``zero2_shards_from_jax`` cuts (the JAX ``_local_shards`` padding)."""
    from dsml_tpu_torch.models.convert import zero2_shards_from_jax

    with pytest.raises(ValueError, match="requires quant"):
        tfsdp.make_zero2_train_step(None, None, None, error_feedback=True)
    with pytest.raises(ValueError, match="unknown zero2 quant mode"):
        tfsdp.make_zero2_train_step(None, None, None, quant="int2")
    flat = np.arange(7, dtype=np.float32)
    shards = [zero2_shards_from_jax([flat], 4, r)[0] for r in range(4)]
    assert [s.tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 0]]
