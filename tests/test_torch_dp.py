"""The port's data-parallel slice (``parallel.bucketing``, ``parallel.dp``,
the dp hybrid step, the dp ``Trainer`` and ``train_gpt2 --dp``) against the
JAX package's, on the CPU.

Module-scoped fixtures spawn a dp = 2 ring (the dp step on GPT-2-tiny and
the hybrid step with ``dp_sync`` "xla" and "ring") and a dp = 4 ring
(``bucketed_all_reduce`` and the ``Trainer``), each running every case
once over gloo and saving each rank's results; the tests hold them
against the JAX functions on ``devices8[:n]`` with the JAX suite's own
bounds, and the replicas against each other."""

import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.cli import train_gpt2
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.ops.collectives import ReduceOp
from dsml_tpu_torch.parallel import bucketing as B
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.dp import make_dp_train_step
from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, axis_group_ranks, build_mesh, data_mesh
from dsml_tpu_torch.parallel.peer import RingGroup
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata

SEED, LR, STEPS = 3, 1e-3, 3
# tests/test_bucketing.py::test_dp_step_bucketed_matches_xla
DP_STEP_RTOL = 1e-4
# tests/test_bucketing.py::test_hybrid_grad_accum_explicit_sync_matches_xla
HYBRID_LR, HYBRID_RTOL = 1e-2, 2e-4
# tests/test_trainer.py::test_ring_and_xla_gradient_sync_agree
TRAINER_LOSS_RTOL, TRAINER_PARAM_TOL = 1e-4, dict(rtol=1e-3, atol=1e-5)
TRAINER_CFG = dict(epochs=1, batch_size=32, lr=0.05, seed=7)
BUCKET_MB = 1e-3  # ~1 KiB: a bucket per leaf or two


def _gpt2_batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (4, 128)).astype(np.int32)
    return x, np.roll(x, -1, 1)


def _hybrid_batch():
    """The JAX suite's hybrid setting: 16 rows of max_seq tokens."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (16, 128)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _float_stack(n, seed=0):
    """Per-rank trees, the JAX suite's ``_float_stack`` plus a bf16 leaf (a
    bucket of its own dtype)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((n, 41, 7)).astype(np.float32),
        "b": rng.standard_normal((n, 9)).astype(np.float32),
        "s": rng.standard_normal((n,)).astype(np.float32),  # 0-d per rank
        "big": rng.standard_normal((n, 5000)).astype(np.float32),
        "half": rng.standard_normal((n, 64)).astype(np.float32),
    }


def _rank_tree(stack, rank):
    tree = {k: torch.from_numpy(np.array(v[rank])) for k, v in stack.items()}
    tree["half"] = tree["half"].to(torch.bfloat16)
    return tree


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---- rank workers (spawned; module level so the children import them) --------


def _dp2_worker(rank, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"), "cpu")
    res = {}
    x, y = (torch.from_numpy(t) for t in _gpt2_batch())
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(SEED)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_dp_train_step(model, opt, mesh, algorithm="ring", bucket_size_mb=BUCKET_MB)
    res["dp_losses"] = [float(step(x.long(), y.long())) for _ in range(STEPS)]
    res["dp_state"] = {k: t.clone() for k, t in model.state_dict().items()}
    hx, hy = (torch.from_numpy(t) for t in _hybrid_batch())
    for sync in ("xla", "ring"):
        model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(0)
        opt = torch.optim.Adam(model.parameters(), lr=HYBRID_LR)
        step = thybrid.make_hybrid_train_step(model, opt, mesh, attn_impl="ring", grad_accum=2,
                                              dp_sync=sync, bucket_size_mb=BUCKET_MB)
        res[f"hybrid_{sync}"] = [float(step(hx, hy)) for _ in range(STEPS)]
        res[f"hybrid_{sync}_state"] = {k: t.clone() for k, t in model.state_dict().items()}
    res["eval_loss"] = float(thybrid.hybrid_eval_loss(model, mesh, "ring", hx, hy))
    with torch.no_grad():
        res["full_loss"] = float(model.loss(hx.long(), hy.long()))
    try:  # per-rank rows (8) not divisible by grad_accum: raises on every rank
        thybrid.make_hybrid_train_step(model, opt, mesh, grad_accum=3)(hx, hy)
    except ValueError as e:
        res["accum_error"] = str(e)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _dp4_worker(rank, tmp, mlp_params):
    torch.set_num_threads(1)
    mesh = data_mesh(4, rank, os.path.join(tmp, "rendezvous"), "cpu")
    group = mesh.group("dp")
    res = {}
    tree = _rank_tree(_float_stack(4), rank)
    for mb in (BUCKET_MB, None):
        res[f"bucketed_{mb}"] = B.bucketed_all_reduce(tree, group, ReduceOp.AVG, "ring", mb)
    data = tdata.synthetic_classification(1024, features=16, classes=4, seed=1)
    trainer = Trainer(MLP((16, 32, 4), device="cpu"),
                      TrainConfig(algorithm="ring", **TRAINER_CFG), mesh=mesh)
    state, history, acc = trainer.train(data, mlp_params)
    res["trainer"] = {"state": state, "history": history, "acc": acc}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _spawn(fn, n, tmp, *args):
    mp.spawn(fn, args=(str(tmp), *args), nprocs=n, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def dp2_run(tmp_path_factory):
    return _spawn(_dp2_worker, 2, tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def jax_mlp():
    """The JAX MLP and its init(7) (the JAX trainer inits from cfg.seed)."""
    import jax

    from dsml_tpu.models.mlp import MLP as JaxMLP

    model = JaxMLP(sizes=(16, 32, 4))
    return model, jax.tree.map(np.asarray, model.init(TRAINER_CFG["seed"]))


@pytest.fixture(scope="module")
def dp4_run(tmp_path_factory, jax_mlp):
    return _spawn(_dp4_worker, 4, tmp_path_factory.mktemp("dp4"), params_from_jax(jax_mlp[1]))


def _jax_mesh(devices, n):
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    return jax_build_mesh(JaxMeshSpec(dp=n), devices[:n])


# ---- plan, flatten, unflatten ------------------------------------------------------


def _jax_path(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)


@pytest.mark.parametrize("bucket_mb", [1e-5, 1e-3, 4.0])
def test_plan_equals_jax_plan_on_gpt2_tiny(bucket_mb):
    """The port plans over ``model.named_parameters()`` in the JAX tree's
    leaf order, so its buckets are the JAX plan's, index for index."""
    import jax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel import bucketing as JB

    jparams = GPT2(GPT2Config.tiny()).init(0)
    jplan = JB.plan_buckets(jparams, bucket_mb)
    paths = [_jax_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    plan = B.plan_buckets(dict(model.named_parameters()), bucket_mb)
    assert list(plan.names) == paths
    assert plan.buckets == jplan.buckets
    assert [plan.bucket_nbytes(b) for b in range(plan.n_buckets)] == \
        [jplan.bucket_nbytes(b) for b in range(jplan.n_buckets)]


def _mixed_tree(seed=0):
    """0-d leaves, mixed dtypes, sizes that straddle any small target (the
    JAX suite's ``_tree``), as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "scalar": np.float32(rng.random()),
        "w": rng.random((37, 11)).astype(np.float32),
        "b": rng.random((11,)).astype(np.float32),
        "emb": rng.random((256, 16)).astype(np.float32),
        "step": np.int32(3),
        "counts": rng.integers(0, 9, (13,)).astype(np.int32),
        "half": rng.random((64,)).astype(np.float32),
    }


@pytest.mark.parametrize("bucket_mb", [1e-5, 1e-3, 4.0])
def test_flatten_unflatten_round_trip_equals_jax(bucket_mb):
    """Buckets are single-dtype, cover every leaf once, equal the JAX
    package's flat buckets value for value, and unflatten exactly."""
    import jax.numpy as jnp

    from dsml_tpu.parallel import bucketing as JB

    raw = _mixed_tree()
    tree = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in raw.items()}
    tree["half"] = tree["half"].to(torch.bfloat16)
    jtree = {k: jnp.asarray(v) for k, v in raw.items()}
    jtree["half"] = jtree["half"].astype(jnp.bfloat16)
    plan, jplan = B.plan_buckets(tree, bucket_mb), JB.plan_buckets(jtree, bucket_mb)
    assert plan.buckets == jplan.buckets
    buckets = B.flatten_buckets(tree, plan)
    for got, want in zip(buckets, JB.flatten_buckets(jtree, jplan)):
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert sum(b.numel() for b in buckets) == sum(t.numel() for t in tree.values())
    back = B.unflatten_buckets(buckets, plan)
    assert sorted(back) == sorted(tree)
    for k, t in tree.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape and torch.equal(back[k], t), k
    # a sequence of tensors plans in its own order and unflattens to a list
    seq_plan = B.plan_buckets(list(tree.values()), bucket_mb)
    assert seq_plan.names is None
    assert all(torch.equal(a, b) for a, b in zip(
        B.unflatten_buckets(B.flatten_buckets(list(tree.values()), seq_plan), seq_plan),
        tree.values()))


def test_tree_order_is_the_jax_leaf_order():
    names = ["wte", "layers.10.mlp.w_in", "layers.2.attn.bo", "ln_f.scale", "layers.2.ln_1.bias",
             "wpe", "ln_f.bias"]
    assert B.tree_order(names) == ["layers.2.attn.bo", "layers.2.ln_1.bias",
                                   "layers.10.mlp.w_in", "ln_f.bias", "ln_f.scale", "wpe", "wte"]


def test_default_bucket_mb_reads_the_environment(monkeypatch):
    from dsml_tpu.parallel import bucketing as JB

    for value in (None, "8", "0.5", "0", "-3", "junk"):
        if value is None:
            monkeypatch.delenv("DSML_BUCKET_MB", raising=False)
        else:
            monkeypatch.setenv("DSML_BUCKET_MB", value)
        assert B.default_bucket_mb() == JB.default_bucket_mb(), value
    for alg in ("ring", "q8", "q8_ring", "q4_ring2", "quant", "xla"):
        assert B.is_quantized_algorithm(alg) == JB.is_quantized_algorithm(alg)
        assert B.supports_error_feedback(alg) == JB.supports_error_feedback(alg)


# ---- bucketed sync at n = 4 -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bucketed(devices8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.parallel import bucketing as JB

    mesh = JaxMesh(np.asarray(devices8[:4]), ("dev",))
    stack = {k: jnp.asarray(v) for k, v in _float_stack(4).items()}
    stack["half"] = stack["half"].astype(jnp.bfloat16)

    def fn(stacked):
        tree = jax.tree.map(lambda l: l[0], stacked)
        out = {str(mb): JB.bucketed_all_reduce(tree, "dev", ReduceOp.AVG, "ring", mb)
               for mb in (BUCKET_MB, None)}
        return jax.tree.map(lambda l: l[None], out)

    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("dev"), out_specs=P("dev"),
                                check_vma=False))(stack)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("bucket_mb", [BUCKET_MB, None])
def test_bucketed_ring_bit_identical_to_jax_at_n4(dp4_run, jax_bucketed, bucket_mb):
    """``bucketed_all_reduce(ring, AVG)`` at n = 4 equals the JAX package's
    bit for bit on every rank, bucketed (the bucket boundaries set the
    summation order) and as one flat buffer."""
    for r, res in enumerate(dp4_run):
        got = res[f"bucketed_{bucket_mb}"]
        for k, t in got.items():
            want = jax_bucketed[str(bucket_mb)][k][r]
            want = want.view(np.int16) if want.dtype.name == "bfloat16" else want
            np.testing.assert_array_equal(_bits(t), want, err_msg=k)


def test_bucketed_matches_single_buffer(dp4_run):
    """The JAX suite's bound (rtol 2e-5, atol 1e-6) between the bucketed
    and the single-buffer sync, and against the numpy mean."""
    stack = _float_stack(4)
    for res in dp4_run:
        for k, t in res[f"bucketed_{BUCKET_MB}"].items():
            single = res["bucketed_None"][k]
            if k == "half":
                # bf16 leaf: both within a bf16 ulp of the f32 mean of the bf16 inputs
                want = torch.from_numpy(stack[k]).to(torch.bfloat16).float().mean(0).numpy()
                np.testing.assert_allclose(t.float().numpy(), want, rtol=1e-2, atol=1e-2)
                continue
            np.testing.assert_allclose(t.numpy(), stack[k].mean(0), rtol=2e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(t.numpy(), single.numpy(), rtol=2e-5, atol=1e-6, err_msg=k)


# ---- the dp step and the hybrid dp step (dp = 2) ------------------------------------------


@pytest.fixture(scope="module")
def jax_dp_losses(devices8):
    """The JAX ``make_dp_train_step`` (ring, the same buckets, Adam) on a
    dp = 2 mesh: three losses and the final weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.dp import make_dp_train_step as jax_dp_step

    model = GPT2(GPT2Config.tiny())
    opt = optax.adam(LR)
    step = jax_dp_step(model.loss, opt, _jax_mesh(devices8, 2), algorithm="ring",
                       bucket_size_mb=BUCKET_MB)
    params = model.init(SEED)
    state = opt.init(params)
    x, y = (jnp.asarray(t) for t in _gpt2_batch())
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree.map(np.asarray, params))


def test_dp_step_tracks_the_jax_dp_step(dp2_run, jax_dp_losses):
    """Three ring-synced updates of GPT-2-tiny at dp = 2: the losses track
    the JAX dp step's at the JAX suite's bound (rtol 1e-4), and so do the
    weights."""
    want_losses, want_state = jax_dp_losses
    for r in dp2_run:
        np.testing.assert_allclose(r["dp_losses"], want_losses, rtol=DP_STEP_RTOL)
        for k, t in r["dp_state"].items():
            np.testing.assert_allclose(t.numpy(), want_state[k].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=k)
    assert dp2_run[0]["dp_losses"][-1] < dp2_run[0]["dp_losses"][0]


def test_dp_replicas_stay_identical(dp2_run):
    """Identical averaged gradients and the same optimizer on every rank:
    losses and weights agree bit for bit, for the dp step and both hybrid
    syncs."""
    a, b = dp2_run
    for key in ("dp", "hybrid_xla", "hybrid_ring"):
        losses = "dp_losses" if key == "dp" else key
        assert a[losses] == b[losses], key
        for name, t in a[f"{key}_state"].items():
            assert torch.equal(t, b[f"{key}_state"][name]), (key, name)


@pytest.fixture(scope="module")
def jax_hybrid_losses(devices8):
    """The JAX hybrid step with grad_accum 2 and XLA's sync on a dp = 2
    mesh: the reference the JAX suite holds its explicit sync against."""
    import optax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.hybrid import init_hybrid, make_hybrid_train_step

    model = GPT2(GPT2Config.tiny())
    opt = optax.adam(HYBRID_LR)
    mesh = _jax_mesh(devices8, 2)
    step = make_hybrid_train_step(model, opt, mesh, attn_impl="ring", grad_accum=2)
    params, state = init_hybrid(model, opt, mesh, seed=0)
    x, y = _hybrid_batch()
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("sync", ["xla", "ring"])
def test_hybrid_dp_step_tracks_the_jax_step(dp2_run, jax_hybrid_losses, sync):
    """The hybrid step on a dp = 2 mesh with grad_accum 2, the gradients
    synced once per step by ``dp_sync`` (the process group's all_reduce,
    or the bucketed ring), tracks the JAX step at the JAX suite's bound
    (rtol 2e-4)."""
    for r in dp2_run:
        np.testing.assert_allclose(r[f"hybrid_{sync}"], jax_hybrid_losses, rtol=HYBRID_RTOL)


def test_hybrid_dp_eval_and_per_rank_divisibility(dp2_run):
    """``hybrid_eval_loss`` on a dp mesh is the global batch's loss; a
    per-rank batch that grad_accum does not divide raises on every rank."""
    for r in dp2_run:
        np.testing.assert_allclose(r["eval_loss"], r["full_loss"], rtol=1e-5)
        assert "per-rank batch 8 not divisible by grad_accum=3" in r["accum_error"]


# ---- the Trainer at dp = 4 ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trainer_run(jax_mlp):
    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
    from dsml_tpu.trainer import Trainer as JaxTrainer
    from dsml_tpu.utils.data import synthetic_classification

    data = synthetic_classification(1024, features=16, classes=4, seed=1)
    trainer = JaxTrainer(jax_mlp[0], JaxTrainConfig(algorithm="ring", **TRAINER_CFG),
                         mesh=jax_data_mesh(4))
    params, history, acc = trainer.train(data)
    import jax

    return params_from_jax(jax.tree.map(np.asarray, params)), history, acc


def test_trainer_dp4_ring_tracks_the_jax_trainer(dp4_run, jax_trainer_run):
    """The port's ``Trainer`` on four ranks (ring sync) against the JAX
    ``Trainer`` on ``data_mesh(4)``, with ``test_ring_and_xla_gradient_sync_
    agree``'s data and bounds: epoch loss rtol 1e-4, weights rtol 1e-3 /
    atol 1e-5; the ranks agree bit for bit."""
    want_state, want_history, want_acc = jax_trainer_run
    for res in dp4_run:
        got = res["trainer"]
        assert np.isclose(got["history"][0]["avg_loss"], want_history[0]["avg_loss"],
                          rtol=TRAINER_LOSS_RTOL)
        for k, t in got["state"].items():
            np.testing.assert_allclose(t.numpy(), want_state[k].numpy(), **TRAINER_PARAM_TOL,
                                       err_msg=k)
        assert abs(got["acc"] - want_acc) <= 2 / 1024  # a near-tie or two
    first = dp4_run[0]["trainer"]
    for res in dp4_run[1:]:
        assert res["trainer"]["history"][0]["avg_loss"] == first["history"][0]["avg_loss"]
        assert all(torch.equal(t, first["state"][k]) for k, t in res["trainer"]["state"].items())


def test_trainer_ring_on_one_device_is_the_xla_run():
    """Without a mesh every full-precision algorithm syncs over a group of
    one (the identity): ring trains exactly as xla."""
    data = tdata.synthetic_classification(256, features=8, classes=3, seed=2)
    runs = {}
    for alg in ("xla", "ring", "auto"):
        state, history, acc = Trainer(MLP((8, 16, 3), device="cpu").init(0),
                                      TrainConfig(algorithm=alg, epochs=1, batch_size=32,
                                                  lr=0.05)).train(data, None)
        runs[alg] = (state, history[0]["avg_loss"], acc)
    for alg in ("ring", "auto"):
        assert runs[alg][1] == runs["xla"][1] and runs[alg][2] == runs["xla"][2]
        assert all(torch.equal(t, runs["xla"][0][k]) for k, t in runs[alg][0].items())


# ---- the entry point ------------------------------------------------------------------------


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_gpt2_cli_dp2_on_cpu(capfd):
    """``train_gpt2 --dp 2 --device cpu``: two spawned ranks over gloo,
    rank 0's losses returned and logged (the ranks log to the inherited
    stderr); the first loss equals the single-device run's (same weights,
    the two ranks' rows make the same batch)."""
    handler = _Lines()
    logger = logging.getLogger("dsml.gpt2")
    logger.addHandler(handler)
    args = ["--device", "cpu", "--model", "tiny", "--steps", "2", "--seq_len", "64",
            "--batch_size", "4", "--log_every", "1", "--warmup_steps", "1", "--grad_accum", "1"]
    try:
        dp = train_gpt2.main(args + ["--dp", "2"])
        ranks_err = capfd.readouterr().err
        single = train_gpt2.main(args)
    finally:
        logger.removeHandler(handler)
    assert "dp rank 0 of 2 on cpu" in ranks_err and "dp rank 1 of 2 on cpu" in ranks_err
    steps = [line for line in ranks_err.splitlines() if "dsml.gpt2: step " in line]
    assert len(steps) == 2 and steps[-1].endswith("tokens/s"), steps  # rank 0 alone
    assert set(dp) == {"first_loss", "last_loss"} and np.isfinite(dp["last_loss"])
    np.testing.assert_allclose(dp["first_loss"], single["first_loss"], rtol=1e-5)
    np.testing.assert_allclose(dp["last_loss"], single["last_loss"], rtol=1e-4)
    with pytest.raises(SystemExit, match="grad_accum\\*dp"):
        train_gpt2.main(args[:-2] + ["--grad_accum", "4", "--dp", "2"])


# ---- what stays unported ----------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["q8", "q8_ring", "q8_ring2", "q4_ring", "q4_ring2", "quant"])
def test_quantized_algorithms_raise_naming_item_10(algorithm):
    """Item 10 (compressed communication) is ported: no entry point raises
    for a quantized algorithm any more. The dp step and the hybrid step
    build with it, and the bucketed sync over a group of one is the
    identity (``tests/test_torch_quant_sync.py`` holds the syncs against
    the JAX package)."""
    model = MLP((4, 2), device="cpu").init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    assert callable(make_dp_train_step(model, opt, None, algorithm=algorithm))
    x = torch.ones(3)
    for mb in (1.0, None):
        got = B.bucketed_all_reduce([x], RingGroup(None, [0], 0, "cpu"), ReduceOp.AVG, algorithm, mb)
        assert torch.equal(got[0], x)
    mesh = Mesh(MeshSpec(dp=2).resolved(2), 0, torch.device("cpu"), {})
    assert callable(thybrid.make_hybrid_train_step(tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"),
                                                   opt, mesh, dp_sync=algorithm))


def test_error_feedback_dp_cp_and_bad_options_raise(tmp_path):
    data = tdata.synthetic_classification(64, 4, 2)
    model = MLP((4, 2), device="cpu").init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    # error feedback pairs with the quantized ring family only (ValueError,
    # as in the JAX package); with it, it builds
    assert make_dp_train_step(model, opt, None, algorithm="q8_ring", error_feedback=True)
    with pytest.raises(ValueError, match="error_feedback"):
        make_dp_train_step(model, opt, None, algorithm="ring", error_feedback=True)
    with pytest.raises(ValueError, match="error_feedback"):
        B.bucketed_all_reduce([torch.ones(3)], RingGroup(None, [0], 0, "cpu"),
                              error_feedback=[torch.zeros(3)])
    with pytest.raises(ValueError, match="error_feedback"):
        Trainer(model, TrainConfig(epochs=1, batch_size=8, error_feedback=True)).train(data)
    with pytest.raises(ValueError, match="unknown gradient sync algorithm"):
        make_dp_train_step(model, opt, None, algorithm="bogus")
    # dp > 1 without a mesh says how to launch the ranks
    with pytest.raises(ValueError, match="data_mesh"):
        Trainer(model, TrainConfig(epochs=1, batch_size=8, dp=2)).train(data)
    # dp composed with cp is ported (it raised until the long-context slice;
    # tests/test_torch_hybrid_sp.py trains on it): the cp rings are the rank
    # pairs of one dp replica, the dp groups their mirror; train_gpt2 takes
    # the flags. sp with cp stays the JAX ValueError, before any group is joined
    spec = MeshSpec(dp=2, cp=2).resolved(4)
    assert axis_group_ranks(spec, "cp") == [[0, 1], [2, 3]]
    assert axis_group_ranks(spec, "dp") == [[0, 2], [1, 3]]
    train_gpt2._check_supported(train_gpt2.GPT2TrainConfig.parse_args(
        ["--device", "cpu", "--steps", "1", "--dp", "2", "--cp", "2"]))
    with pytest.raises(ValueError, match="ONE sequence"):
        build_mesh(MeshSpec(sp=2, cp=2), 0, 4, str(tmp_path / "rendezvous"), "cpu")
    assert not dist.is_initialized()
    # an explicit dp_sync needs a dp-only mesh, as in the JAX package
    cp_mesh = Mesh(MeshSpec(dp=1, cp=2).resolved(2), 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="dp-only mesh"):
        thybrid.make_hybrid_train_step(tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"),
                                       opt, cp_mesh, dp_sync="ring")


def test_default_attn_impl_on_a_dp_mesh_matches_jax(devices8):
    from dsml_tpu.parallel.hybrid import default_attn_impl as jax_default

    mesh = Mesh(MeshSpec(dp=2).resolved(2), 0, torch.device("cpu"), {})
    assert thybrid.default_attn_impl(mesh) == jax_default(_jax_mesh(devices8, 2)) == "ring"
