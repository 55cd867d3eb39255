"""The port's training path against the JAX package's, on the CPU in f32:
GPT-2 loss and gradients (plain and flash attention, dense and chunked
logits, remat), the AdamW + clip + warmup-cosine trajectory, the schedules,
the batch iterators, the MLP and the single-device ``Trainer``, and the
``train_gpt2`` entry point."""

import dataclasses
import inspect
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsml_tpu.models import common as jcommon
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.models.mlp import MLP as JaxMLP
from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
from dsml_tpu.trainer import Trainer as JaxTrainer
from dsml_tpu.utils import data as jdata
from dsml_tpu.utils.schedules import make_schedule as jax_make_schedule
from dsml_tpu_torch.cli import train_gpt2
from dsml_tpu_torch.models import MLP
from dsml_tpu_torch.models import common as tcommon
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata
from dsml_tpu_torch.utils.schedules import make_schedule

# f32 on both sides: the loss agrees to rounding; each gradient tensor is
# held to 1e-4 of its own largest entry (sums run in another order over
# b·s rows, and the flash path recomputes p from lse)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_TOL = 1e-4


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _grad_dict(model):
    return {name: p.grad.detach().numpy() for name, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL_TOL * scale, f"{name}: max abs err {err} vs max |g| {scale}"


def _pair(xent_chunk, seed=5):
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), xent_chunk=xent_chunk)
    jmodel = jgpt2.GPT2(jcfg)
    jparams = jmodel.init(seed)
    tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), xent_chunk=xent_chunk),
                        device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("xent_chunk", [0, 128], ids=["dense", "chunked"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_gpt2_loss_and_grads_match_jax(attn_impl, xent_chunk):
    """``GPT2.loss`` and the gradient of every parameter against
    ``jax.value_and_grad`` of the JAX loss from the same weights: plain
    attention (``GPT2.loss``) or the flash kernels (``loss_spmd(...,
    attn_impl="flash")``, Pallas in interpret mode), dense logits or the
    chunked loss (vocab 512 > chunk 128)."""
    jmodel, jparams, tmodel = _pair(xent_chunk)
    x, y = _tokens((2, 64), 512, 1), _tokens((2, 64), 512, 2)
    if attn_impl == "flash":
        def jloss(p):
            return jmodel.loss_spmd(p, jnp.asarray(x), jnp.asarray(y), attn_impl="flash")
    else:
        def jloss(p):
            return jmodel.loss(p, jnp.asarray(x), jnp.asarray(y))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss = tmodel.loss(torch.from_numpy(x).long(), torch.from_numpy(y).long(), attn_impl=attn_impl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, want_grads)).items()}
    _assert_grads_close(_grad_dict(tmodel), want)


@pytest.mark.parametrize("remat", [True, "mlp"])
def test_remat_gives_the_same_grads(remat):
    base = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(3)
    other = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), remat=remat), device="cpu")
    other.load_state_dict(base.state_dict())
    x, y = (torch.from_numpy(_tokens((2, 32), 512, s)).long() for s in (4, 5))
    for model in (base, other):
        model.loss(x, y, attn_impl="flash").backward()
    got, want = _grad_dict(other), _grad_dict(base)
    for name in want:  # recomputation repeats the same CPU arithmetic
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7)


def test_unported_config_options_raise():
    assert tgpt2.GPT2Config(remat="int8").remat == "int8"  # compressed remat is ported
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt2.GPT2Config(n_experts=4)
    with pytest.raises(ValueError, match="unknown remat"):
        tgpt2.GPT2Config(remat="int4")


def test_adamw_clip_warmup_cosine_tracks_optax():
    """Five steps of the entry point's ``train_step`` (clip by global norm,
    then AdamW at the warmup-cosine lr of the count before the update) on
    the same batches as ``optax.chain(clip_by_global_norm, adamw)``. The
    first step's lr is 0 (optax evaluates the schedule before counting),
    and the clip bites on every step."""
    steps, clip = 5, 0.05
    jmodel, jparams, tmodel = _pair(0, seed=9)
    sched = make_schedule("cosine", 1e-2, steps, 2)
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(jax_make_schedule("cosine", 1e-2, steps, 2)))
    state = opt.init(jparams)
    topt = torch.optim.AdamW(tmodel.parameters(), lr=0.0, weight_decay=1e-4)
    assert sched(0) == 0.0

    @jax.jit
    def jstep(params, state, x, y):
        loss, g = jax.value_and_grad(jmodel.loss)(params, x, y)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss, optax.global_norm(g)

    for i in range(steps):
        x, y = _tokens((4, 32), 512, 10 + i), _tokens((4, 32), 512, 20 + i)
        jparams, state, jl, gnorm = jstep(jparams, state, jnp.asarray(x), jnp.asarray(y))
        assert float(gnorm) > clip
        tl = train_gpt2.train_step(tmodel, topt, sched(i), torch.from_numpy(x).long(),
                                   torch.from_numpy(y).long(), grad_accum=2, clip_norm=clip)
        np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.state_dict().items():
        # Adam normalises each update to ~lr, so the parameters agree to a
        # small fraction of the 5 steps' total movement (<= 5e-2 each)
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, rtol=0, err_msg=name)


def test_adam_moments_stay_in_the_parameter_type():
    """optax keeps Adam's moments in the parameter type (bf16 in a bf16
    run); torch.optim.AdamW, as the port uses it, does too."""
    jparams = {"w": jnp.ones((4, 4), jnp.bfloat16)}
    mu = optax.adamw(1e-3).init(jparams)[0].mu["w"]
    model = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype="bfloat16"), device="cpu").init(1)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=1e-4)
    x, y = (torch.from_numpy(_tokens((2, 16), 512, s)).long() for s in (8, 9))
    train_gpt2.train_step(model, opt, 1e-3, x, y)
    assert mu.dtype == jnp.bfloat16
    for p in model.parameters():
        assert opt.state[p]["exp_avg"].dtype == opt.state[p]["exp_avg_sq"].dtype == torch.bfloat16


def test_adamw_weight_decay_is_each_call_sites(monkeypatch):
    """optax.adamw's default weight decay (1e-4) is what the JAX example and
    trainer use; the port's entry point and trainer take the same value
    (the bench's 0.01 is chip_smoke.py's own)."""
    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == 1e-4
    from dsml_tpu_torch.trainer import _make_optimizer

    opt, _ = _make_optimizer(TrainConfig(optimizer="adamw"), [torch.nn.Parameter(torch.ones(2))], 10)
    assert opt.defaults["weight_decay"] == 1e-4
    made = []
    real = torch.optim.AdamW
    monkeypatch.setattr(torch.optim, "AdamW", lambda *a, **k: made.append(k) or real(*a, **k))
    train_gpt2.main(["--device", "cpu", "--model", "tiny", "--steps", "1", "--seq_len", "16",
                     "--batch_size", "2", "--grad_accum", "1"])
    assert [k["weight_decay"] for k in made] == [1e-4]


def test_grad_accum_is_the_mean_over_microbatches():
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(2)
    x, y = (torch.from_numpy(_tokens((4, 16), 512, s)).long() for s in (6, 7))
    model.loss(x, y).backward()
    full = _grad_dict(model)
    sgd = torch.optim.SGD(model.parameters(), lr=0.0)
    loss = train_gpt2.train_step(model, sgd, 0.0, x, y, grad_accum=2)
    np.testing.assert_allclose(loss.item(), model.loss(x, y).item(), **LOSS_TOL)
    _assert_grads_close(_grad_dict(model), full)


@pytest.mark.parametrize("name", ["constant", "cosine", "linear", "step"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_make_schedule_equals_optax(name, warmup):
    for kw in ({}, {"end_lr_frac": 0.1, "step_every": 4, "step_gamma": 0.5}):
        want = jax_make_schedule(name, 0.01, 20, warmup, **kw)
        got = make_schedule(name, 0.01, 20, warmup, **kw)
        # optax evaluates in f32, the port in Python floats: a few f32 ulps
        # of an lr of at most 1e-2
        np.testing.assert_allclose([got(c) for c in range(25)],
                                   [float(want(c)) for c in range(25)], rtol=1e-6, atol=1e-9)


def test_plateau_schedule_and_native_loader_raise():
    with pytest.raises(NotImplementedError, match="plateau"):
        make_schedule("plateau", 0.1, 10)
    with pytest.raises(ValueError, match="unknown lr schedule"):
        make_schedule("exp", 0.1, 10)
    x, y = np.zeros((8, 2), np.float32), np.zeros(8, np.int32)
    with pytest.raises(NotImplementedError, match="runtime slice"):
        next(tdata.shard_batches(x, y, 4, native=True))


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_shard_batches_equal_jax(drop_remainder):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((50, 3)).astype(np.float32), rng.integers(0, 5, 50).astype(np.int32)
    got = list(tdata.shard_batches(x, y, 8, seed=4, drop_remainder=drop_remainder))
    want = list(jdata.shard_batches(x, y, 8, seed=4, drop_remainder=drop_remainder, native=False))
    assert len(got) == len(want) == (6 if drop_remainder else 7)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_lm_window_batches_and_eval_split_equal_jax():
    tokens = np.random.default_rng(1).integers(0, 256, 5000).astype(np.int32)
    got = list(tdata.lm_window_batches(tokens, 32, 4, seed=3, steps=3))
    want = list(jdata.lm_window_batches(tokens, 32, 4, seed=3, steps=3))
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.int32 and gx.shape == (4, 32)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    for args in ((tokens, 32, 4), (tokens[:200], 32, 4)):
        (gt, ge), (wt, we) = tdata.carve_lm_eval_split(*args), jdata.carve_lm_eval_split(*args)
        np.testing.assert_array_equal(gt, wt)
        assert (ge is None) == (we is None)
        if ge is not None:
            np.testing.assert_array_equal(ge, we)


def test_prefetch_batches_keeps_order_and_raises_errors():
    assert list(tdata.prefetch_batches(iter(range(7)))) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(tdata.prefetch_batches(broken()))


def test_mnist_fallback_and_synthetic_data_equal_jax():
    got = tdata.load_mnist(augment_fallback=False)
    want = jdata.load_mnist(augment_fallback=False)
    for name in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.n_train == 8000 and got.train_x.shape[1] == 784
    imgs = (np.arange(2 * 5 * 5) % 7).astype(np.uint8).reshape(2, 5, 5)
    labels = np.array([3, 4])
    for g, w in zip(tdata._augment_shifts(imgs, labels), jdata._augment_shifts(imgs, labels)):
        np.testing.assert_array_equal(g, w)
    g, w = tdata.synthetic_classification(100, 6, 4, seed=2), jdata.synthetic_classification(100, 6, 4, seed=2)
    np.testing.assert_array_equal(g.train_x, w.train_x)
    np.testing.assert_array_equal(g.test_y, w.test_y)


def test_common_helpers_match_jax():
    cfg = tgpt2.GPT2Config.small()
    assert tcommon.transformer_train_flops(cfg, 8 * 1024, 1024) == \
        jcommon.transformer_train_flops(jgpt2.GPT2Config.small(), 8 * 1024, 1024)
    assert tcommon.mlp_train_flops(1000, 64) == jcommon.mlp_train_flops(1000, 64)
    np.testing.assert_array_equal(
        tcommon.he_init(np.random.default_rng(3), 4, 5, fan_in=4).numpy(),
        np.asarray(jcommon.he_init(np.random.default_rng(3), 4, 5, fan_in=4)))
    rng = np.random.default_rng(4)
    logits, y = rng.standard_normal((6, 10)).astype(np.float32), rng.integers(0, 10, 6)
    np.testing.assert_allclose(
        tcommon.softmax_xent(torch.from_numpy(logits), torch.from_numpy(y)).item(),
        float(jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(y))), rtol=1e-6)
    assert int(tcommon.count_correct(torch.from_numpy(logits), torch.from_numpy(y))) == \
        int(jcommon.count_correct(jnp.asarray(logits), jnp.asarray(y)))


def test_mlp_loads_the_jax_tree_and_matches():
    jmlp = JaxMLP((12, 16, 8, 4))
    jparams = jmlp.init(1)
    mlp = MLP((12, 16, 8, 4), device="cpu")
    mlp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert mlp.n_params == jmlp.n_params
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((5, 12)).astype(np.float32), rng.integers(0, 4, 5).astype(np.int32)
    np.testing.assert_allclose(mlp.apply(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmlp.apply(jparams, jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    loss = mlp.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want_loss, want_grads = jax.value_and_grad(jmlp.loss)(jparams, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for name, g in params_from_jax(jax.tree.map(np.asarray, want_grads)).items():
        np.testing.assert_allclose(getattr(mlp, name).grad.numpy(), g.numpy(), atol=1e-6, rtol=1e-5)
    # init: He-normal from a torch.Generator, deterministic per seed
    a, b = MLP((12, 16, 4), device="cpu").init(3), MLP((12, 16, 4), device="cpu").init(3)
    assert torch.equal(a.w0, b.w0) and torch.all(a.b0 == 0)
    assert abs(a.w0.std().item() - (2 / 12) ** 0.5) < 0.15


@pytest.mark.parametrize("optimizer,schedule,warmup", [
    ("sgd", "constant", 0), ("momentum", "step", 0), ("adamw", "cosine", 3),
])
def test_trainer_epochs_match_jax_trainer(optimizer, schedule, warmup):
    """Two epochs on synthetic data from the JAX init: the per-epoch average
    loss and train accuracy, and the test accuracy, of the JAX trainer
    (dp=1) and the port's. Both draw the same batches."""
    data = jdata.synthetic_classification(900, 32, 10, seed=3)
    jmlp = JaxMLP((32, 64, 10))
    jparams = jmlp.init(0)
    kw = dict(epochs=2, batch_size=64, lr=0.05, optimizer=optimizer, lr_schedule=schedule,
              warmup_steps=warmup, seed=1)
    _, jhist, jacc = JaxTrainer(jmlp, JaxTrainConfig(dp=1, **kw)).train(data, jparams)
    state, hist, acc = Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(**kw)).train(
        tdata.synthetic_classification(900, 32, 10, seed=3),
        params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert sorted(state) == ["b0", "b1", "w0", "w1"]
    assert [h["epoch"] for h in hist] == [1, 2]
    for g, w in zip(hist, jhist):
        # f32 on both sides over 2 × 12 steps
        np.testing.assert_allclose(g["avg_loss"], w["avg_loss"], rtol=1e-4, atol=1e-6)
        assert abs(g["train_accuracy"] - w["train_accuracy"]) <= 2 / 810  # a near-tie or two
    assert abs(acc - jacc) <= 1 / 90


def test_trainer_raises_for_unported_options():
    data = tdata.synthetic_classification(100, 4, 2)
    for kw, match in (({"algorithm": "ring"}, "data-parallel"), ({"dp": 2}, "data-parallel"),
                      ({"error_feedback": True}, "compressed-communication"),
                      ({"checkpoint_dir": "ck"}, "checkpointing"),
                      ({"lr_schedule": "plateau"}, "plateau")):
        with pytest.raises(NotImplementedError, match=match):
            Trainer(MLP((4, 2), device="cpu"), TrainConfig(epochs=1, batch_size=10, **kw)).train(data)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_gpt2_cli_runs_and_logs():
    handler = _Records()
    logger = logging.getLogger("dsml.gpt2")
    logger.addHandler(handler)
    try:
        out = train_gpt2.main(["--device", "cpu", "--model", "tiny", "--steps", "3",
                               "--seq_len", "32", "--batch_size", "4", "--log_every", "1",
                               "--attn", "flash", "--warmup_steps", "1"])
    finally:
        logger.removeHandler(handler)
    assert set(out) == {"first_loss", "last_loss"}
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    steps = [line for line in handler.lines if line.startswith("step ")]
    assert len(steps) == 3 and "loss = " in steps[-1] and steps[-1].endswith("tokens/s")


@pytest.mark.parametrize("flag", [
    ["--pp", "2"], ["--tp", "2"], ["--sp", "2"], ["--cp", "2"], ["--family", "llama"],
    ["--tokenizer", "bpe"], ["--data", "prose"], ["--checkpoint_dir", "ck"],
    ["--profile_dir", "prof"], ["--optimizer", "adafactor"],
])
def test_train_gpt2_cli_raises_for_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train_gpt2.main(["--device", "cpu", "--steps", "1", *flag])


def test_generated_stories_equal_the_jax_example():
    import examples.train_gpt2 as jexample

    assert train_gpt2._generated_stories(5000, 3) == jexample._generated_stories(5000, 3)
