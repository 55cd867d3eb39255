"""The port's reduce-on-plateau scheduler (``utils.schedules.adaptive_plateau``,
the ``Trainer``'s ``lr_schedule="plateau"`` and its checkpointed state)
against ``optax.contrib.reduce_on_plateau`` and the JAX trainer, on the
CPU: the scale sequence and every state leaf bit for bit over scripted
losses, the scaled learning rate against optax's scaled update, the
checkpoint's ``opt_state`` paths against the JAX trainer's, and
mid-window resumes across the packages."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsml_tpu.models.cnn import CNN as JaxCNN
from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
from dsml_tpu.trainer import Trainer as JaxTrainer
from dsml_tpu.utils.data import synthetic_classification as jax_synthetic
from dsml_tpu.utils.schedules import make_schedule as jax_make_schedule
from dsml_tpu_torch.checkpoint import CheckpointManager
from dsml_tpu_torch.models import CNN
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata
from dsml_tpu_torch.utils.schedules import (PlateauState, ReduceOnPlateau, adaptive_plateau,
                                            make_schedule, wrap_with_plateau)

CNN_KW = dict(conv_features=(4, 8), fc_width=16)
# a loss that stops improving in the fourth epoch (lr 0.2: the first epoch overshoots)
RUN = dict(batch_size=32, lr=0.2, optimizer="momentum", lr_schedule="plateau",
           plateau_patience=1, seed=2)
DATA = dict(n=320, features=28 * 28, classes=10, seed=1)  # 288 rows: 9 updates an epoch
KILL_AT = 31  # the fourth epoch's fourth update: its window open, 4 of 9 values in
# tests/test_trainer.py::test_ring_and_xla_gradient_sync_agree
TRAINER_LOSS_RTOL, TRAINER_PARAM_TOL = 1e-4, dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops oversubscribe the cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scripted_losses(n=72, seed=0):
    """Falls, flattens, jumps and falls again, with noise at the rtol scale
    and exact repeats (ties with the best value)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    v = 3.0 * np.exp(-t / 10) + 1.0 + 2e-4 * rng.standard_normal(n)
    v[30:40] = 1.25
    v[45:50] += 0.5
    return v.astype(np.float32)


CASES = {
    "patience_cooldown": dict(factor=0.5, patience=2, cooldown=2, accumulation_size=3,
                              min_scale=0.1),
    "min_scale": dict(factor=0.1, patience=1, min_scale=1e-3),
    "atol": dict(factor=0.3, patience=2, rtol=0.0, atol=0.02, accumulation_size=2),
    "accumulated": dict(factor=0.5, patience=2, min_scale=1e-3, accumulation_size=4),
    "bf16": dict(factor=0.3, patience=1, accumulation_size=2, min_scale=1e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scale_sequence_equals_optax(case):
    """Fed the same values one update at a time, the port's scale for each
    update (optax's ``new_state.scale``, which multiplies that same update)
    and all six state leaves equal optax's bit for bit; the updates optax
    scales are the port's scale times the gradient."""
    kw = dict(CASES[case])
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    kw.setdefault("rtol", 1e-4)
    tx = optax.contrib.reduce_on_plateau(**kw)
    params = {"w": jnp.zeros(3, dtype)}
    state = tx.init(params)
    update = jax.jit(lambda st, v: tx.update({"w": jnp.ones(3, dtype)}, st, params, value=v))
    plateau = ReduceOnPlateau(dtype=torch.bfloat16 if case == "bf16" else torch.float32, **kw)
    scales = []
    for v in _scripted_losses():
        updates, state = update(state, v)
        scale = plateau.update(torch.tensor(v))
        scales.append(scale)
        assert scale == float(state.scale) == float(updates["w"][0])
        got = plateau.state()
        for field in PlateauState._fields:
            want = np.asarray(getattr(state, field))
            t = getattr(got, field)
            assert str(t.dtype).split(".")[-1] == str(want.dtype), field
            assert np.array_equal(np.asarray(t.float() if t.dtype == torch.bfloat16 else t),
                                  want.astype(np.float32) if want.dtype.name == "bfloat16"
                                  else want), (field, t, want)
    assert min(scales) < 1.0  # the scripted losses trip the rule


def test_update_reads_device_values_once_a_window():
    """Values of an open window stay pending (no host read) until the
    window closes or the state is read; the result is the same as feeding
    floats."""
    plateau, ref = adaptive_plateau(accumulation_size=5), adaptive_plateau(accumulation_size=5)
    vals = _scripted_losses(12)
    for i, v in enumerate(vals):
        plateau.update(torch.tensor(v))
        ref.update(float(v))
        assert len(plateau._pending) == (i + 1) % 5
    assert all(torch.equal(a, b) for a, b in zip(plateau.state(), ref.state()))
    assert plateau._pending == []


def test_plateau_rejects_what_optax_rejects():
    for kw in (dict(factor=1.0), dict(factor=0.0), dict(rtol=-1.0), dict(rtol=0.0, atol=0.0),
               dict(rtol=2.0)):
        with pytest.raises(ValueError):
            optax.contrib.reduce_on_plateau(**kw)
        with pytest.raises(ValueError):
            ReduceOnPlateau(**kw)


def test_plateau_schedule_is_the_jax_constant_base():
    """``make_schedule("plateau", ...)`` no longer raises: the constant base
    (with warmup) the JAX package chains the plateau after."""
    for warmup in (0, 5):
        jax_sched = jax_make_schedule("plateau", 0.1, 100, warmup)
        sched = make_schedule("plateau", 0.1, 100, warmup)
        for count in (0, 1, 4, 5, 6, 50, 99, 100, 150):
            assert np.isclose(sched(count), float(jax_sched(count)), rtol=1e-6, atol=0.0)


def test_wrap_with_plateau_takes_the_lowest_parameter_dtype():
    p32 = torch.nn.Parameter(torch.ones(2))
    p16 = torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16))
    assert wrap_with_plateau(torch.optim.SGD([p32], lr=0.1)).dtype == torch.float32
    assert wrap_with_plateau(torch.optim.SGD([p32, p16], lr=0.1), patience=2).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "adamw"])
def test_scaled_learning_rate_is_optax_scaled_update(kind):
    """The port scales the learning rate; optax scales the whole update
    after the optimizer. The optimizers are linear in lr — AdamW's
    decoupled decay ``p·(1 - lr·wd)`` included — so three updates under
    changing scales agree."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    scales = [1.0, 0.5, 0.125]
    lr = 0.1
    opt = {"sgd": optax.sgd(lr), "momentum": optax.sgd(lr, momentum=0.9),
           "adam": optax.adam(lr), "adamw": optax.adamw(lr, weight_decay=0.1)}[kind]
    p = jnp.asarray(w0)
    st = opt.init(p)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = {"sgd": lambda: torch.optim.SGD([tp], lr=lr),
            "momentum": lambda: torch.optim.SGD([tp], lr=lr, momentum=0.9),
            "adam": lambda: torch.optim.Adam([tp], lr=lr),
            "adamw": lambda: torch.optim.AdamW([tp], lr=lr, weight_decay=0.1)}[kind]()
    for g, s in zip(grads, scales):
        u, st = opt.update(jnp.asarray(g), st, p)
        p = p + s * u
        tp.grad = torch.from_numpy(g)
        topt.param_groups[0]["lr"] = lr * s
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=1e-5, atol=2e-6)


# ---- the Trainer's checkpointed state --------------------------------------------------


def _manifest(ckdir):
    with CheckpointManager(ckdir) as m:
        step = m.latest_step()
    step_dir = os.path.join(ckdir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)["leaves"]


def _jax_cnn_run(epochs, ckdir, **kw):
    model = JaxCNN(**CNN_KW)
    cfg = JaxTrainConfig(dp=1, epochs=epochs, checkpoint_dir=ckdir, **{**RUN, **kw})
    params, history, acc = JaxTrainer(model, cfg).train(jax_synthetic(**DATA))
    return params_from_jax(jax.tree.map(np.asarray, params)), history, acc


def _port_cnn_run(epochs, ckdir, **kw):
    cfg = TrainConfig(epochs=epochs, checkpoint_dir=ckdir, **{**RUN, **kw})
    return Trainer(CNN(device="cpu", **CNN_KW), cfg).train(tdata.synthetic_classification(**DATA))


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adamw"])
def test_opt_state_paths_equal_the_jax_trainer(optimizer, tmp_path):
    """A one-epoch plateau run's checkpoint: every leaf's path, dtype,
    shape and piece file equal the JAX trainer's, the plateau's six leaves
    at ``opt_state/1/<field>`` in optax's field order."""
    kw = dict(optimizer=optimizer, lr=0.05)
    data = dict(DATA, n=100)
    jcfg = JaxTrainConfig(dp=1, epochs=1, checkpoint_dir=str(tmp_path / "j"), **{**RUN, **kw})
    JaxTrainer(JaxCNN(**CNN_KW), jcfg).train(jax_synthetic(**data))
    Trainer(CNN(device="cpu", **CNN_KW), TrainConfig(
        epochs=1, checkpoint_dir=str(tmp_path / "t"), **{**RUN, **kw})).train(
            tdata.synthetic_classification(**data))
    want, got = (_manifest(str(tmp_path / d)) for d in ("j", "t"))

    def layout(leaves):
        return [(e["path"], e.get("dtype"), e.get("shape"), e.get("inline"),
                 [p["file"] for p in e.get("pieces", [])]) for e in leaves]

    assert layout(got) == layout(want)
    plateau = [e["path"] for e in got if e["path"].startswith("opt_state/1/")]
    assert plateau == [f"opt_state/1/{f}" for f in PlateauState._fields]


@pytest.fixture(scope="module")
def straight_runs(tmp_path_factory):
    """Four epochs uninterrupted in each package, and the final plateau
    state of each (from its last checkpoint)."""
    tmp = tmp_path_factory.mktemp("plateau_straight")
    out = {}
    for name, run in (("jax", _jax_cnn_run), ("port", _port_cnn_run)):
        state, history, _ = run(4, str(tmp / name))
        with CheckpointManager(str(tmp / name)) as m:
            out[name] = (state, history, m.restore()["opt_state"][1])
    return out


def _interrupted(run, ckdir):
    """Four epochs with a save every ``KILL_AT`` updates, then every later
    checkpoint deleted: the latest is update 31, inside the fourth epoch's
    plateau window."""
    run(4, ckdir, save_every_steps=KILL_AT)
    with CheckpointManager(ckdir) as m:
        assert m.iterator_state(KILL_AT) == {"epoch": 4, "consumed": 4}
        m.delete_steps([s for s in m.all_steps() if s > KILL_AT])


def test_straight_runs_trip_the_plateau_in_the_fourth_window(straight_runs):
    """Both packages' uninterrupted runs track each other at the trainer
    bounds, and their fourth epoch's window decays the scale."""
    (js, jh, jst), (ts, th, tst) = straight_runs["jax"], straight_runs["port"]
    for g, w in zip(th, jh, strict=True):
        assert np.isclose(g["avg_loss"], w["avg_loss"], rtol=TRAINER_LOSS_RTOL)
    for k, t in ts.items():
        np.testing.assert_allclose(t.numpy(), js[k].numpy(), **TRAINER_PARAM_TOL, err_msg=k)
    assert float(jst["scale"]) == float(tst["scale"]) == 0.5


@pytest.mark.parametrize("direction", ["jax_then_port", "port_then_jax"])
def test_plateau_resumes_mid_window_across_packages(direction, straight_runs, tmp_path):
    """A plateau run checkpointed inside a window by one package resumes in
    the other and matches the uninterrupted run: the window's ``count``
    and ``avg_value`` come back, so the window closes on the same mean and
    decays the scale as the straight run's; weights within the trainer
    bounds."""
    first, then = ((_jax_cnn_run, _port_cnn_run) if direction == "jax_then_port"
                   else (_port_cnn_run, _jax_cnn_run))
    ck = str(tmp_path / "ck")
    _interrupted(first, ck)
    with CheckpointManager(ck) as m:
        mid = m.restore()["opt_state"][1]
    assert int(mid["count"]) == 4 and float(mid["avg_value"]) > 0
    state, history, _ = then(4, ck, resume=True, save_every_steps=KILL_AT)  # ends at id 36
    assert [h["epoch"] for h in history] == [4]
    want_state, _, want_plateau = straight_runs["jax"]
    for k, t in state.items():
        np.testing.assert_allclose(t.numpy(), want_state[k].numpy(), **TRAINER_PARAM_TOL,
                                   err_msg=k)
    with CheckpointManager(ck) as m:
        got = m.restore()["opt_state"][1]
    for k in ("scale", "plateau_count", "cooldown_count", "count"):
        assert float(got[k]) == float(want_plateau[k]), k
    assert np.isclose(float(got["best_value"]), float(want_plateau["best_value"]),
                      rtol=TRAINER_LOSS_RTOL)


def test_port_plateau_kill_and_resume_bit_identical(straight_runs, tmp_path):
    """In the port alone a resume inside the window is exact: the weights
    and the final plateau state equal the uninterrupted run's bit for
    bit."""
    ck = str(tmp_path / "ck")
    _interrupted(_port_cnn_run, ck)
    state, _, _ = _port_cnn_run(4, ck, resume=True, save_every_steps=KILL_AT)
    want_state, _, want_plateau = straight_runs["port"]
    assert all(torch.equal(t, want_state[k]) for k, t in state.items())
    with CheckpointManager(ck) as m:
        got = m.restore()["opt_state"][1]
    for k in PlateauState._fields:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want_plateau[k])), k
