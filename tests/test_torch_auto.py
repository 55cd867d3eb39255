"""The port's mesh planner (``parallel.auto``), its activation measurement
and the memory ledger's and Trainer's feeds of it, against
``dsml_tpu.parallel.auto`` on the CPU.

The plan is pure arithmetic: the same inputs must give the JAX package's
spec, reasons, ``pp_interleave`` and ``hbm_source`` (on the CPU both land on
the 16 GB fallback). ``measured_activation_bytes`` is the port's own design
(the bytes autograd saves, on the meta device), so it is held to its
properties. One module fixture spawns four gloo ranks in which meshes the
planner emits (fsdp, fsdp × tp, pp × tp under the interleaved gpipe and pp
under 1f1b; GPT-2 tiny) train, their first loss against the JAX hybrid
step's on a JAX plan's mesh, computed here meanwhile."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.obs import memory as tmemory
from dsml_tpu_torch.parallel import auto as tauto
from dsml_tpu_torch.parallel.hybrid import hybrid_model, init_hybrid, make_hybrid_train_step
from dsml_tpu_torch.parallel.mesh import build_mesh

LOSS_RTOL = 5e-4  # tests/test_torch_tp.py: the tp loss against the JAX model's
B, S = 8, 32


class _FakeDevice:
    """A device reporting ``gb`` GB through ``memory_stats()``, the
    protocol both planners read."""

    def __init__(self, gb, kind="fake-card"):
        self._limit = gb * 1e9
        self.device_kind = kind

    def memory_stats(self):
        return {"bytes_limit": self._limit}


class _Statless:
    device_kind = "statless"

    def memory_stats(self):
        return None


# (name, plan_mesh kwargs) — pure dp, fsdp, pp + tp + fsdp, shallow, sp from
# the analytic and the measured footprint, explicit hbm_bytes, device stats,
# the CPU fallback
GRID = {
    "pure_dp": dict(n_devices=8, n_params=125e6, n_head=12, hbm_bytes=16e9),
    "one_device": dict(n_devices=1, n_params=125e6, hbm_bytes=16e9),
    "fsdp": dict(n_devices=64, n_params=30e9, n_head=48, hbm_bytes=16e9),
    "fsdp_from_device": dict(n_devices=8, n_params=2e9, n_head=16, device=_FakeDevice(16)),
    "fsdp_bigger_device": dict(n_devices=8, n_params=2e9, n_head=16, device=_FakeDevice(32)),
    "explicit_over_device": dict(n_devices=8, n_params=2e9, n_head=16, device=_FakeDevice(32),
                                 hbm_bytes=16e9),
    "pp_tp_fsdp": dict(n_devices=8, n_params=30e9, n_head=8, n_layer=8, hbm_bytes=16e9),
    "pp_v3": dict(n_devices=4, n_params=30e9, n_head=8, n_layer=6, hbm_bytes=16e9),
    "huge_best_effort": dict(n_devices=64, n_params=500e9, n_head=64, n_layer=80,
                             hbm_bytes=16e9),
    "shallow_no_pp": dict(n_devices=8, n_params=30e9, n_head=8, hbm_bytes=16e9),
    "sp_analytic": dict(n_devices=8, n_params=125e6, n_head=12, seq_len=131_072, d_model=768,
                        n_layer=12, hbm_bytes=16e9),
    "sp_measured": dict(n_devices=8, n_params=125e6, n_head=12, act_bytes=30e9, hbm_bytes=16e9),
    "sp_best_effort": dict(n_devices=4, n_params=125e6, act_bytes=300e9, hbm_bytes=16e9),
    "statless_device": dict(n_devices=8, n_params=1e6, device=_Statless()),
    "cpu_fallback": dict(n_devices=8, n_params=2e9, n_head=16),
}


def _plans(name):
    from dsml_tpu.parallel.auto import plan_mesh as jax_plan_mesh

    kw = GRID[name]
    return tauto.plan_mesh(**kw), jax_plan_mesh(**kw)


@pytest.mark.parametrize("name", list(GRID))
def test_plan_mesh_matches_jax(name):
    """The same spec, reasons, ``pp_interleave`` and ``hbm_source`` as the
    JAX planner on every input of the grid."""
    got, want = _plans(name)
    assert got.spec.sizes_dict() == want.spec.sizes_dict()
    assert got.reasons == want.reasons
    assert got.pp_interleave == want.pp_interleave
    assert got.hbm_source == want.hbm_source


def test_fallback_warns_once_and_sets_the_gauge(monkeypatch):
    """Where no card reports its memory (the CPU), both planners take the
    16 GB constant: one warning, provenance ``fallback`` in the plan, and
    the ``plan_hbm_bytes{source}`` gauge on each package's registry."""
    from dsml_tpu import obs as jobs
    from dsml_tpu.parallel import auto as jauto

    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logger = logging.getLogger("dsml.auto")
    logger.addHandler(handler)
    monkeypatch.setattr(tauto, "_warned_fallback", False)
    monkeypatch.setattr(jauto, "_warned_fallback", False)
    for pkg in (tobs, jobs):
        pkg.enable(forensics=False)
    try:
        for _ in range(2):
            got, want = _plans("cpu_fallback")
            assert got.hbm_source == want.hbm_source == "fallback"
        for pkg in (tobs, jobs):
            rows = [r for r in pkg.get_registry().collect() if r["name"] == "plan_hbm_bytes"]
            assert [(r["labels"], r["value"]) for r in rows] == [({"source": "fallback"}, 16e9)]
    finally:
        for pkg in (tobs, jobs):
            pkg.disable()
        logger.removeHandler(handler)
    # one from each package's planner, and none from the second plans
    assert sum("memory_stats" in m and "16 GB/chip" in m for m in seen) == 2


def test_cuda_card_is_read_with_provenance(monkeypatch):
    """On a card the planner reads its total memory (provenance
    ``memory_stats``, the card's name in the reason)."""
    props = type("P", (), {"total_memory": 80e9})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "NVIDIA H100 80GB HBM3")
    plan = tauto.plan_mesh(n_devices=8, n_params=2e9, n_head=16)
    assert plan.hbm_source == "memory_stats"
    assert plan.reasons[0] == "per-chip HBM 80.0 GB (memory_stats of NVIDIA H100 80GB HBM3)"


def test_activation_bytes_for_rescales_and_plan_reads_the_ledger():
    """``record_activation_measurement`` keeps the measurement with its
    batch, ``activation_bytes_for`` rescales it linearly, and both planners
    read it (the same reasons) before the analytic guess."""
    from dsml_tpu import obs as jobs
    from dsml_tpu.obs import memory as jmemory

    ledgers = (tmemory.get_memory_ledger(), jmemory.get_memory_ledger())
    for pkg in (tobs, jobs):
        pkg.enable(forensics=False)
    try:
        for led in ledgers:
            assert led.activation_bytes_for(4) is None
            led.record_activation_measurement(9e9, batch=1)
            assert led.activation_bytes_for(4) == 4 * 9e9
            assert led.claimed()["activations"]["measured_step_temp"] == 9e9
        for kw in (dict(), dict(batch_per_device=4)):
            got, want = _plans_with(n_devices=8, n_params=1e6, hbm_bytes=16e9, **kw)
            assert got.reasons == want.reasons and got.spec == _port_spec(want.spec)
            assert any("ledger-measured" in r for r in got.reasons) and got.spec.sp > 1
        assert any("rescaled to batch_per_device=4" in r for r in got.reasons)
    finally:
        for led in ledgers:
            led.clear()
        for pkg in (tobs, jobs):
            pkg.disable()
    assert tmemory.get_memory_ledger().activation_bytes_for(4) is None


def _plans_with(**kw):
    from dsml_tpu.parallel.auto import plan_mesh as jax_plan_mesh

    return tauto.plan_mesh(**kw), jax_plan_mesh(**kw)


def _port_spec(jspec):
    from dsml_tpu_torch.parallel.mesh import MeshSpec

    return MeshSpec(**jspec.sizes_dict())


def test_record_activation_measurement_is_a_noop_when_disabled():
    led = tmemory.MemoryLedger(registry=tobs.Registry(enabled=False))
    led.record_activation_measurement(1e9, batch=2)
    assert led.activation_bytes_for(2) is None and led.claimed() == {}


def test_measured_activation_bytes_grows_with_the_batch():
    """From shapes alone (a meta model, meta tokens): a 4× batch saves
    about 4× the bytes, and the number drops into the planner."""
    cfg = tgpt2.GPT2Config.tiny()
    model = tgpt2.GPT2(cfg, device="meta")

    def measure(batch):
        x = torch.empty(batch, S, dtype=torch.long, device="meta")
        return tauto.measured_activation_bytes(model.loss, x, x)

    small, big = measure(2), measure(8)
    assert small > 0 and 3.5 * small < big < 4.5 * small, (small, big)
    # saved activations of a tiny GPT-2 step: at least a [b, s, d] f32 tensor a layer
    assert small >= 2 * S * cfg.d_model * 4 * cfg.n_layer
    plan = tauto.plan_mesh(n_devices=8, n_params=1e5, n_head=cfg.n_head, act_bytes=big,
                           hbm_bytes=16e9)
    assert any("caller-measured" in r for r in plan.reasons)


def test_measured_activation_bytes_none_and_raise():
    """None where nothing builds a graph; a broken loss raises; a model's
    meta twin measures without touching its weights."""
    x = torch.empty(4, 8, device="meta")
    assert tauto.measured_activation_bytes(lambda a: (a * 2).sum(), x) is None
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="meta")
    bad = torch.empty(2, 4, 3, dtype=torch.long, device="meta")
    with pytest.raises(Exception):
        tauto.measured_activation_bytes(model.loss, bad, bad)
    from dsml_tpu_torch.models.mlp import MLP

    mlp = MLP((16, 32, 4), device="cpu").init(0)
    twin = tauto.meta_twin(mlp)
    assert all(p.is_meta for p in twin.parameters()) and not any(
        p.is_meta for p in mlp.parameters())
    xs = torch.empty(5, 16, device="meta")
    ys = torch.empty(5, dtype=torch.long, device="meta")
    # the hidden activations of 5 rows: h0 [5, 32] before and after the ReLU, the logits
    assert tauto.measured_activation_bytes(twin.loss, xs, ys) > 5 * 32 * 4


def test_trainer_measure_act_claims_and_records(monkeypatch, tmp_path):
    """``DSML_MEASURE_ACT=1`` enables observability, measures before
    training, claims the ``activations`` subsystem with its batch (which
    ``plan_mesh`` then reads), records the ``activation_measured`` event
    with the JAX trainer's fields and logs; a failing measurement logs a
    warning and training goes on."""
    from dsml_tpu import obs as jobs
    from dsml_tpu.models.mlp import MLP as JaxMLP
    from dsml_tpu.obs import memory as jmemory
    from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
    from dsml_tpu.trainer import Trainer as JaxTrainer
    from dsml_tpu_torch.models.mlp import MLP
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils import data as tdata

    monkeypatch.setenv("DSML_MEASURE_ACT", "1")
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    data = tdata.synthetic_classification(40, 8, 3)
    kw = dict(epochs=1, batch_size=10)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logger = logging.getLogger("dsml.trainer")
    logger.addHandler(handler)
    try:
        _, history, _ = Trainer(MLP((8, 16, 3), device="cpu"), TrainConfig(**kw)).train(data)
        assert np.isfinite(history[0]["avg_loss"]) and tobs.get_registry().enabled
        led = tmemory.get_memory_ledger()
        measured = led.claimed()["activations"]["measured_step_temp"]
        assert measured > 0 and led.activation_bytes_for(10) == measured
        event = [e for e in tobs.get_flight_recorder().events()
                 if e["kind"] == "activation_measured"][-1]
        assert event["bytes"] == int(measured) and event["batch"] == 10
        assert any("measured activation footprint" in m for m in seen)
        plan = tauto.plan_mesh(n_devices=2, n_params=1e4, hbm_bytes=16e9)
        assert any("ledger-measured" in r for r in plan.reasons)
        JaxTrainer(JaxMLP((8, 16, 3)), JaxTrainConfig(dp=1, **kw)).train(data)
        jevent = [e for e in jobs.get_flight_recorder().events()
                  if e["kind"] == "activation_measured"][-1]
        assert set(jevent) == set(event) and jevent["batch"] == 10
        # a failing measurement: a warning, and the run trains
        led.clear()

        def broken(*a):
            raise RuntimeError("no shapes")

        monkeypatch.setattr(tauto, "measured_activation_bytes", broken)
        _, history, _ = Trainer(MLP((8, 16, 3), device="cpu"), TrainConfig(**kw)).train(data)
        assert np.isfinite(history[0]["avg_loss"])
        assert any("activation measurement failed" in m for m in seen)
        assert "activations" not in led.claimed()
    finally:
        logger.removeHandler(handler)
        tmemory.get_memory_ledger().clear()
        jmemory.get_memory_ledger().clear()
        for pkg in (tobs, jobs):
            pkg.disable()


def test_build_mesh_of_an_sp_plan_raises_the_long_context_error(devices8):
    """A plan may carry sp > 1 (the JAX package's plan), and since the
    long-context slice its spec builds (it raised before): rank r takes the
    coordinates ``jax.devices()[r]`` takes in the JAX mesh of the JAX
    plan's spec, and the sp group is the whole ring in rank order."""
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    from dsml_tpu_torch.parallel.mesh import AXES, axis_group_ranks, rank_coords

    plan, want = _plans("sp_measured")
    assert plan.spec.sp == want.spec.sp == 8
    ids = np.vectorize(lambda d: devices8.index(d))(jax_build_mesh(want.spec, devices8).devices)
    spec = plan.spec.resolved(8)
    for rank in range(8):
        assert rank_coords(spec, rank) == dict(zip(AXES, map(int, np.argwhere(ids == rank)[0])))
    assert axis_group_ranks(spec, "sp") == [list(range(8))]


# ---------------------------------------------------------------------------
# planner-emitted meshes train
# ---------------------------------------------------------------------------

# name -> (plan_mesh kwargs beyond the model's, n_layer, schedule, expected spec)
PLANNED = {
    "fsdp": (dict(n_devices=2, hbm_bytes=2e6), 2, "gpipe", dict(fsdp=2)),
    "fsdp_tp": (dict(n_devices=4, hbm_bytes=2.5e5, n_layer=0), 2, "gpipe", dict(fsdp=2, tp=2)),
    "pp_tp_interleaved": (dict(n_devices=4, hbm_bytes=2.5e5), 4, "gpipe", dict(pp=2, tp=2)),
    "pp_1f1b": (dict(n_devices=2, hbm_bytes=2.5e5), 2, "1f1b", dict(pp=2)),
}
PLANNED_ROUNDS = [[("fsdp", (0, 1)), ("pp_1f1b", (2, 3))], [("fsdp_tp", (0, 1, 2, 3))],
                  [("pp_tp_interleaved", (0, 1, 2, 3))]]


def _tiny(n_layer, port=True):
    if port:
        return dataclasses.replace(tgpt2.GPT2Config.tiny(), n_layer=n_layer, max_seq=S)
    from dsml_tpu.models.gpt2 import GPT2Config

    return dataclasses.replace(GPT2Config.tiny(), n_layer=n_layer, max_seq=S)


def _plan_kwargs(name, port=True):
    kw, n_layer, _, _ = PLANNED[name]
    cfg = _tiny(n_layer, port)
    n_params = sum(p.numel() for p in tgpt2.GPT2(_tiny(n_layer), device="meta").parameters())
    return {"n_params": n_params, "n_head": cfg.n_head, "n_layer": n_layer, **kw}


def _batch():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 512, (B, S)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _planned_program(name, rank, world, tmp):
    plan = tauto.plan_mesh(**_plan_kwargs(name))
    _, n_layer, schedule, _ = PLANNED[name]
    workdir = os.path.join(tmp, name)
    os.makedirs(workdir, exist_ok=True)
    mesh = build_mesh(plan.spec, rank, world, os.path.join(workdir, "rendezvous"), "cpu")
    cfg = dataclasses.replace(_tiny(n_layer), pp_interleave=plan.pp_interleave)
    model = hybrid_model(tgpt2.GPT2, cfg, mesh)
    model, opt = init_hybrid(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh, 0)
    step = make_hybrid_train_step(model, opt, mesh, n_microbatches=2, schedule=schedule)
    x, y = _batch()
    losses = [float(step(x, y)) for _ in range(2)]
    out = {"losses": losses, "spec": mesh.spec.sizes_dict(), "v": cfg.pp_interleave}
    mesh.close()
    dist.destroy_process_group()
    return out


def _planned_worker(rank, tmp):
    torch.set_num_threads(1)
    res = {}
    for round_ in PLANNED_ROUNDS:
        for name, ranks in round_:
            if rank in ranks:
                res[name] = _planned_program(name, ranks.index(rank), len(ranks), tmp)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


# the JAX hybrid step on the JAX plan's mesh for each depth: its first loss
# is the forward at the initial weights, the same on any mesh up to f32
# summation order (far under LOSS_RTOL)
JAX_REFERENCE = {2: "fsdp_tp", 4: "pp_tp_interleaved"}


def _jax_first_losses(devices):
    """Each JAX plan's spec and ``pp_interleave``, and the JAX hybrid
    step's first loss on the ``JAX_REFERENCE`` plans' meshes (by depth)."""
    import optax

    from dsml_tpu.models.gpt2 import GPT2
    from dsml_tpu.parallel.auto import plan_mesh as jax_plan_mesh
    from dsml_tpu.parallel.hybrid import init_hybrid as jax_init_hybrid
    from dsml_tpu.parallel.hybrid import make_hybrid_train_step as jax_step
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    x, y = _batch()
    plans = {name: jax_plan_mesh(**_plan_kwargs(name, port=False)) for name in PLANNED}
    losses = {}
    for n_layer, name in JAX_REFERENCE.items():
        plan, (_, _, schedule, _) = plans[name], PLANNED[name]
        n = plan.spec.pp * plan.spec.dp * plan.spec.fsdp * plan.spec.sp * plan.spec.tp
        mesh = jax_build_mesh(plan.spec, devices[:n])
        model = GPT2(dataclasses.replace(_tiny(n_layer, port=False),
                                         pp_interleave=plan.pp_interleave))
        opt = optax.adam(1e-3)
        step = jax_step(model, opt, mesh, n_microbatches=2, schedule=schedule)
        params, state = jax_init_hybrid(model, opt, mesh, seed=0)
        losses[n_layer] = float(step(params, state, x, y)[2])
    return {name: {"loss": losses[PLANNED[name][1]], "spec": plan.spec.sizes_dict(),
                   "v": plan.pp_interleave} for name, plan in plans.items()}


@pytest.fixture(scope="module")
def planned(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("planned")
    ctx = mp.start_processes(_planned_worker, args=(str(tmp),), nprocs=4, join=False,
                             start_method="spawn")
    try:
        jax_out = _jax_first_losses(devices8)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    port = {name: [ranks[r][name] for r in members]
            for round_ in PLANNED_ROUNDS for name, members in round_}
    return port, jax_out


@pytest.mark.parametrize("name", list(PLANNED))
def test_planner_emitted_mesh_trains_like_jax(planned, name):
    """The mesh the plan emits (fsdp; fsdp × tp; pp × tp with the plan's
    ``pp_interleave`` under gpipe; pp under 1f1b) builds, initialises and
    trains: every rank's first loss equals the JAX hybrid step's (on the
    JAX plan's mesh of its depth, ``JAX_REFERENCE``) within ``LOSS_RTOL``,
    and the second is lower; the JAX plan is the same mesh."""
    port, jax_out = planned
    want = jax_out[name]
    expect = {"pp": 1, "dp": 1, "fsdp": 1, "sp": 1, "cp": 1, "tp": 1, **PLANNED[name][3]}
    assert want["spec"] == {**expect, "cp": want["spec"]["cp"]}
    for r in port[name]:
        assert r["spec"] == expect and r["v"] == want["v"]
        assert abs(r["losses"][0] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert np.isfinite(r["losses"]).all() and r["losses"][1] < r["losses"][0]
        assert r["losses"] == port[name][0]["losses"]
    if name == "pp_tp_interleaved":
        assert want["v"] == 2
