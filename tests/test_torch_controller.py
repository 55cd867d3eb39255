"""The port's elastic chaos-survival controller
(``dsml_tpu_torch/runtime/controller.py``) against the JAX package's
``runtime/controller.py``, on the CPU.

The port's controller drives worlds of one module-scoped pool of four CPU
worker processes (``parallel/world.py``); the JAX controller runs on
``devices8[:4]``. Compared with the JAX controller: only deterministic
outputs (recovery kinds, widths, resume steps, losses, parameters) — never
wall times, goodput or recovery milliseconds."""

import numpy as np
import optax
import pytest

from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec
from dsml_tpu_torch.parallel.world import TrainRecipe, WorkerPool
from dsml_tpu_torch.runtime import chaos as tchaos
from dsml_tpu_torch.runtime.controller import (ControllerConfig, DeviceLost, ElasticController,
                                               StaticFleet)

RECIPE = TrainRecipe(tgpt2.GPT2Config.tiny(), lr=1e-2)
HBM = {"hbm_bytes": 16e9}
HYBRID_RTOL = 2e-3  # tests/test_torch_fsdp.py (tests/test_fsdp.py::test_hybrid_fsdp_matches_pure_dp)
# parameters after 24 Adam(1e-2) steps through three re-plans: an element
# whose gradient is near zero moves by up to ~lr·sign(g) a step, so two
# packages that round g differently can part there by a fraction of lr
PARAM_TOL = dict(rtol=2e-3, atol=1e-3)
SLOTS = [0, 1, 2, 3]
N_STEPS = 24


def _schedule(events_cls, sched_cls):
    """The four-slot scripted schedule: every kill hits the live mesh."""
    return sched_cls([events_cls(6, "kill", (3,), inject=True), events_cls(10, "kill", (1,)),
                      events_cls(13, "kill", (0,)), events_cls(17, "restore", ())])


def _batches(n_steps, global_batch=8, seed=0):
    cfg = RECIPE.config
    rng = np.random.default_rng(seed)
    data = rng.integers(0, cfg.vocab_size, (n_steps + 4, global_batch, cfg.max_seq)).astype(np.int32)

    def provider(step):
        x = data[step - 1]
        return x, np.roll(x, -1, 1).astype(np.int32)

    return provider


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with WorkerPool(4, RECIPE, device="cpu", workdir=str(tmp_path_factory.mktemp("pool")),
                    threads=1) as p:
        yield p


def _controller(pool, tmp_path, name, spec=None, slots=SLOTS, fleet=None, **over):
    fleet = fleet if fleet is not None else tchaos.VirtualFleet(slots, pool)
    cfg = ControllerConfig(checkpoint_every=over.pop("checkpoint_every", 4),
                           growback=over.pop("growback", "replay"),
                           detect_every=over.pop("detect_every", 1))
    ctl = ElasticController(pool, over.pop("provider", _batches(16)), str(tmp_path / name),
                            fleet=fleet, slots=slots, spec=spec or TMeshSpec(dp=len(slots)),
                            config=cfg, global_batch=8, seed=0, planner_overrides=HBM, **over)
    return ctl, fleet


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------------
# the acceptance pin: the four-slot scripted schedule, both controllers
# ---------------------------------------------------------------------------


def _jax_scripted(devices8, ck_dir):
    import jax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.mesh import MeshSpec, build_mesh
    from dsml_tpu.runtime import chaos as jchaos
    from dsml_tpu.runtime.controller import ControllerConfig as JConfig
    from dsml_tpu.runtime.controller import ElasticController as JController

    devices = devices8[:4]
    fleet = jchaos.VirtualFleet(devices)
    ctl = JController(GPT2(GPT2Config.tiny()), optax.adam(1e-2), _batches(N_STEPS),
                      checkpoint_dir=ck_dir, fleet=fleet,
                      mesh=build_mesh(MeshSpec(dp=4), devices), spec=MeshSpec(dp=4),
                      config=JConfig(checkpoint_every=4, growback="replay"), global_batch=8,
                      seed=0, planner_overrides=HBM)
    with ctl:
        rep = jchaos.run_chaos_training(ctl, _schedule(jchaos.ChaosEvent, jchaos.ChaosSchedule),
                                        N_STEPS)
    return rep, dict(ctl.losses), jax.tree.map(np.asarray, jax.device_get(ctl.params))


@pytest.fixture(scope="module")
def jax_oracle(devices8, tmp_path_factory):
    """The JAX controller's run, in a thread: XLA compiles outside the GIL,
    and the port's run (below) waits on its worker processes meanwhile."""
    import concurrent.futures

    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(_jax_scripted, devices8, str(tmp_path_factory.mktemp("jax_ck")))
    yield fut
    ex.shutdown()


@pytest.fixture(scope="module")
def jax_scripted(jax_oracle, port_scripted):
    return jax_oracle.result()


@pytest.fixture(scope="module")
def port_scripted(pool, jax_oracle, tmp_path_factory):
    """The port's run (obs on: its counters are read below) and its own
    uninterrupted reference on the same world."""
    tmp = tmp_path_factory.mktemp("port_ck")
    provider = _batches(N_STEPS)
    world = pool.form(SLOTS, TMeshSpec(dp=4), seed=0)
    ref_losses = [world.step(*provider(s)) for s in range(1, N_STEPS + 1)]
    ref_params = tchaos._host_params(world)
    world.leave()
    was = tobs.enabled()
    tobs.enable(forensics=False)
    reg = tobs.get_registry()
    try:
        hist = reg.histogram("controller_recovery_ms", "elastic-controller recovery latency",
                             labels=("stage",))
        kinds = reg.counter("controller_recoveries_total", "controller recovery actions",
                            labels=("kind",))
        redone = reg.counter("controller_redone_steps_total",
                             "steps discarded by a replay grow-back and re-run")

        def read():
            return {"recoveries": {k: kinds.value(kind=k) or 0
                                   for k in ("reconfigure", "grow_replay")},
                    "redone": redone.value() or 0,
                    "samples": {k: hist.summary(stage=k)["count"]
                                for k in ("reconfigure", "grow_replay")}}

        before = read()
        ctl, _ = _controller(pool, tmp, "ck", provider=provider)
        with ctl:
            rep = tchaos.run_chaos_training(
                ctl, _schedule(tchaos.ChaosEvent, tchaos.ChaosSchedule), N_STEPS)
            params = ctl.params
        after = read()
        counters = {"recoveries": {k: after["recoveries"][k] - before["recoveries"][k]
                                   for k in before["recoveries"]},
                    "redone": after["redone"] - before["redone"],
                    "samples": {k: after["samples"][k] - before["samples"][k]
                                for k in before["samples"]}}
    finally:
        if not was:
            tobs.disable()
    return rep, dict(ctl.losses), params, ref_losses, ref_params, counters


def test_scripted_schedule_matches_the_jax_controller(jax_scripted, port_scripted):
    jrep, jlosses, jparams = jax_scripted
    rep, losses, params, _, _, _ = port_scripted
    key = ("kind", "from_width", "to_width", "resume_step", "lost_steps")
    assert [tuple(r[k] for k in key) for r in rep["recoveries"]] == \
        [tuple(r[k] for k in key) for r in jrep["recoveries"]]
    assert [r["kind"] for r in rep["recoveries"]] == ["reconfigure"] * 3 + ["grow_replay"]
    assert rep["steps_completed"] == jrep["steps_completed"] == N_STEPS
    assert rep["redone_steps"] == jrep["redone_steps"] > 0
    assert sorted(losses) == sorted(jlosses) == list(range(1, N_STEPS + 1))
    np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                               [jlosses[s] for s in sorted(jlosses)], rtol=HYBRID_RTOL)
    got, want = _leaves(params), _leaves(jparams)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)


def test_scripted_schedule_is_bit_identical_to_the_uninterrupted_run(port_scripted):
    rep, losses, params, ref_losses, ref_params, _ = port_scripted
    assert tchaos._bit_identical(params, ref_params)
    assert losses[N_STEPS] == ref_losses[-1]
    assert rep["pure_lineage"] and rep["width"] == 4
    assert rep["recovery_p99_ms"] >= rep["recovery_p50_ms"] > 0
    grow = rep["recoveries"][-1]
    assert grow["slots"] == SLOTS and grow["restore_s"] > 0
    assert all(r["pull_s"] > 0 and r["push_s"] > 0 for r in rep["recoveries"][:3])


def test_recoveries_feed_the_obs_counters(port_scripted):
    *_, counters = port_scripted
    assert counters["recoveries"] == {"reconfigure": 3, "grow_replay": 1}
    assert counters["redone"] == 16
    assert counters["samples"] == {"reconfigure": 3, "grow_replay": 1}


# ---------------------------------------------------------------------------
# individual loop legs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kill_at,every,lost", [(5, 2, 0), (7, 4, 2)])
def test_torn_state_falls_back_to_the_checkpoint(pool, tmp_path, kill_at, every, lost):
    """dp = 2 × tp = 2 losing both tp-1 holders (slots 1, 3) tears the
    Megatron-sharded leaves: the controller falls back to the last commit,
    rewinds and replays — lost work counted, no step skipped."""
    ctl, fleet = _controller(pool, tmp_path, "ck", spec=TMeshSpec(dp=2, tp=2),
                             checkpoint_every=every, growback="keep")
    with ctl:
        rep = tchaos.run_chaos_training(
            ctl, tchaos.ChaosSchedule([tchaos.ChaosEvent(kill_at, "kill", (1, 3))]), 8)
    fleet.restore()
    assert rep["steps_completed"] == 8
    fb = [r for r in rep["recoveries"] if r["kind"] == "checkpoint_fallback"]
    assert len(fb) == 1 and fb[0]["lost_steps"] == lost
    assert fb[0]["fallback_reason"].startswith("training state not recoverable from survivors")
    assert fb[0]["resume_step"] == kill_at - lost
    assert rep["redone_steps"] == lost
    assert ctl.spec.n_devices == 2 and np.isfinite(ctl.losses[8])


def test_grow_keep_mode_reshards_without_recompute(pool, tmp_path):
    ctl, fleet = _controller(pool, tmp_path, "ck", growback="keep",
                             provider=_batches(12))
    with ctl:
        rep = tchaos.run_chaos_training(ctl, tchaos.ChaosSchedule([
            tchaos.ChaosEvent(3, "kill", (2,)), tchaos.ChaosEvent(5, "restore", ())]), 12)
    assert rep["steps_completed"] == 12
    assert [r["kind"] for r in rep["recoveries"]] == ["reconfigure", "grow_keep"]
    assert rep["redone_steps"] == 0
    assert ctl.spec.n_devices == 4 and rep["recoveries"][1]["resume_step"] == 9


def test_injected_signal_detected_without_probe(pool, tmp_path):
    ctl, fleet = _controller(pool, tmp_path, "ck", detect_every=10_000, growback="keep",
                             provider=_batches(8))
    with ctl:
        rep = tchaos.run_chaos_training(
            ctl, tchaos.ChaosSchedule([tchaos.ChaosEvent(3, "kill", (3,), inject=True)]), 8)
    fleet.restore()
    assert rep["steps_completed"] == 8
    assert [r["kind"] for r in rep["recoveries"]] == ["reconfigure"]
    assert rep["recoveries"][0]["resume_step"] == 3
    assert rep["recoveries"][0]["lost_devices"] == [3]
    assert np.isfinite(ctl.losses[8])


def test_signal_lost_slot_is_quarantined_from_growback(pool, tmp_path):
    """Slots reported dead by SIGNAL while a static fleet still lists them
    (their workers alive) are never re-adopted at a grow boundary."""
    ctl = ElasticController(pool, _batches(12), str(tmp_path / "ck"),
                            fleet=StaticFleet(SLOTS), slots=SLOTS, spec=TMeshSpec(dp=4),
                            config=ControllerConfig(checkpoint_every=4, growback="keep"),
                            global_batch=8, seed=0, planner_overrides=HBM)
    with ctl:
        def on_step(step):
            if step == 3 and not ctl.recoveries:
                ctl.inject(DeviceLost([2, 3], "signal-only loss"))

        rep = ctl.run(12, on_step=on_step)
    assert rep["steps_completed"] == 12
    assert [r["kind"] for r in rep["recoveries"]] == ["reconfigure"]
    assert ctl.spec.n_devices == 2 and not {2, 3} & set(ctl.world.slots)
    assert pool.is_alive(2) and pool.is_alive(3)


def test_mid_step_kill_recovers_within_30s(pool, tmp_path):
    """A rank SIGKILLs itself after its backward, before the gradient sync:
    DeviceLost surfaces, the same step index is retried on the survivor,
    and the run completes."""
    ctl, fleet = _controller(pool, tmp_path, "ck", slots=[0, 1], checkpoint_every=100,
                             growback="keep", provider=_batches(4))
    ctl.kill_mid_step(2, 1)
    with ctl:
        rep = ctl.run(3)
    pool.restore(1)
    rec = rep["recoveries"][0]
    assert rec["kind"] == "reconfigure" and rec["mid_step"] == 2 and rec["resume_step"] == 2
    assert rec["surfaced_s"] < 30 and rec["lost_devices"] == [1]
    assert rep["steps_completed"] == 3 and sorted(ctl.losses) == [1, 2, 3]


def test_coordinator_failure_feed_drives_a_recovery(pool, tmp_path):
    """The controller's failure_feed wired from the port's live
    CoordinatorRuntime over real gRPC device servers: a server's death
    verdict arrives as a DeviceLost for that slot, and the run shrinks and
    completes."""
    import time

    from dsml_tpu_torch.comm.coordinator import CoordinatorConfig, CoordinatorRuntime
    from dsml_tpu_torch.comm.device_server import serve_local_devices
    from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

    handles = serve_local_devices(2, base_device_id=0, mem_size=0x4000, device="cpu")
    rt = CoordinatorRuntime(CoordinatorConfig(health_interval_s=0.1, probe_timeout_s=0.5,
                                              dial_retries=2, dial_backoff_s=0.05))
    try:
        rt.comm_init(2, [h.address for h in handles])
        ctl = ElasticController(pool, _batches(12), str(tmp_path / "ck"),
                                fleet=StaticFleet([0, 1]), slots=[0, 1], spec=TMeshSpec(dp=2),
                                config=ControllerConfig(checkpoint_every=4, detect_every=10_000),
                                global_batch=8, seed=0, failure_feed=rt.failure_feed(),
                                planner_overrides=HBM)
        killed = {"done": False}

        def on_step(step):
            if step == 4 and not killed["done"]:
                killed["done"] = True
                handles[1].stop()
                deadline = time.time() + 15.0
                while time.time() < deadline and rt.comms[1].status != pb.FAILED:
                    time.sleep(0.05)
                assert rt.comms[1].status == pb.FAILED, "health loop never failed the comm"

        with ctl:
            rep = ctl.run(12, on_step=on_step)
    finally:
        rt.stop()
        for h in handles:
            h.stop()
    assert rep["steps_completed"] == 12
    shrink = rep["recoveries"][0]
    assert shrink["kind"] == "reconfigure" and shrink["to_width"] == 1
    assert shrink["lost_devices"] == [1]


def test_fail_fast_policy_reraises(pool, tmp_path):
    from dsml_tpu_torch.parallel.elastic import ElasticPolicy

    ctl, fleet = _controller(pool, tmp_path, "ck", slots=[0, 1], provider=_batches(4),
                             policy=ElasticPolicy(allow_shrink=False))
    try:
        with pytest.raises(RuntimeError, match="allow_shrink=False"):
            tchaos.run_chaos_training(
                ctl, tchaos.ChaosSchedule([tchaos.ChaosEvent(2, "kill", (1,))]), 3)
    finally:
        ctl.close()
        fleet.restore()


def test_a_worker_fault_in_a_recovery_propagates(pool, tmp_path, monkeypatch):
    """A command that fails in a live worker during the re-plan (a CUDA
    OOM, a fault in ``load``) is no torn state: it propagates, and the
    controller does not fall back to the checkpoint it has."""
    from dsml_tpu_torch.parallel import elastic
    from dsml_tpu_torch.parallel.world import WorkerError

    def failing(*args, **kwargs):
        raise WorkerError("slot 0: RuntimeError: CUDA out of memory")

    monkeypatch.setattr(elastic, "reconfigure", failing)
    ctl, fleet = _controller(pool, tmp_path, "ck", slots=[0, 1], provider=_batches(4),
                             checkpoint_every=1)
    try:
        with pytest.raises(WorkerError, match="out of memory"):
            tchaos.run_chaos_training(
                ctl, tchaos.ChaosSchedule([tchaos.ChaosEvent(3, "kill", (1,))]), 4)
        assert ctl.recoveries == []
    finally:
        ctl.close()
        fleet.restore()


def test_manager_lineage_predicate_delete_and_uncommitted(tmp_path):
    """The CheckpointManager hooks the replay grow-back rides, as the JAX
    manager's: ``latest_step(where=)`` over the manifest's meta,
    ``delete_steps`` pruning, and an uncommitted save invisible."""
    import os

    import torch

    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.checkpoint import native

    with CheckpointManager(str(tmp_path / "m"), max_to_keep=None) as m:
        for step, lineage in ((1, "pure"), (2, "pure"), (3, "mixed")):
            m.save(step, {"w": torch.full((2,), float(step))}, meta={"lineage": lineage})
        os.makedirs(os.path.join(m.directory, native._TMP_PREFIX + native.step_dirname(4)))
        assert m.all_steps() == [1, 2, 3]
        assert m.latest_step() == 3
        assert m.latest_step(where=lambda meta: meta.get("lineage") == "pure") == 2
        assert m.latest_step(where=lambda meta: False) is None
        assert m.delete_steps([2, 3]) == 2
        assert m.all_steps() == [1]
