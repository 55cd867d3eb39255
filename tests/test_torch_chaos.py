"""The port's fault injection (``dsml_tpu_torch/runtime/chaos.py``) and its
serving fleet under chaos (``runtime/controller.py::DecodeFleet``) against
the JAX package's ``runtime/chaos.py`` and ``runtime/controller.py``, on the
CPU: the schedules, the replica-loss drains, the disaggregated fleet's
verdicts, the two-host migration legs, and the chaos smoke on eight CPU
rank slots."""

import dataclasses

import numpy as np
import pytest

from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec
from dsml_tpu_torch.parallel.world import TrainRecipe, WorkerPool
from dsml_tpu_torch.runtime import chaos as tchaos
from dsml_tpu_torch.runtime.controller import (ControllerConfig, DecodeFleet, DeviceLost,
                                               ElasticController)
from dsml_tpu_torch.serving import ContinuousBatcher

RECIPE = TrainRecipe(tgpt2.GPT2Config.tiny(), lr=1e-2)
HBM = {"hbm_bytes": 16e9}


def _events(schedule):
    return [dataclasses.asdict(e) for e in schedule.events]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 8])
def test_schedules_match_jax(n):
    from dsml_tpu.runtime import chaos as jchaos

    assert _events(tchaos.ChaosSchedule.scripted_default(n)) == \
        _events(jchaos.ChaosSchedule.scripted_default(n))
    for seed in range(10):
        got = tchaos.ChaosSchedule.seeded(seed, n_steps=24, n_devices=n)
        want = jchaos.ChaosSchedule.seeded(seed, n_steps=24, n_devices=n)
        assert _events(got) == _events(want)
        assert got.kills() == want.kills() and got.at(want.events[0].step)


def test_config_from_env_parses_and_raises_as_jax(monkeypatch):
    from dsml_tpu.runtime import chaos as jchaos

    for spec in ("", "0", "off", "1", "scripted", "seed:5"):
        got, want = tchaos.config_from_env(spec), jchaos.config_from_env(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert _events(got) == _events(want)
    for bad in ("bogus", "seed:x"):
        with pytest.raises(ValueError, match="DSML_CHAOS"):
            tchaos.config_from_env(bad)
        with pytest.raises(ValueError, match="DSML_CHAOS"):
            jchaos.config_from_env(bad)
    monkeypatch.setenv("DSML_CHAOS", "seed:3")
    assert _events(tchaos.config_from_env()) == _events(tchaos.ChaosSchedule.seeded(3))
    with pytest.raises(ValueError, match="unknown chaos action"):
        tchaos.ChaosEvent(1, "explode")


# ---------------------------------------------------------------------------
# DecodeFleet under chaos (f32 greedy)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """GPT-2-tiny in both packages, seed 0's weights."""
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config

    jmodel = GPT2(GPT2Config.tiny())
    return tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(0), jmodel, jmodel.init(0)


def _prompts(cfg, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, rng.integers(3, 9)).astype(np.int32)
            for _ in range(n)]


def test_decode_fleet_replica_kill_loses_no_tokens(models):
    """A replica dies mid-drain: its requests re-run on the survivor; every
    request's tokens equal the port's single batcher's and the JAX fleet's
    on the same prompts."""
    from dsml_tpu.runtime import chaos as jchaos
    from dsml_tpu.runtime.controller import DecodeFleet as JFleet
    from dsml_tpu.serving import ContinuousBatcher as JBatcher

    model, jmodel, jparams = models
    prompts = _prompts(model.config)
    ref = ContinuousBatcher(model, n_slots=2)
    ref_rids = [ref.submit(p, 6) for p in prompts]
    ref_tokens = ref.run()
    fleet = DecodeFleet(lambda: ContinuousBatcher(model, n_slots=2, max_queue=8),
                        min_replicas=2, max_replicas=2, scale_down_idle_ticks=10_000)
    out = tchaos.run_chaos_serving(fleet, prompts, 6, kill_ticks={2: None})
    jfleet = JFleet(lambda: JBatcher(jmodel, jparams, n_slots=2, max_queue=8),
                    min_replicas=2, max_replicas=2, scale_down_idle_ticks=10_000)
    jout = jchaos.run_chaos_serving(jfleet, prompts, 6, kill_ticks={2: None})
    assert any(e.get("reason") == "killed" and e.get("requeued", 0) > 0
               for e in fleet.scale_events)
    got = [out["results"][f] for f in sorted(out["results"])]
    assert got == [ref_tokens[r] for r in ref_rids]
    assert got == [jout["results"][f] for f in sorted(jout["results"])]
    assert out["ticks"] == jout["ticks"]
    assert fleet.scale_events == jfleet.scale_events


def test_decode_fleet_autoscale_events_match_jax(models):
    """Queue depth drives the replica count both ways, event for event as
    the JAX fleet's."""
    from dsml_tpu.runtime.controller import DecodeFleet as JFleet
    from dsml_tpu.serving import ContinuousBatcher as JBatcher

    model, jmodel, jparams = models
    kw = dict(min_replicas=1, max_replicas=3, scale_up_queue_depth=1, scale_down_idle_ticks=2)
    fleets = [DecodeFleet(lambda: ContinuousBatcher(model, n_slots=1, max_queue=2), **kw),
              JFleet(lambda: JBatcher(jmodel, jparams, n_slots=1, max_queue=2), **kw)]
    results = []
    for fleet in fleets:
        for p in _prompts(model.config, n=9):
            fleet.submit(p, 4)
        results.append(fleet.run())
        for _ in range(10):
            fleet.tick()
        assert fleet.n_replicas == 1
    assert fleets[0].scale_events == fleets[1].scale_events
    assert max(e["n_replicas"] for e in fleets[0].scale_events) == 3
    assert results[0] == results[1]


def test_decode_fleet_metrics_are_labeled_per_replica(models):
    model = models[0]
    was = tobs.enabled()
    tobs.enable(forensics=False)
    try:
        reg = tobs.get_registry()
        tokens = reg.counter("serving_tokens_total", "tokens emitted", labels=("replica", "role"))
        before = {r: tokens.value(replica=r, role="decode") or 0 for r in ("0", "1")}
        fleet = DecodeFleet(lambda: ContinuousBatcher(model, n_slots=2, max_queue=8),
                            min_replicas=2, max_replicas=2, scale_down_idle_ticks=10_000)
        assert [b.obs_replica for b in fleet._replicas.values()] == ["0", "1"]
        for p in _prompts(model.config):
            fleet.submit(p, 4)
        fleet.run()
        emitted = {r: (tokens.value(replica=r, role="decode") or 0) - before[r]
                   for r in ("0", "1")}
        assert emitted["0"] > 0 and emitted["1"] > 0 and sum(emitted.values()) == 6 * 4
    finally:
        if not was:
            tobs.disable()


class _PoolReplica:
    """Zero-compute replica that records the devices it was handed."""

    n_slots = 2
    n_active = 0
    n_pending = 0

    def __init__(self, devices):
        self.devices = tuple(devices)
        self._queue, self._done, self._next = [], {}, 0
        self.obs_replica = "0"

    @property
    def n_queued(self):
        return len(self._queue)

    def submit(self, prompt, max_new):
        rid = self._next
        self._next += 1
        self._queue.append((rid, list(np.asarray(prompt))))
        return rid

    def step(self):
        if self._queue:
            rid, toks = self._queue.pop(0)
            self._done[rid] = toks

    def collect(self):
        out, self._done = self._done, {}
        return out

    def abandon(self):
        out = [type("Req", (), {"rid": rid})() for rid, _ in self._queue]
        self._queue = []
        return out


def test_decode_fleet_device_pool_assignment_return_and_failed_factory():
    spans = []

    def make(devices):
        replica = _PoolReplica(devices)
        spans.append(replica.devices)
        return replica

    fleet = DecodeFleet(make, min_replicas=2, max_replicas=8, devices=list(range(6)),
                        devices_per_replica=2, scale_down_idle_ticks=10_000)
    assert fleet.max_replicas == 3 and fleet.n_replicas == 2  # capacity caps the max
    assert not set(spans[0]) & set(spans[1]) and all(len(s) == 2 for s in spans)
    killed_span = fleet._replica_devices[0]
    fleet.submit([1, 2, 3], 4)
    fleet.kill_replica(0)
    assert set(killed_span) <= set(fleet._device_pool)
    fleet.tick()
    assert list(fleet.run().values()) == [[1, 2, 3]]

    def boom(devices):
        raise RuntimeError("factory OOM")

    free = len(fleet._device_pool)
    fleet._make = boom
    with pytest.raises(RuntimeError, match="factory OOM"):
        fleet._spawn("scale_up")
    assert len(fleet._device_pool) == free  # the span came back
    fleet._make = make
    assert len(fleet._replica_devices[fleet._spawn("retry")]) == 2


def test_decode_fleet_pool_validates_capacity():
    with pytest.raises(ValueError, match="cannot back"):
        DecodeFleet(_PoolReplica, min_replicas=3, devices=list(range(4)), devices_per_replica=2)
    with pytest.raises(ValueError, match="devices_per_replica"):
        DecodeFleet(_PoolReplica, devices=list(range(4)), devices_per_replica=0)
    with pytest.raises(ValueError, match="min_replicas"):
        DecodeFleet(_PoolReplica, min_replicas=0)


def test_serving_fleet_chaos_verdicts_match_jax(models):
    """A 2-prefill / 2-decode fleet loses a prefill worker mid-handoff and a
    decode worker later: the requeue counts, the trace verdicts and the
    tokens are the JAX fleet's."""
    from dsml_tpu.runtime import chaos as jchaos
    from dsml_tpu.serving import build_fleet as jbuild
    from dsml_tpu_torch.serving import build_fleet

    model, jmodel, jparams = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, model.config.vocab_size, rng.integers(8, 24)).astype(np.int32)
               for _ in range(6)]
    kills = {1: ("prefill", None), 6: ("decode", None)}
    out = tchaos.run_chaos_serving_fleet(
        build_fleet(model, n_prefill=2, n_decode=2, prefill_chunk=8, n_slots=2, max_queue=8),
        prompts, 6, kills)
    jout = jchaos.run_chaos_serving_fleet(
        jbuild(jmodel, jparams, n_prefill=2, n_decode=2, prefill_chunk=8, n_slots=2,
               max_queue=8), prompts, 6, kills)
    got, want = out.pop("results"), jout.pop("results")
    assert out == jout
    assert out["requeued_prefill"] and out["requeued_decode"] and out["trace_requeue_same"]
    assert [got[f] for f in sorted(got)] == [want[f] for f in sorted(want)]


# ---------------------------------------------------------------------------
# migration under the controller (the JAX tests/test_migration.py legs)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with WorkerPool(4, RECIPE, device="cpu", workdir=str(tmp_path_factory.mktemp("pool")),
                    threads=1) as p:
        yield p


def _batch(seed=0):
    cfg = RECIPE.config
    x = np.random.default_rng(seed).integers(0, cfg.vocab_size, (8, cfg.max_seq)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _servers():
    from dsml_tpu_torch.comm.device_server import serve_device

    recv = serve_device(205, mem_size=0x400000, device="cpu")
    donor = serve_device(206, mem_size=0x400000, device="cpu")
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    return recv, donor


def _migrator(recv, donor, **kw):
    from dsml_tpu_torch.comm.migration import MigrationConfig, ShardMigrator

    return ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                         config=MigrationConfig(timeout_s=30.0, **kw),
                         local_address=recv.address)


def test_remote_only_piece_refused_then_migrated(pool):
    """dp = 2 × tp = 2 loses its local tp-1 holder (slot 1) while slots 2, 3
    play another host: without a migrator the shrink refuses (never zero-
    fills); with one the pieces come over the P2P streams and the moved
    state is the pre-failure state bit for bit."""
    from dsml_tpu_torch.parallel import elastic

    world = pool.form([0, 1, 2, 3], TMeshSpec(dp=2, tp=2), seed=0)
    world.step(*_batch())
    host = world.state()
    before = host.tree()
    host.remove()
    with pytest.raises(RuntimeError, match="non-addressable"):
        elastic.reconfigure(world, [0, 2], [1], non_addressable=(2, 3), global_batch=8,
                            planner_overrides=HBM)
    assert world.active
    recv, donor = _servers()
    try:
        donor.runtime.donor.register_state(before["params"], "params")
        donor.runtime.donor.register_state(before["opt_state"], "opt_state")
        mig = _migrator(recv, donor)
        state = elastic.reconfigure(world, [0, 2], [1], non_addressable=(2, 3), migrator=mig,
                                    global_batch=8, planner_overrides=HBM)
        assert mig.stats["pieces"] > 0 and mig.stats["bytes"] > 0
        assert tchaos._bit_identical(state.host_tree(), before)
        state.world.leave()
        mig.close()
    finally:
        recv.stop()
        donor.stop()
        pool.restore(*[s for s in range(4) if not pool.is_alive(s)])


@pytest.mark.parametrize("wire", ["", "corrupt@*"])
def test_controller_orchestrates_migration_and_corrupt_fallback(pool, tmp_path, wire):
    """The controller leg: a shrink whose tp-1 shard survives only remotely
    recovers with kind "reconfigure" and migration stats in its record;
    the same failure over a corrupted link falls back to the checkpoint
    (CRC named in the reason), nothing silently corrupt landing."""
    recv, donor = _servers()
    tchaos.set_wire_fault_plan(tchaos.WireFaultPlan.parse(wire) if wire else None)
    try:
        mig = _migrator(recv, donor, retries=1)
        fleet = tchaos.VirtualFleet([0, 1, 2, 3], pool)
        ctl = ElasticController(
            pool, lambda s: _batch(s), str(tmp_path / "ck"), fleet=fleet, slots=[0, 1, 2, 3],
            spec=TMeshSpec(dp=2, tp=2), config=ControllerConfig(checkpoint_every=2,
                                                               growback="keep"),
            global_batch=8, seed=0, migrator=mig, non_addressable=(2, 3),
            planner_overrides=HBM)

        def on_step(s):
            if s == 3:  # host B's live view at the failure point
                state = ctl.host_state()
                donor.runtime.donor.register_state(state["params"], "params")
                donor.runtime.donor.register_state(state["opt_state"], "opt_state")
                ctl.inject(DeviceLost(fleet.kill(1), "local tp-1 holder"))

        with ctl:
            rep = ctl.run(4, on_step=on_step)
        fleet.restore()
        mig.close()
    finally:
        tchaos.set_wire_fault_plan(None)
        recv.stop()
        donor.stop()
    rec = rep["recoveries"][0]
    assert rep["steps_completed"] == 4
    if not wire:
        assert rec["kind"] == "reconfigure" and rec["lost_steps"] == 0
        assert rec["migrated_bytes"] > 0 and rec["migrated_pieces"] > 0
    else:
        assert rec["kind"] == "checkpoint_fallback" and "CRC" in rec["fallback_reason"]
        assert rec["migration_integrity_failures"] > 0


def test_dropped_push_shorter_than_a_chunk_resumes_from_its_half():
    """A ``drop`` fault truncates a push mid-stream even when the whole
    payload is shorter than one stream chunk (256 KiB): the receiver holds
    the first half and the migrator resumes from there, bit for bit."""
    recv, donor = _servers()
    arr = np.random.default_rng(1).standard_normal((256, 32)).astype(np.float32)  # 32 KiB
    tchaos.set_wire_fault_plan(tchaos.WireFaultPlan.parse("drop@1"))
    try:
        donor.runtime.donor.register_array("a", arr)
        mig = _migrator(recv, donor)
        got = mig.fetch_piece("a", [[0, 256], [0, 32]], "float32")
        assert mig.stats["resumed"] == 1 and mig.stats["retries"] == 0
        np.testing.assert_array_equal(got.numpy(), arr)
        mig.close()
    finally:
        tchaos.set_wire_fault_plan(None)
        recv.stop()
        donor.stop()


# ---------------------------------------------------------------------------
# the smoke
# ---------------------------------------------------------------------------


def test_chaos_smoke_on_cpu_slots_verifies(tmp_path):
    """The acceptance run on eight CPU slots: the scripted schedule (3 kills,
    1 restore), zero lost steps, final params bit-identical to the
    uninterrupted run, goodput above the floor."""
    report = tchaos.run_smoke(n_steps=20, serving=False, device="cpu", threads=1,
                              tmp_dir=str(tmp_path), planner_overrides=HBM)
    assert tchaos.verify(report) == []
    s = report["scripted"]
    kinds = [r["kind"] for r in s["recoveries"]]
    assert kinds.count("reconfigure") >= 3 and "grow_replay" in kinds
    assert s["bit_identical"] and s["steps_completed"] == 20 and s["redone_steps"] > 0
    assert tchaos.verify({"n_steps": 20, "goodput_floor": 0.02,
                          "x": {**s, "bit_identical": False}})
