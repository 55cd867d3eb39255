"""The observability hooks of the port's batcher, dp and hybrid steps and
``Trainer`` against the JAX package's on the same inputs, on the CPU:

- a tiny GPT-2 paged drain with preemption and a registered prefix through
  both batchers with obs on: the serving counters, the slot-occupancy
  histogram, the pool gauges, ``memory_pressure()`` tick by tick (the
  page fraction on both CPUs), the flight-recorder events in order and the
  ledger's ``kv_pages`` / ``weights_quant`` sources, byte for byte;
- the dp step at n = 2 over gloo against the JAX dp step on two virtual
  devices: the sync plan's counters and the quantized wire bytes;
  ``collective_sync_compiles_total`` counts compilations, not steps;
- the hybrid step: one watermark a step, the plan once, the claims;
- the ``Trainer``: the same loss syncs and parameter claim as the JAX
  trainer, the optimizer claims' stated difference;
- with obs on, greedy tokens and losses are bitwise the obs-off ones.

Every test points ``DSML_POSTMORTEM_DIR`` at ``tmp_path`` and turns both
packages' observability off afterwards."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu import obs as jobs
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.models.mlp import MLP as JaxMLP
from dsml_tpu.serving import ContinuousBatcher as JaxBatcher
from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
from dsml_tpu.trainer import Trainer as JaxTrainer
from dsml_tpu.utils import data as jdata
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.dp import make_dp_train_step
from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, data_mesh
from dsml_tpu_torch.serving import ContinuousBatcher
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata

# a pool too small for three slots of these requests: admissions wait for
# pages and decode growth evicts (recompute at the first token, swap later)
PAGED = dict(n_slots=3, prefill_chunk=8, paged_kv="int4", page_size=8, n_pages=12,
             preemption=True)
DP_CASES = (("ring", False), ("q8_ring2", True), ("q8", False))  # (algorithm, error feedback)
DP_BUCKET_MB = 1e-3  # ~1 KiB buckets: several a sync on the MLP
DP_STEPS = 3


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    yield
    _reset()


def _reset():
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.get_registry().reset()
        pkg.get_flight_recorder().clear()
        pkg.get_tracer().reset()
        pkg.get_memory_ledger().clear()


def _enable_both():
    _reset()
    for pkg in (jobs, tobs):
        pkg.enable(forensics=False)


LATENCIES = ("serving_admission_ms", "span_ms")  # histograms of a run's own times


def _series(pkg, prefix):
    """{(name, labels): what a run must reproduce} for the metrics named
    ``prefix*``: values of counters and gauges, bucket counts of
    histograms, and only the sample count of a latency histogram."""
    out = {}
    for rec in pkg.get_registry().collect():
        if not rec["name"].startswith(prefix):
            continue
        key = (rec["name"], tuple(sorted(rec["labels"].items())))
        if rec["type"] != "histogram":
            out[key] = rec["value"]
        else:
            out[key] = rec["count"] if rec["name"] in LATENCIES else rec["buckets"]
    return out


def _events(pkg, masked=("seq", "t", "ms", "admission_ms", "e2e_ms")):
    return [{k: v for k, v in e.items() if k not in masked}
            for e in pkg.get_flight_recorder().events()]


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def _tiny_models(seed=11):
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config.tiny())
    jparams = jmodel.init(seed)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _workload(vocab):
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, vocab, 20).astype(np.int64)  # 2 full pages + a straddle
    # the others end on a page boundary: their first decode needs a page, so
    # one is evicted at its first token (recompute) and one later (swap)
    prompts = [np.concatenate([prefix, rng.integers(1, vocab, 7)]) if i % 2 == 0
               else rng.integers(1, vocab, 4 * (i + 1)) for i in range(7)]
    budgets = [12, 9, 14, 6, 11, 8, 10]
    return prefix, prompts, budgets


def _serve(srv, vocab, cast, pressures=None):
    """Register the prefix, submit three requests, two ticks, four more,
    drain; ``pressures`` collects memory_pressure() after every tick."""
    prefix, prompts, budgets = _workload(vocab)
    srv.register_prefix(cast(prefix))
    rids = [srv.submit(cast(p), n) for p, n in zip(prompts[:3], budgets[:3])]
    done = {}
    for _ in range(2):
        done.update(srv.step())
        if pressures is not None:
            pressures.append(srv.memory_pressure())
    rids += [srv.submit(cast(p), n) for p, n in zip(prompts[3:], budgets[3:])]
    while srv.n_queued or srv.n_active or srv.n_pending or srv.n_preempted:
        srv.step()
        if pressures is not None:
            pressures.append(srv.memory_pressure())
    out = srv.collect()
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture
def jax_preempt_event(monkeypatch):
    """The JAX batcher records its evictions as ``record("serving_preempt",
    ..., kind=kind)``, which collides with ``record``'s own ``kind`` and
    raises TypeError whenever obs is on (``dsml_tpu/serving/batcher.py``,
    ``_evict_slot``; ROADMAP.md queue 3, reference caveats). The JAX
    package stays as it is: this shim of its module-level ``record`` passes
    the eviction's kind on as ``preempt_kind``, the field the port writes."""
    from dsml_tpu.obs import flight_recorder as jflight

    def record(_kind, **fields):
        if "kind" in fields:
            fields["preempt_kind"] = fields.pop("kind")
        jflight.get_flight_recorder().record(_kind, **fields)

    monkeypatch.setattr(jflight, "record", record)


def test_paged_batcher_metrics_events_and_ledger_equal_jax(jax_preempt_event):
    jmodel, jparams, tmodel = _tiny_models()
    vocab = tmodel.config.vocab_size
    _enable_both()
    runs = []
    for pkg, srv, cast in ((jobs, JaxBatcher(jmodel, jparams, **PAGED), lambda p: p.astype(np.int32)),
                           (tobs, ContinuousBatcher(tmodel, **PAGED), lambda p: p)):
        pkg.get_flight_recorder().clear()
        pressures = []
        tokens = _serve(srv, vocab, cast, pressures)
        ledger = pkg.get_memory_ledger().claimed()
        text = pkg.get_registry().to_prometheus_text()  # runs the pool's collect hook
        runs.append({"tokens": [len(t) for t in tokens], "series": _series(pkg, "serving_"),
                     "pressures": pressures, "events": _events(pkg),
                     "kv_pages": ledger["kv_pages"],
                     # from the trace's events: the tracer's span_ms histogram
                     # outlives a registry reset, and with it earlier tests' ticks
                     "ticks": sum(e["ph"] == "B" and e["name"] == "decode_tick"
                                  for e in pkg.get_tracer().chrome_trace()["traceEvents"]),
                     "counters": (srv.n_preemptions, srv.n_swap_evictions, srv.n_cow_copies),
                     "has_hbm": 'hbm_source{source="claimed"} 1' in text})
    jax_run, port_run = runs
    for key in jax_run:
        assert port_run[key] == jax_run[key], key
    series = port_run["series"]
    labels = (("replica", "0"), ("role", "decode"))
    assert series[("serving_tokens_total", labels)] == sum(_workload(vocab)[2])
    assert series[("serving_page_wait_total", labels)] > 0
    assert series[("serving_cow_copies_total", labels)] > 0
    kinds = {k[1][0][1] for k in series if k[0] == "serving_preemptions_total"}
    assert kinds == {"recompute", "swap"}, kinds
    assert series[("serving_admission_ms", labels)] == 7
    assert [e["kind"] for e in port_run["events"]].count("serving_retire") == 7
    assert {"serving_preempt", "serving_resume", "span"} <= {e["kind"] for e in port_run["events"]}
    assert set(port_run["kv_pages"]) == {"live", "shared", "free", "scratch"}
    assert port_run["has_hbm"]  # the ledger's provenance on a CPU run


def test_weight_quant_ledger_source_equals_jax(monkeypatch):
    monkeypatch.setenv("DSML_QBLOCK", "32")
    jmodel, jparams, tmodel = _tiny_models()
    _enable_both()
    jsrv = JaxBatcher(jmodel, jparams, n_slots=2, weight_quant="int4")
    tsrv = ContinuousBatcher(tmodel, n_slots=2, weight_quant="int4")
    want = jobs.get_memory_ledger().claimed()["weights_quant"]
    got = tobs.get_memory_ledger().claimed()["weights_quant"]
    assert got == want and set(got) == {"packed", "scales"} and got["packed"] > 0
    del jsrv, tsrv  # the sources die with their batchers
    assert "weights_quant" not in tobs.get_memory_ledger().claimed()


def test_obs_changes_no_token_and_counts_what_it_emits():
    """The same drains with obs off and on: identical tokens (paged with
    preemption, dense speculative); with obs on ``serving_tokens_total`` is
    the tokens emitted and the acceptance gauge is ``accept_ewma``."""
    _, _, tmodel = _tiny_models()
    vocab = tmodel.config.vocab_size
    spec_kw = dict(n_slots=2, prefill_chunk=8, speculative_window=3)
    prompts = [np.tile(np.arange(1, 9), 3), np.tile(np.arange(20, 26), 4)]
    results = []
    for on in (False, True):
        _reset()
        if on:
            tobs.enable(forensics=False)
        paged = _serve(ContinuousBatcher(tmodel, **PAGED), vocab, lambda p: p)
        spec = ContinuousBatcher(tmodel, **spec_kw)
        rids = [spec.submit(p, 12) for p in prompts]
        out = spec.run()
        results.append((paged, [out[r] for r in rids], spec.accept_ewma))
        if on:
            reg = tobs.get_registry()
            labels = {"replica": "0", "role": "decode"}
            emitted = sum(map(len, paged)) + sum(len(out[r]) for r in rids)
            assert reg.counter("serving_tokens_total", labels=("replica", "role")).value(
                **labels) == emitted
            assert reg.gauge("serving_spec_accept_rate", labels=("replica", "role")).value(
                **labels) == spec.accept_ewma is not None
    assert results[1] == results[0]


def test_shed_and_abandon_are_counted_and_recorded():
    _, _, tmodel = _tiny_models()
    tobs.enable(forensics=False)
    srv = ContinuousBatcher(tmodel, n_slots=1, max_queue=1)
    srv.submit(np.arange(1, 6), 4, trace_id="req-a")
    from dsml_tpu_torch.serving import QueueFull

    with pytest.raises(QueueFull):
        srv.submit(np.arange(1, 6), 4)
    srv.step()
    live = srv.abandon()
    assert [r.trace_id for r in live] == ["req-a"]
    reg = tobs.get_registry()
    assert reg.counter("serving_shed_total", labels=("replica", "role")).value(
        replica="0", role="decode") == 1
    assert _events(tobs)[-1] == {"kind": "serving_abandon", "n_requests": 1}
    admit = next(e for e in _events(tobs) if e["kind"] == "serving_admit")
    assert admit["trace_id"] == "req-a"
    instants = [e for e in tobs.get_tracer().chrome_trace()["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in instants] == ["serving_first_token", "serving_abandon"]
    hist = [r for r in reg.collect() if r["name"] == "serving_admission_ms"][0]
    assert [ex["trace_id"] for ex in hist["exemplars"].values()] == ["req-a"]


# ---------------------------------------------------------------------------
# the dp step at n = 2 (gloo) against the JAX dp step on two devices
# ---------------------------------------------------------------------------


def _mlp_batch():
    data = tdata.synthetic_classification(256, features=32, classes=4, seed=0)
    return data.train_x[:64], data.train_y[:64]


def _dp_rank(rank, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"), "cpu")
    tobs.enable(forensics=False)
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    out = {}
    for alg, ef in DP_CASES:
        tobs.get_registry().reset()
        model = MLP((32, 64, 4), device="cpu").init(0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
        step = make_dp_train_step(model, opt, mesh, alg, bucket_size_mb=DP_BUCKET_MB,
                                  error_feedback=ef)
        for _ in range(DP_STEPS):
            step(x, y)
        out[alg] = {"series": [[list(k), v] for k, v in _series(tobs, "collective_").items()],
                    "wire": step.quant_wire_bytes}
    # the Trainer's error-feedback norm at its loss syncs: its step is captured
    import dsml_tpu_torch.trainer as ttrainer

    steps = []
    build = ttrainer.make_dp_train_step
    ttrainer.make_dp_train_step = lambda *a, **k: steps.append(build(*a, **k)) or steps[-1]
    data = tdata.synthetic_classification(256, features=16, classes=4, seed=1)
    Trainer(MLP((16, 32, 4), device="cpu"),
            TrainConfig(algorithm="q8_ring2", error_feedback=True, epochs=1, batch_size=32,
                        lr=0.05, sync_every=1), mesh=mesh).train(data)
    out["ef_norm"] = tobs.get_registry().gauge("quant_error_feedback_norm").value()
    out["ef_norm_recomputed"] = ttrainer._global_norm(steps[0].error_feedback)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_dp")
    mp.spawn(_dp_rank, args=(str(tmp),), nprocs=2, join=True)
    return [json.load(open(tmp / f"rank{r}.json")) for r in range(2)]


def _as_series(pairs):
    return {(k[0], tuple(tuple(kv) for kv in k[1])): v for k, v in pairs}


def _placed(tree, mesh):
    """``tree`` replicated over ``mesh`` as the jitted step returns it: jit
    keys its cache on input placement too, so host-side first inputs would
    trace a second time on the step's own outputs (a placement the port's
    tensors do not have)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    return jax.device_put(tree, NamedSharding(mesh, P()))


def test_dp_sync_plan_and_wire_bytes_equal_jax_at_n2(dp_port, devices8):
    from dsml_tpu.parallel.bucketing import init_error_feedback
    from dsml_tpu.parallel.dp import make_dp_train_step as jax_dp_step
    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh

    mesh = jax_data_mesh(devices=devices8[:2])
    jmlp = JaxMLP((32, 64, 4))
    x, y = (jnp.asarray(a) for a in _mlp_batch())
    _enable_both()
    for alg, ef in DP_CASES:
        jobs.get_registry().reset()
        opt = optax.adamw(1e-2, weight_decay=1e-4)
        params = _placed(jmlp.init(0), mesh)
        state = [params, _placed(opt.init(params), mesh)]
        if ef:
            state.append(init_error_feedback(params, mesh, "dp"))
        step = jax_dp_step(jmlp.loss, opt, mesh, alg, bucket_size_mb=DP_BUCKET_MB,
                           error_feedback=ef)
        for _ in range(DP_STEPS):
            state = list(step(*state, x, y))[:-1]
        want = _series(jobs, "collective_")
        for rank in dp_port:
            assert _as_series(rank[alg]["series"]) == want, alg
        labels = (("algorithm", alg), ("axis", "dp"))
        assert want[("collective_sync_compiles_total", labels)] == 1  # compilations, not steps
        assert want[("collective_sync_buckets", labels)] > 1
        quant = {k[1][2][1]: v for k, v in want.items()
                 if k[0] == "collective_quant_bytes_total"}
        assert quant == {s: DP_STEPS * b for s, b in dp_port[0][alg]["wire"].items()}
        assert bool(quant) == (alg != "ring")


def test_trainer_error_feedback_norm_gauge_at_loss_syncs(dp_port):
    for rank in dp_port:
        assert rank["ef_norm"] == rank["ef_norm_recomputed"] > 0


def test_plans_count_compilations_not_steps(devices8):
    """Three steps of one batch shape are one compilation; a new shape is
    another: the JAX dp step (jit's cache) and the port's (its signature
    set) count the same."""
    from dsml_tpu.parallel.dp import make_dp_train_step as jax_dp_step
    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh

    data = tdata.synthetic_classification(256, features=32, classes=4, seed=0)
    batches = [(data.train_x[:64], data.train_y[:64])] * 3 + [(data.train_x[:32],
                                                               data.train_y[:32])]
    _enable_both()
    jmlp = JaxMLP((32, 64, 4))
    opt = optax.sgd(0.1)
    mesh = jax_data_mesh(devices=devices8[:1])
    params = _placed(jmlp.init(0), mesh)
    jstate = [params, _placed(opt.init(params), mesh)]
    jstep = jax_dp_step(jmlp.loss, opt, mesh, "ring", bucket_size_mb=None)
    model = MLP((32, 64, 4), device="cpu").init(0)
    tstep = make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), None, "ring",
                               bucket_size_mb=None)
    counts = []
    for x, y in batches:
        jstate = list(jstep(*jstate, jnp.asarray(x), jnp.asarray(y)))[:-1]
        tstep(x, y)
        counts.append([pkg.get_registry().counter(
            "collective_sync_compiles_total", labels=("algorithm", "axis")).value(
            algorithm="ring", axis="dp") for pkg in (jobs, tobs)])
    assert counts == [[1, 1], [1, 1], [1, 1], [2, 2]]
    assert _series(tobs, "collective_") == _series(jobs, "collective_")
    kinds = [e["kind"] for e in _events(tobs)]
    assert kinds == [e["kind"] for e in _events(jobs)] == ["train_step_build"] + [
        "collective_plan"] * 2


def test_xla_sync_records_the_build_but_no_plan():
    tobs.enable(forensics=False)
    model = MLP((8, 4), device="cpu").init(0)
    step = make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), None, "xla")
    for _ in range(2):
        step(torch.zeros(4, 8), torch.zeros(4, dtype=torch.long))
    assert _events(tobs) == [{"kind": "train_step_build", "algorithm": "xla", "axis": "dp",
                              "bucket_mb": 4.0, "devices": 1, "error_feedback": False}]
    assert _series(tobs, "collective_") == {}


# ---------------------------------------------------------------------------
# the hybrid step
# ---------------------------------------------------------------------------


def _hybrid_losses(on, steps=3):
    _reset()
    if on:
        tobs.enable(forensics=False)
    cfg = dataclasses.replace(tgpt2.GPT2Config.tiny(), n_layer=2)
    model = tgpt2.GPT2(cfg, device="cpu").init(0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    mesh = Mesh(MeshSpec(dp=1).resolved(1), 0, torch.device("cpu"), {})
    step = thybrid.make_hybrid_train_step(model, opt, mesh, dp_sync="ring", bucket_size_mb=0.05)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))
    y = torch.roll(x, -1, 1)
    return [float(step(x, y)) for _ in range(steps)], model, opt


def test_hybrid_step_watermarks_plan_and_claims():
    off, _, _ = _hybrid_losses(False)
    on, model, opt = _hybrid_losses(True)
    assert on == off  # bitwise: the hooks change no loss
    ledger = tobs.get_memory_ledger()
    marks = ledger.watermarks()
    assert len(marks) == 3 and {m["source"] for m in marks} == {"claimed"}
    params = sum(p.numel() * 4 for p in model.parameters())
    claimed = ledger.claimed()
    assert claimed["params"] == {"hybrid": params}
    # torch.optim.AdamW: exp_avg and exp_avg_sq per parameter plus a
    # scalar f32 step per parameter (on the CPU: counted on a CPU run)
    assert claimed["optimizer"] == {"hybrid": 2 * params + 4 * len(opt.state)}
    assert marks[-1]["peak_bytes"] == 3 * params + 4 * len(opt.state)
    reg = tobs.get_registry()
    assert reg.counter("collective_sync_compiles_total", labels=("algorithm", "axis")).value(
        algorithm="ring", axis="dp") == 1
    assert reg.gauge("hbm_step_peak_bytes", labels=("source",)).value(source="claimed") == \
        marks[-1]["peak_bytes"]


def test_hybrid_plan_equals_the_jax_hybrid_step(devices8):
    """The JAX hybrid step with an explicit dp_sync on a one-device mesh
    records the same plan as the port's hybrid step on the same model."""
    from dsml_tpu.parallel.hybrid import init_hybrid, make_hybrid_train_step
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh

    cfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), n_layer=2)
    jmodel = jgpt2.GPT2(cfg)
    _enable_both()
    mesh = jax_build_mesh(JaxMeshSpec(dp=1), devices8[:1])
    opt = optax.adamw(1e-3, weight_decay=0.01)
    p, o = init_hybrid(jmodel, opt, mesh, seed=0)
    jclaims = jobs.get_memory_ledger().claimed()
    step = make_hybrid_train_step(jmodel, opt, mesh, dp_sync="ring", bucket_size_mb=0.05)
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    for _ in range(2):
        p, o, _ = step(p, o, jnp.asarray(x), jnp.asarray(np.roll(x, -1, 1)))
    want = _series(jobs, "collective_")
    jmarks = len(jobs.get_memory_ledger().watermarks())
    _, model, topt = _hybrid_losses(True, steps=2)
    assert _series(tobs, "collective_") == want
    assert len(tobs.get_memory_ledger().watermarks()) == jmarks == 2
    tclaims = tobs.get_memory_ledger().claimed()
    assert tclaims["params"] == jclaims["params"]
    # optax's adamw state: one int32 count per counting transform plus mu
    # and nu; torch's: exp_avg, exp_avg_sq and an f32 step per parameter
    n_counts = (jclaims["optimizer"]["hybrid"] - 2 * jclaims["params"]["hybrid"]) / 4
    assert tclaims["optimizer"]["hybrid"] - jclaims["optimizer"]["hybrid"] == \
        4 * (len(topt.state) - n_counts)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


def test_trainer_syncs_claims_and_events_equal_jax():
    data = jdata.synthetic_classification(900, 32, 10, seed=3)
    jmlp = JaxMLP((32, 64, 10))
    jparams = jmlp.init(0)
    kw = dict(epochs=2, batch_size=64, lr=0.05, optimizer="adamw", lr_schedule="cosine",
              warmup_steps=3, seed=1, sync_every=4)
    _enable_both()
    JaxTrainer(jmlp, JaxTrainConfig(dp=1, **kw)).train(data, jparams)
    tdata_ = tdata.synthetic_classification(900, 32, 10, seed=3)
    start = params_from_jax(jax.tree.map(np.asarray, jparams))
    trainer = Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(**kw))
    state_on, hist_on, _ = trainer.train(tdata_, start)
    jev, tev = _events(jobs, masked=("seq", "t", "wall_ms")), _events(tobs, masked=("seq", "t",
                                                                                     "wall_ms"))
    assert [e["kind"] for e in tev] == [e["kind"] for e in jev]
    jsync = [e for e in jev if e["kind"] == "loss_sync"]
    tsync = [e for e in tev if e["kind"] == "loss_sync"]
    assert [(e["step"], e["epoch"]) for e in tsync] == [(e["step"], e["epoch"]) for e in jsync]
    assert len(tsync) == 2 * (810 // 64 // 4)
    # f32 on both sides (the train tests' tolerance)
    np.testing.assert_allclose([e["loss"] for e in tsync], [e["loss"] for e in jsync],
                               rtol=1e-4, atol=1e-6)
    jclaims, tclaims = (pkg.get_memory_ledger().claimed() for pkg in (jobs, tobs))
    assert tclaims["params"] == jclaims["params"] == {"total": 4 * (32 * 64 + 64 + 64 * 10 + 10)}
    params = jclaims["params"]["total"]
    n_counts = (jclaims["optimizer"]["total"] - 2 * params) / 4
    assert tclaims["optimizer"]["total"] == 2 * params + 4 * 4  # 4 parameters, an f32 step each
    assert tclaims["optimizer"]["total"] - jclaims["optimizer"]["total"] == 4 * (4 - n_counts)
    marks = tobs.get_memory_ledger().watermarks()
    assert [m["step"] for m in marks] == [e["step"] for e in tsync]
    summary = trainer.metrics.records[-1]
    assert summary["obs_step_breakdown"]["steps"] == 2 * (810 // 64)
    assert 0 < summary["obs_goodput"]["goodput"] <= 1
    # obs off: the same losses and weights, bit for bit
    _reset()
    state_off, hist_off, _ = Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(**kw)).train(
        tdata_, start)
    def epochs(hist):
        return [(h["epoch"], h["avg_loss"], h["train_accuracy"]) for h in hist]

    assert epochs(hist_off) == epochs(hist_on)
    assert all(torch.equal(state_on[k], state_off[k]) for k in state_on)
    assert _events(tobs) == []
