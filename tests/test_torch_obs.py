"""The port's observability core (``dsml_tpu_torch/obs``) against the JAX
package's (``dsml_tpu/obs``): the same writes into both registries give
the same Prometheus text and JSONL (times masked), the same spans give the
same Chrome trace (times and thread ids masked), the same phases the same
step breakdown and goodput; the memory ledger's torch.cuda mapping,
reconciliation and provenance; the HTTP endpoint; the span fence.

Every test here uses private registries or restores the default ones; the
fixture below points ``DSML_POSTMORTEM_DIR`` at ``tmp_path`` and turns both
packages' observability off afterwards."""

from __future__ import annotations

import json
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import grpc
import numpy as np
import pytest
import torch

from dsml_tpu import obs as jobs
from dsml_tpu.obs import memory as jmemory
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.obs import memory as tmemory
from dsml_tpu_torch.obs import spans as tspans


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.get_registry().reset()
        pkg.get_flight_recorder().clear()
        pkg.get_tracer().reset()
        pkg.get_memory_ledger().clear()


def _write_sequence(pkg, reg):
    """One sequence of writes of every metric kind, labels and exemplars."""
    c = reg.counter("requests_total", "requests", labels=("replica", "role"))
    c.inc(replica="0", role="decode")
    c.inc(3, replica="0", role="decode")
    c.inc(2.5, replica="1", role="prefill")
    bound = c.bind(replica="1", role="prefill")
    for _ in range(4):
        bound.inc()
    g = reg.gauge("queue_depth", "waiting", labels=("replica",))
    g.set(7, replica="0")
    g.set(3.25, replica="0")
    g.set(-1, replica="2")
    reg.gauge("unlabeled", "a bare gauge").set(0.1)
    h = reg.histogram("latency_ms", "latency", labels=("stage",))
    for i, v in enumerate((0.05, 0.3, 0.3, 7.0, 99.0, 2e4, 1.0)):
        h.observe(v, exemplar=f"trace-{i}" if i % 2 else None, stage="decode")
    h.observe(12.0, stage="prefill")
    occ = reg.histogram("occupancy", "slots", labels=("replica",),
                        buckets=(0.125, 0.25, 0.5, 1.0))
    for v in (0.125, 0.2, 1.0, 0.5, 0.51):
        occ.observe(v, replica="0")
    reg.counter("empty_total", "never written", labels=("x",))  # a family with no series
    return h


def _mask_times(records):
    out = []
    for rec in records:
        rec = dict(rec)
        rec.pop("time", None)
        if "exemplars" in rec:
            rec["exemplars"] = {b: {k: v for k, v in ex.items() if k != "time"}
                                for b, ex in rec["exemplars"].items()}
        out.append(rec)
    return out


def test_registry_expositions_equal_jax():
    regs = []
    for pkg in (jobs, tobs):
        reg = pkg.Registry(enabled=True)
        h = _write_sequence(pkg, reg)
        regs.append((reg, h))
    (jreg, jh), (treg, th) = regs
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()
    assert _mask_times([json.loads(line) for line in treg.to_jsonl().splitlines()]) == \
        _mask_times([json.loads(line) for line in jreg.to_jsonl().splitlines()])
    assert th.summary(stage="decode") == jh.summary(stage="decode")
    assert treg.collect()[0]["name"] == "requests_total"


def test_registry_conflicts_and_disabled_writes_match_jax():
    for pkg in (jobs, tobs):
        reg = pkg.Registry(enabled=True)
        reg.histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="already registered with buckets"):
            reg.histogram("h", buckets=(1.0, 3.0))
        with pytest.raises(ValueError, match="already registered as"):
            reg.gauge("h")
        with pytest.raises(ValueError, match="do not match declared"):
            reg.counter("c", labels=("a",)).inc(b=1)
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("c", labels=("a",)).inc(-1, a=1)
        off = pkg.Registry(enabled=False)
        _write_sequence(pkg, off)
        assert off.to_prometheus_text() == "" and off.collect() == []


def test_collect_hooks_are_weak_and_fault_tolerant():
    reg = tobs.Registry(enabled=True)
    calls = []

    class Owner:
        def refresh(self):
            calls.append(1)
            reg.gauge("live").set(len(calls))

    def broken():
        raise RuntimeError("a broken refresher must not break a scrape")

    owner = Owner()
    reg.add_collect_hook(owner.refresh)
    reg.add_collect_hook(broken)
    assert "live 1" in reg.to_prometheus_text()
    del owner
    reg.collect()
    assert calls == [1]


def _span_script(pkg, tracer):
    ctx = pkg.TraceContext(trace_id="abc-1-0001", span_id="root")
    with tracer.span("outer", step=3, label="x"):
        with tracer.span("inner"):
            pass
        tracer.instant("mark", rid=7, ok=True)
        tracer.flow("hop", ctx, phase="start", rid=7)
        with tracer.request_span("req", ctx, flow="step", rid=7):
            pass
        with tracer.request_span("plain", None):
            pass
    tracer.flow("hop", ctx, phase="end")
    with pytest.raises(ValueError, match="flow phase"):
        tracer.flow("hop", ctx, phase="middle")


def _masked_trace(trace):
    return [{k: v for k, v in e.items() if k not in ("ts", "pid", "tid")}
            for e in trace["traceEvents"]]


def test_span_trace_and_summaries_equal_jax():
    traces = []
    for pkg in (jobs, tobs):
        reg = pkg.Registry(enabled=True)
        tracer = pkg.SpanTracer(registry=reg)
        _span_script(pkg, tracer)
        traces.append((tracer, reg))
    (jt, jreg), (tt, treg) = traces
    assert _masked_trace(tt.chrome_trace()) == _masked_trace(jt.chrome_trace())
    assert tt.chrome_trace()["displayTimeUnit"] == "ms"
    assert sorted(tt.summaries()) == sorted(jt.summaries()) == ["inner", "outer", "plain"]
    assert [s["count"] for s in tt.summaries().values()] == [1, 1, 1]
    assert tobs.TraceContext(trace_id="abc-1-0001").flow_id == \
        jobs.TraceContext(trace_id="abc-1-0001").flow_id
    hdr = tobs.TraceContext.mint(span_id="s").to_header()
    assert tobs.TraceContext.from_header(hdr).trace_id == hdr["trace_id"]


def test_span_eviction_drops_orphan_ends(monkeypatch):
    monkeypatch.setattr(tspans, "_EVENT_CAP", 8)
    tracer = tobs.SpanTracer(registry=tobs.Registry(enabled=True))
    with tracer.span("long"):
        for _ in range(6):
            with tracer.span("short"):
                pass
    events = tracer.chrome_trace()["traceEvents"]
    stack = []
    for e in events:
        if e["ph"] == "B":
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack and stack.pop() == e["name"]


def test_span_fence_runs_only_when_enabled(monkeypatch):
    """A disabled span adds no stream synchronisation; an enabled one
    synchronises once, and the fence's tree walk finds every tensor."""
    seen = []
    monkeypatch.setattr(tspans, "synchronize", lambda tree: seen.append(tree))
    t = torch.ones(2)
    for enabled in (False, True):
        tracer = tobs.SpanTracer(registry=tobs.Registry(enabled=enabled))
        with tracer.span("fenced", fence={"a": [t]}):
            pass
        ctx = tobs.TraceContext(trace_id="t")
        with tracer.request_span("req", ctx, fence=t):
            pass
    assert len(seen) == 2
    leaves = list(tmemory.tensor_leaves({"a": [t, (t, None)], "m": torch.nn.Linear(2, 3),
                                         "n": 3}))
    assert len(leaves) == 4  # t, t, the Linear's weight and bias


def test_synchronize_waits_on_each_cuda_device_once(monkeypatch):
    """The fence synchronises the current stream of every CUDA tensor's
    device, once a device, and never for CPU tensors (a fake CUDA tensor
    stands in: this host has no card)."""
    synced = []

    class FakeStream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            synced.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(tspans, "tensor_leaves", lambda tree: iter(tree))
    cuda = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    cpu = types.SimpleNamespace(is_cuda=False, device="cpu")
    tspans.synchronize([cuda, cpu, cuda])
    assert synced == ["cuda:0"]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _step_script(pkg):
    clock = FakeClock()
    reg = pkg.Registry(enabled=True)
    bd = pkg.StepBreakdown(registry=reg, clock=clock)
    gp = pkg.GoodputTracker(registry=reg, clock=clock, carry_s=1.5)
    for i in range(4):
        with bd.step():
            with bd.phase("data"):
                clock.t += 0.001 * (i + 1)
            bd.add("step_dispatch", 0.002)
            with gp.productive():
                clock.t += 0.01
        bd.note_step_wall(0.0005)
    gp.mark("preemption", step=4)
    clock.t += 2.0
    gp.mark("restore", step=4)
    gp.add_productive(0.25)
    return bd.summary(), gp.summary(), reg


def test_step_breakdown_and_goodput_equal_jax():
    (jbd, jgp, jreg), (tbd, tgp, treg) = (_step_script(jobs), _step_script(tobs))
    assert tbd == jbd
    assert tgp == jgp
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()
    assert tobs.mfu(4e14, 989e12) == jobs.mfu(4e14, 989e12)
    assert tobs.mfu(1.0, None) is None and tobs.mfu(1.0, 0) is None
    assert tobs.STEP_PHASES == jobs.STEP_PHASES


def test_metrics_logger_rotation_and_reexport(tmp_path):
    from dsml_tpu_torch.utils import metrics

    assert metrics.MetricsLogger is tobs.MetricsLogger
    path = str(tmp_path / "m.jsonl")
    log = tobs.MetricsLogger(path, max_bytes=200)
    for i in range(10):
        log.log(step=i, loss=1.0 / (i + 1))
    assert (tmp_path / "m.jsonl.1").exists()
    assert (tmp_path / "m.jsonl").stat().st_size <= 200
    assert log.last(step=9)["loss"] == 0.1 and len(log.records) == 10


def test_http_metrics_endpoint_serves_both_expositions():
    reg = tobs.Registry(enabled=True)
    reg.counter("hits_total", "hits").inc(5)
    srv = tobs.start_metrics_server(reg, port=0)
    try:
        text = urllib.request.urlopen(f"{srv.address}/metrics", timeout=10).read().decode()
        assert "hits_total 5" in text
        snap = json.loads(urllib.request.urlopen(f"{srv.address}/metrics.json",
                                                 timeout=10).read())
        assert snap[0]["value"] == 5.0
        # the third route, the cluster snapshot (item 13, ported)
        cluster = json.loads(urllib.request.urlopen(f"{srv.address}/cluster.json",
                                                    timeout=10).read())
        assert cluster["schema"] == "dsml.obs.cluster/1" and cluster["role"]
        assert cluster["metrics"][0]["value"] == 5.0 and "traceEvents" in cluster["trace"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{srv.address}/no_such_route", timeout=10)
        with pytest.raises(tobs.ObsUnavailable, match="cannot bind"):
            tobs.start_metrics_server(reg, port=srv.port)
    finally:
        srv.stop()


def test_unported_cluster_names_raise_naming_item_13():
    """The cluster names (item 13) are ported: each resolves lazily to
    ``obs.cluster``; the gRPC pull is ported too (item 14), and an endpoint
    with nothing behind it is a gRPC error."""
    from dsml_tpu_torch.obs import cluster

    for name in ("ClockSync", "ClusterAggregator", "merge_snapshots", "snapshot",
                 "stitch_traces", "trace_summary"):
        assert getattr(tobs, name) is getattr(cluster, name) and name in tobs.__all__
    with pytest.raises(grpc.RpcError):
        tobs.ClusterAggregator().pull("127.0.0.1:1", timeout=5.0)
    with pytest.raises(AttributeError):
        tobs.no_such_name  # noqa: B018


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------


def test_tree_nbytes_counts_tensors_modules_and_skips_the_rest():
    lin = torch.nn.Linear(4, 3)  # 12 + 3 f32
    tree = {"a": torch.zeros(2, 5, dtype=torch.bfloat16), "b": [torch.zeros(3), (lin, None)],
            "c": "text", "d": 7, "e": np.zeros(9)}
    want = 2 * 5 * 2 + 3 * 4 + 15 * 4
    assert tmemory.tree_nbytes(tree) == want
    # a CPU run: the CPU tensors are the device bytes (as a CPU JAX backend's arrays)
    assert tmemory.tree_nbytes(tree, per_device=True) == want
    # JAX counts the same logical tree the same (numpy leaves aside)
    jtree = {"a": jnp.zeros((2, 5), jnp.bfloat16), "b": [jnp.zeros(3), jnp.zeros((3, 4)),
                                                         jnp.zeros(3)]}
    assert jmemory.tree_nbytes(jtree, per_device=True) == want


def test_tree_nbytes_per_device_counts_only_cuda_tensors_beside_host_ones(monkeypatch):
    """On the card a tree mixes CUDA tensors with host ones (torch.optim's
    per-parameter ``step`` counts stay on the CPU): only the card's bytes
    count, the max over devices. Fake CUDA leaves stand in for the card."""
    def leaf(nbytes, device, is_cuda):
        return types.SimpleNamespace(numel=lambda: nbytes, element_size=lambda: 1,
                                     is_cuda=is_cuda, device=device)

    leaves = [leaf(100, "cuda:0", True), leaf(40, "cuda:1", True), leaf(30, "cuda:0", True),
              leaf(4, torch.device("cpu"), False)]
    monkeypatch.setattr(tmemory, "tensor_leaves", lambda tree: iter(leaves))
    assert tmemory.tree_nbytes(None, per_device=True) == 130
    assert tmemory.tree_nbytes(None) == 174


def _fake_cuda(monkeypatch, stats, total=80 * 2 ** 30):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=total))
    monkeypatch.setattr(tmemory, "_TOTAL_MEMORY", {})


def test_device_stats_map_the_caching_allocator(monkeypatch):
    """allocated current → bytes_in_use, allocated peak → peak_bytes_in_use,
    total_memory → bytes_limit; reserved rides beside, in no gauge."""
    _fake_cuda(monkeypatch, {"allocated_bytes.all.current": 3000,
                             "allocated_bytes.all.peak": 9000,
                             "reserved_bytes.all.current": 20000})
    assert tmemory._device_memory_stats() == [{
        "device": "cuda:0", "bytes_in_use": 3000, "peak_bytes_in_use": 9000,
        "bytes_limit": 80 * 2 ** 30, "reserved_bytes": 20000}]
    reg = tobs.Registry(enabled=True)
    ledger = tmemory.MemoryLedger(registry=reg)
    ledger.set_claim("params", 1000)

    def pool_bytes():  # held here: the ledger holds sources weakly
        return {"live": 500, "free": 250}

    ledger.register_source("kv_pages", pool_bytes)
    m = ledger.measure()
    assert m["source"] == "memory_stats" and m["headroom_bytes"] == 80 * 2 ** 30 - 3000
    text = reg.to_prometheus_text()
    assert 'hbm_source{source="memory_stats"} 1' in text
    assert "hbm_unattributed_bytes 1250" in text
    assert 'hbm_measured_bytes{kind="peak_bytes_in_use"} 9000' in text
    assert "reserved" not in text
    snap = ledger.snapshot()
    assert snap["measured"]["per_device"][0]["reserved_bytes"] == 20000
    assert snap["unattributed_bytes"] == 1250
    ledger.note_step_peak(step=3)
    assert ledger.watermarks()[-1]["source"] == "memory_stats"
    assert ledger.watermarks()[-1]["peak_bytes"] == 9000


def test_statless_cpu_ledger_reports_claimed_and_never_caches_it(monkeypatch):
    """Without CUDA initialised the answer is [] and the provenance is
    "claimed"; once CUDA is initialised the next read measures (nothing
    cached the statless answer)."""
    assert tmemory._device_memory_stats() == []
    reg = tobs.Registry(enabled=True)
    ledger = tmemory.MemoryLedger(registry=reg)
    ledger.set_claim("params", 64)
    ledger.note_step_peak(step=1)
    assert ledger.watermarks()[-1] | {"t": 0} == {"t": 0, "peak_bytes": 64.0, "source": "claimed",
                                                  "step": 1}
    assert 'hbm_source{source="claimed"} 1' in reg.to_prometheus_text()
    assert ledger.headroom_bytes() is None and ledger.unattributed_bytes() is None
    _fake_cuda(monkeypatch, {"allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 20})
    ledger.note_step_peak(step=2)
    assert ledger.watermarks()[-1]["source"] == "memory_stats"
    text = reg.to_prometheus_text()
    assert 'hbm_source{source="memory_stats"} 1' in text and "claimed\"} 1" not in text


def test_failed_poll_returns_none_and_measures_claimed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def broken(i):
        raise RuntimeError("CUDA context gone")

    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    assert tmemory._device_memory_stats() is None
    assert tmemory.MemoryLedger(registry=tobs.Registry(enabled=True)).measure()["source"] == \
        "claimed"


def _ledger_script(pkg, stats):
    reg = pkg.Registry(enabled=True)
    ledger = pkg.MemoryLedger(registry=reg, stats_fn=lambda: [dict(r) for r in stats])
    ledger.set_claim("params", 4096, detail="hybrid")
    ledger.set_claim("optimizer", 8192)
    ledger.set_claim("checkpoint_staging", 1 << 20)  # host bytes: outside the residual

    class Pool:
        def bytes(self):
            return {"live": 300.0, "shared": 100.0, "free": 1000.0, "scratch": 50.0}

        def quant(self):
            return {"packed": 64, "scales": 8}

    pool = Pool()
    ledger.register_source("kv_pages", pool.bytes, name="0/decode/a")
    ledger.register_source("weights_quant", pool.quant)
    ledger.note_step_peak(step=1, label="x")
    ledger.clear_claim("optimizer")
    return ledger, reg, pool


@pytest.mark.parametrize("stats", [[], [{"device": "cuda:0", "bytes_in_use": 50000,
                                         "peak_bytes_in_use": 70000, "bytes_limit": 10 ** 6}]])
def test_ledger_claims_reconciliation_and_snapshot_equal_jax(stats):
    """The same claims, sources and device rows through both ledgers: the
    same claimed split, residual, watermark, snapshot (times masked) and
    Prometheus text."""
    (jl, jreg, jpool), (tl, treg, tpool) = (_ledger_script(jmemory, stats),
                                           _ledger_script(tmemory, stats))
    assert tl.claimed() == jl.claimed()
    assert tl.device_claimed_bytes() == jl.device_claimed_bytes()
    assert tl.unattributed_bytes() == jl.unattributed_bytes()
    snaps = []
    for ledger in (jl, tl):
        snap = ledger.snapshot()
        snap.pop("time")
        for w in snap["watermarks"]:
            w.pop("t")
        snaps.append(snap)
    assert snaps[1] == snaps[0]
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()
    del tpool, jpool  # a dead owner's source drops out of both ledgers
    assert "kv_pages" not in tl.claimed() and "kv_pages" not in jl.claimed()


def test_disabled_ledger_is_a_noop():
    ledger = tmemory.MemoryLedger(registry=tobs.Registry(enabled=False))
    assert ledger.claim_tree("params", {"w": torch.ones(4)}) == 0
    ledger.set_claim("params", 10)
    ledger.note_step_peak()
    assert ledger.claimed() == {} and ledger.watermarks() == []


def test_record_collective_plan_equals_jax():
    """The same gradient tree's plan (4 KiB buckets, one buffer, one
    bucket of everything) through both packages' recorders."""
    rng = np.random.default_rng(0)
    shapes = {"wte": (64, 32), "layers.0.w": (32, 96), "layers.0.b": (96,),
              "layers.1.w": (32, 96), "layers.1.b": (96,), "ln_f": (32,)}
    arrays = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jtree = {"wte": jnp.asarray(arrays["wte"]), "ln_f": jnp.asarray(arrays["ln_f"]),
             "layers": [{"w": jnp.asarray(arrays[f"layers.{i}.w"]),
                         "b": jnp.asarray(arrays[f"layers.{i}.b"])} for i in range(2)]}
    ttree = {k: torch.from_numpy(v) for k, v in arrays.items()}
    texts = []
    for pkg, tree in ((jobs, jtree), (tobs, ttree)):
        reg = pkg.Registry(enabled=True)
        for alg, mb in (("ring", 4 / 1024), ("ring2", None), ("q8_ring", float("inf"))):
            pkg.record_collective_plan(alg, tree, mb, "dp", registry=reg)
        pkg.record_quant_sync_bytes({"int8": 1000, "fp32": 24}, "q8_ring", registry=reg)
        pkg.record_quant_sync_bytes({"int8": 1000, "fp32": 24}, "q8_ring", registry=reg)
        pkg.observe_collective_latency_ms("ring", 0.7, payload_bytes=4096, registry=reg)
        pkg.observe_recovery_ms("reconfigure", 12.5, registry=reg)
        texts.append(reg.to_prometheus_text())
    assert texts[1] == texts[0]
    assert 'collective_sync_buckets{algorithm="ring2",axis="dp"} 1' in texts[1]
