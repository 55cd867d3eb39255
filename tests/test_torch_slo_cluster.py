"""The port's SLO accounting (``dsml_tpu_torch/obs/slo.py``) and cluster
plane (``dsml_tpu_torch/obs/cluster.py``, ``/cluster.json``) against the
JAX package's: the same events give the same compliance, burn rates,
statuses, tail attribution and tracker report; the same snapshot dicts
give the same merged exposition, report, quantiles, clock offsets,
stitched trace and trace summary; a snapshot written by either package
merges in the other's view. Pure Python on both sides."""

from __future__ import annotations

import json
import urllib.request

import grpc
import numpy as np
import pytest

from dsml_tpu.obs import cluster as jcluster
from dsml_tpu.obs import slo as jslo
from dsml_tpu.obs.registry import Registry as JRegistry
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.obs import cluster as tcluster
from dsml_tpu_torch.obs import slo as tslo
from dsml_tpu_torch.obs.registry import Registry as TRegistry

PKGS = ((jslo, jcluster, JRegistry), (tslo, tcluster, TRegistry))


def _masked(records):
    """Registry records with their wall-clock exemplar times dropped."""
    out = []
    for rec in records:
        rec = dict(rec)
        if rec.get("exemplars"):
            rec["exemplars"] = {b: {k: v for k, v in ex.items() if k != "time"}
                                for b, ex in rec["exemplars"].items()}
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# SLO math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    events = [(float(t), bool(g)) for t, g in zip(np.cumsum(rng.uniform(0, 2, 200)),
                                                   rng.random(200) < 0.8)]
    now = events[-1][0]
    for w in (1.0, 10.0, 60.0, 1e9):
        assert tslo.window_compliance(events, now, w) == jslo.window_compliance(events, now, w)
    for frac, obj in ((0.0, 0.99), (0.05, 0.9), (1.0, 0.5), (0.3, 0.999)):
        assert tslo.burn_rate(frac, obj) == jslo.burn_rate(frac, obj)
    for fast, slow in rng.uniform(0, 20, (20, 2)):
        assert tslo.status_from_burn(fast, slow) == jslo.status_from_burn(fast, slow)
        assert tslo.status_from_burn(fast, slow, 5.0, 1.0) == jslo.status_from_burn(
            fast, slow, 5.0, 1.0)
    samples = [(float(e), {s: float(v) for s, v in zip(tslo.STAGES, rng.uniform(0, 1, 5))
                           if rng.random() < 0.8}, f"t{i}")
               for i, e in enumerate(rng.uniform(0.1, 5.0, 64))]
    for q in (0.5, 0.9, 0.99):
        assert tslo.tail_attribution(samples, q) == jslo.tail_attribution(samples, q)
    assert tslo.tail_attribution([]) is None and jslo.tail_attribution([]) is None
    with pytest.raises(ValueError, match="no error budget"):
        tslo.burn_rate(0.1, 1.0)


def test_slo_spec_validation_equals_jax():
    for kw in ({"objective": 1.0}, {"objective": 0.0},
               {"fast_window_s": 0.0}, {"fast_window_s": 60.0, "slow_window_s": 10.0}):
        msgs = []
        for slo in (jslo, tslo):
            with pytest.raises(ValueError) as err:
                slo.SLOSpec("c", **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    spec = tslo.SLOSpec("c", ttft_budget_ms=1.0, e2e_budget_ms=2.0)
    assert spec.budgeted_slis() == ("ttft", "e2e") and spec.budget_ms("tpot") is None


def _drive_tracker(slo, registry_cls):
    """One tracker on a fixed clock: two classes, mixed budgets, a None
    TPOT, stage samples; its windows, statuses, report and registry."""
    clock = [0.0]
    reg = registry_cls(enabled=True)
    specs = [slo.SLOSpec("interactive", objective=0.9, ttft_budget_ms=100.0, tpot_budget_ms=20.0,
                         e2e_budget_ms=1000.0, fast_window_s=10.0, slow_window_s=50.0),
             slo.SLOSpec("batch", e2e_budget_ms=5000.0)]
    tracker = slo.SLOTracker(specs, registry=reg, clock=lambda: clock[0])
    rng = np.random.default_rng(7)
    verdicts = []
    for i in range(400):
        clock[0] += float(rng.uniform(0.05, 0.4))
        ttft = 50.0 if rng.random() < 0.7 else 200.0
        tpot = None if i % 9 == 0 else float(rng.uniform(5, 30))
        e2e = float(rng.uniform(100, 2000))
        stages = {s: float(rng.uniform(0, 0.5)) for s in slo.STAGES}
        cls = "interactive" if i % 3 else "batch"
        verdicts.append(tracker.record(cls, ttft_ms=ttft, tpot_ms=tpot, e2e_ms=e2e,
                                       trace_id=f"tr{i}", stages=stages))
        if i in (100, 250):
            tracker.export_gauges(force=True)
    burns = [tracker.burn("interactive", sli, w) for sli in ("ttft", "tpot", "e2e")
             for w in ("fast", "slow")]
    report = tracker.report()
    tracker.export_gauges(force=True)
    return verdicts, burns, report, _masked(reg.collect()), reg.to_prometheus_text()


def test_slo_tracker_equals_jax_on_a_fixed_clock():
    jax_side, port_side = (_drive_tracker(slo, reg) for slo, _, reg in PKGS)
    for got, want in zip(port_side, jax_side):
        assert got == want
    with pytest.raises(ValueError, match="unknown SLO class"):
        tslo.SLOTracker([tslo.SLOSpec("a")], registry=TRegistry()).record("b", ttft_ms=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        tslo.SLOTracker([tslo.SLOSpec("a"), tslo.SLOSpec("a")])


def test_slo_reset_and_idle_status_equal_jax():
    """After a burst of bad requests the burn status pages; once the clock
    runs past the slow window with no traffic it reads ok again (the
    scrape-time refresh), and reset() clears the windows, not the
    monotonic counters — in both packages alike."""
    rows = []
    for slo, _, reg_cls in PKGS:
        clock = [0.0]
        reg = reg_cls(enabled=True)
        tracker = slo.SLOTracker([slo.SLOSpec("i", objective=0.9, ttft_budget_ms=10.0,
                                              fast_window_s=5.0, slow_window_s=20.0)],
                                 registry=reg, clock=lambda: clock[0])
        for _ in range(100):
            clock[0] += 0.1
            tracker.record("i", ttft_ms=50.0)
        paged = tracker.status("i", "ttft")["status"]
        clock[0] += 100.0
        reg.collect()  # the collect hook refreshes the burn gauges
        idle = reg.gauge("slo_burn_status", labels=("slo", "sli")).value(slo="i", sli="ttft")
        tracker.reset()
        rows.append((paged, idle, tracker.report(), _masked(reg.collect())))
    assert rows[0] == rows[1]
    assert rows[1][0] == "page" and rows[1][1] == 0


# ---------------------------------------------------------------------------
# cluster plane
# ---------------------------------------------------------------------------

BOUNDS = (1.0, 2.0, 4.0, 8.0)


def _proc_snapshot(registry_cls, host, pid, role, build, wall_s=1000.0, mono_us=0.0, trace=None):
    """A snapshot as ``snapshot()`` emits it for a private registry, with
    the identity set so one process can stand for a fleet."""
    reg = registry_cls(enabled=True)
    build(reg)
    metrics = reg.collect()
    for rec in metrics:  # exemplar times at the process's wall clock: one merge order
        for ex in (rec.get("exemplars") or {}).values():
            ex["time"] = wall_s
    snap = {"schema": "dsml.obs.cluster/1", "host": host, "pid": pid, "role": role,
            "wall_s": wall_s, "mono_us": mono_us, "enabled": True, "metrics": metrics}
    if trace is not None:
        snap["trace"] = trace
    return snap


def _fleet_snapshots(registry_cls, seed=0):
    """Three processes' worth of series of every kind: counters, gauges
    (goodput, hbm), histograms with exemplars and a bound mismatch, the
    SLO series, a straggler, an identity-label clash; with traces."""
    rng = np.random.default_rng(seed)
    snaps = []
    for i, (host, pid, role) in enumerate((("a", 11, "coordinator"), ("b", 22, "worker"),
                                           ("c", 11, "worker"))):
        def build(reg, i=i):
            reg.counter("hits_total", labels=("kind",)).inc(3 + i, kind="x")
            reg.counter("hits_total", labels=("kind",)).inc(1.5, kind="y")
            reg.gauge("train_goodput").set(0.5 + 0.1 * i)
            reg.gauge("hbm_headroom_bytes").set(1e9 * (i + 1))
            reg.gauge("hbm_measured_bytes", labels=("kind",)).set(2e9, kind="bytes_in_use")
            reg.gauge("queue", labels=("host",)).set(i, host="w")  # shadowed by the identity label
            h = reg.histogram("span_ms", labels=("name",), buckets=BOUNDS)
            scale = 10.0 if i == 2 else 1.0  # process c straggles
            for j, v in enumerate(rng.uniform(0.1, 6.0, 12) * scale):
                h.observe(float(v), exemplar=f"t{i}-{j}" if j % 3 == 0 else None, name="wire_op")
            bounds = BOUNDS if i != 1 else (1.0, 3.0)  # process b's bounds differ
            reg.histogram("lat_ms", buckets=bounds).observe(float(rng.uniform(0, 4)))
            clock = [float(i)]
            tracker_mod = tslo if registry_cls is TRegistry else jslo
            tracker = tracker_mod.SLOTracker(
                [tracker_mod.SLOSpec("interactive", objective=0.9, ttft_budget_ms=100.0)],
                registry=reg, clock=lambda: clock[0])
            for k in range(10):
                clock[0] += 0.5
                tracker.record("interactive", ttft_ms=50.0 if k % (i + 2) else 500.0)
            tracker.export_gauges(force=True)

        events = [{"name": "op", "ph": "B", "ts": 100.0 * (i + 1), "pid": pid, "tid": 1},
                  {"name": "op", "ph": "E", "ts": 100.0 * (i + 1) + 50, "pid": pid, "tid": 1},
                  {"name": "req", "ph": "s", "ts": 10.0 + i, "pid": pid, "tid": 1, "id": "f1",
                   "args": {"trace_id": "T1"}},
                  {"name": "hop", "ph": "i", "ts": 20.0 + i, "pid": pid, "tid": 2,
                   "args": {"trace_id": "T1"}}]
        snaps.append(_proc_snapshot(registry_cls, host, pid, role, build,
                                    wall_s=1000.0 + 0.25 * i, mono_us=5e5 * i,
                                    trace={"traceEvents": events, "displayTimeUnit": "ms"}))
    return snaps


def _view_outputs(cluster, snaps):
    view = cluster.merge_snapshots(snaps)
    return (_masked(view.collect()), view.to_prometheus_text(), view.report(),
            view.straggler_ranking(where={"name": "wire_op"}, q=0.9),
            view.fleet_goodput(), view.slo_status(), view.notes)


def test_merged_view_equals_jax_on_the_same_snapshots():
    snaps = _fleet_snapshots(TRegistry)
    jax_out, port_out = _view_outputs(jcluster, snaps), _view_outputs(tcluster, snaps)
    for got, want in zip(port_out, jax_out):
        assert got == want
    report = port_out[2]
    assert report["stragglers"][0]["host"] == "c" and report["stragglers"][0]["straggler"]
    assert any("bucket bounds differ" in n for n in report["notes"])
    assert any("shadowed" in n for n in report["notes"])
    assert report["slo"]["interactive"]["requests"] == 30


def test_snapshots_of_either_package_merge_in_the_other():
    """Each package's registries write the same records: the JAX-built
    and port-built fleets merge to the same view in both packages."""
    jsnaps, tsnaps = _fleet_snapshots(JRegistry), _fleet_snapshots(TRegistry)
    assert [_masked(s["metrics"]) for s in jsnaps] == [_masked(s["metrics"]) for s in tsnaps]
    mixed = [jsnaps[0], tsnaps[1], jsnaps[2]]
    want = _view_outputs(jcluster, mixed)
    assert _view_outputs(tcluster, mixed) == want
    assert _view_outputs(jcluster, [tsnaps[0], jsnaps[1], tsnaps[2]]) == want
    # real snapshot() of each package, private registries
    for cluster, reg_cls in ((jcluster, JRegistry), (tcluster, TRegistry)):
        reg = reg_cls(enabled=True)
        reg.counter("roundtrip_total").inc(2.0)
        snap = cluster.snapshot(role="bench", registry=reg, with_trace=False)
        for other in (jcluster, tcluster):
            view = other.merge_snapshots([snap])
            fleet = next(r for r in view.collect() if r["name"] == "roundtrip_total:fleet")
            assert fleet["value"] == 2.0 and view.processes[0]["role"] == "bench"


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_estimate_quantile_equals_jax(q):
    rng = np.random.default_rng(int(q * 100))
    counts = np.cumsum(rng.integers(0, 20, len(BOUNDS) + 1))
    cum = {b: int(c) for b, c in zip(BOUNDS, counts)}
    cum["+Inf"] = int(counts[-1])
    assert tcluster.estimate_quantile(BOUNDS, cum, q) == jcluster.estimate_quantile(BOUNDS, cum, q)
    assert tcluster.estimate_quantile(BOUNDS, {"+Inf": 0}, q) is None


def test_clock_sync_stitch_and_summary_equal_jax():
    snaps = _fleet_snapshots(TRegistry)
    for cluster in (jcluster, tcluster):
        sync = cluster.ClockSync.from_handshake(100.0, 300.0, 50.0)
        assert (sync.offset_us, sync.rtt_us, sync.method) == (150.0, 200.0, "handshake")
    want = jcluster.ClockSync.from_wall(snaps[1], snaps[0]["wall_s"], snaps[0]["mono_us"])
    got = tcluster.ClockSync.from_wall(snaps[1], snaps[0]["wall_s"], snaps[0]["mono_us"])
    assert (got.offset_us, got.rtt_us, got.method) == (want.offset_us, want.rtt_us, want.method)
    syncs = {1: tcluster.ClockSync(12.5, 3.0, "handshake")}
    jsyncs = {1: jcluster.ClockSync(12.5, 3.0, "handshake")}
    stitched = tcluster.stitch_traces(snaps, syncs)
    assert stitched == jcluster.stitch_traces(snaps, jsyncs)
    assert tcluster.stitch_traces([]) == jcluster.stitch_traces([])
    pids = [e["pid"] for e in stitched["traceEvents"] if e["name"] == "process_name"]
    assert len(set(pids)) == 3  # the colliding pid 11 got its own lane
    summary = tcluster.trace_summary(stitched)
    assert summary == jcluster.trace_summary(stitched)
    assert len(summary["T1"]["pids"]) == 3 and summary["T1"]["flow"] == {"s": 3}


def test_validate_snapshot_errors_equal_jax():
    bad = [{"schema": "nope"}, [1, 2], {"schema": "dsml.obs.cluster/1", "host": "h"},
           {"schema": "dsml.obs.cluster/1", "host": "h", "pid": 1, "role": "r", "wall_s": 0,
            "mono_us": 0, "metrics": {}}]
    for snap in bad:
        msgs = []
        for cluster in (jcluster, tcluster):
            with pytest.raises(ValueError) as err:
                cluster.validate_snapshot(snap)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    agg = tcluster.ClusterAggregator()
    with pytest.raises(ValueError, match="not a cluster snapshot"):
        agg.add({"schema": "x"})
    # the gRPC pull is ported: an endpoint with nothing behind it is a gRPC error
    with pytest.raises(grpc.RpcError):
        agg.pull("127.0.0.1:1", timeout=5.0)


def test_cluster_json_served_and_scraped_in_process(tmp_path):
    """``start_metrics_server(role=, tracer=)`` serves ``/cluster.json``;
    ``ClusterAggregator.scrape`` reads it with the handshake, merges it
    beside an added snapshot and writes the artifact set."""
    reg = TRegistry(enabled=True)
    reg.counter("roundtrip_total").inc(3.0)
    reg.histogram("roundtrip_ms", buckets=BOUNDS).observe(0.5)
    tracer = tobs.SpanTracer(registry=reg)
    with tracer.span("worker_phase"):
        pass
    srv = tobs.start_metrics_server(reg, port=0, role="worker", tracer=tracer)
    try:
        agg = tcluster.ClusterAggregator()
        own = TRegistry(enabled=True)
        own.counter("roundtrip_total").inc(5.0)
        agg.add(tcluster.snapshot(role="aggregator", registry=own, with_trace=False),
                tcluster.ClockSync(0.0, 0.0, "identity"))
        snap = agg.scrape(srv.address)
        raw = json.loads(urllib.request.urlopen(f"{srv.address}/cluster.json", timeout=10).read())
    finally:
        srv.stop()
    assert snap["role"] == "worker" and raw["schema"] == tcluster.SNAPSHOT_SCHEMA
    assert any(e["name"] == "worker_phase" for e in snap["trace"]["traceEvents"])
    view = agg.merged()
    fleet = next(r for r in view.collect() if r["name"] == "roundtrip_total:fleet")
    assert fleet["value"] == 8.0
    rep = agg.report()
    assert [s["method"] for s in rep["clock_sync"].values()] == ["identity", "handshake"]
    paths = agg.write_artifacts(str(tmp_path / "out"))
    with open(paths["trace"]) as f:
        assert any(e.get("name") == "worker_phase" for e in json.load(f)["traceEvents"])
    with open(paths["report"]) as f:
        assert json.load(f)["processes"][1]["role"] == "worker"
    assert "roundtrip_total:fleet 8" in open(paths["prometheus"]).read()
    # the JAX package's view merges the scraped snapshot too
    assert jcluster.merge_snapshots([snap]).processes[0]["role"] == "worker"


# ---------------------------------------------------------------------------
# the gRPC half: ObsPlane pull, push, and the multi-process demo
# ---------------------------------------------------------------------------


def test_pull_and_push_over_grpc_cross_the_packages():
    """``ClusterAggregator.pull`` scrapes a port device server's ObsPlane
    (and the JAX aggregator scrapes it too); ``push_snapshot`` reaches a
    port aggregator and a JAX one."""
    from dsml_tpu_torch.comm.device_server import serve_device

    tobs.enable(forensics=False)
    srv = serve_device(501, mem_size=0x1000, device="cpu")
    agg = tcluster.ClusterAggregator()
    tsrv = tcluster.serve_aggregator(agg)
    jagg = jcluster.ClusterAggregator()
    jsrv = jcluster.serve_aggregator(jagg)
    try:
        srv.runtime.memcpy_h2d(0x1000, b"x")
        tobs.get_registry().counter("wire_probe_total", "probe").inc(3)
        snap = agg.pull(srv.address)
        assert snap["role"] == "device_server" and snap["schema"] == tcluster.SNAPSHOT_SCHEMA
        assert jagg.pull(srv.address)["pid"] == snap["pid"]
        names = {r["name"] for r in agg.merged().collect()}
        assert "wire_probe_total" in names
        assert agg.report()["clock_sync"][0]["method"] == "handshake"
        for address in (tsrv.address, jsrv.address):
            assert tcluster.push_snapshot(address, role="pusher")["ok"] is True
        assert len(agg.merged().collect()) > 0 and len(jagg._snaps) == 2
        with pytest.raises(grpc.RpcError) as err:
            tcluster.push_snapshot(srv.address)  # a worker's plane only serves pulls
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        tsrv.stop()
        jsrv.stop()
        srv.stop()
        tobs.disable()
        tobs.get_registry().reset()


def test_cluster_demo_runs_the_coordinator_and_two_device_subprocesses(tmp_path):
    report = tcluster.run_cluster_demo(str(tmp_path), n_devices=2, payload_floats=256,
                                       device="cpu")
    try:
        assert report["n_processes"] == 3
        roles = {s["role"] for s in json.load(open(report["artifacts"]["report"]))["processes"]}
        assert roles == {"coordinator", "device_server"}
        trace = json.load(open(report["artifacts"]["trace"]))
        assert any(e.get("name") == "wire_op" for e in trace["traceEvents"])
        assert any(e.get("name") == "device_memcpy" for e in trace["traceEvents"])
    finally:
        tobs.disable()
        tobs.get_registry().reset()
        tobs.get_tracer().reset()
