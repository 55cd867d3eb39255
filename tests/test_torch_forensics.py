"""The port's failure forensics (``dsml_tpu_torch/obs``: flight recorder,
sentinels, hang watch, OOM bundles) against the JAX package's: the same
loss sequences trip the same sentinels at the same steps under the same
policies, the same configs parse the same, bundles carry the same files;
SIGTERM and unhandled-exception dumps in a dying process; a dump never
initialises CUDA; the port's Trainer halts on a NaN loss with its bundle
on disk.

The JAX Trainer is never driven into a NaN halt here (a pytest worker
running it under six xdist workers has aborted inside the JAX step): the
JAX side is held at ``TrainingSentinels.check``. Every test points
``DSML_POSTMORTEM_DIR`` at ``tmp_path`` and turns both packages'
observability off afterwards."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dsml_tpu import obs as jobs
from dsml_tpu.obs import hangwatch as jhangwatch
from dsml_tpu.obs import memory as jmemory
from dsml_tpu.obs import sentinels as jsentinels
from dsml_tpu.obs.flight_recorder import FlightRecorder as JaxFlightRecorder
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.obs import flight_recorder as tflight
from dsml_tpu_torch.obs import hangwatch as thangwatch
from dsml_tpu_torch.obs import memory as tmemory
from dsml_tpu_torch.obs import sentinels as tsentinels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE_FILES = ["MANIFEST.json", "events.jsonl", "fingerprint.json", "log_tail.jsonl",
                "memory.json", "registry.json", "stacks.txt", "trace.json"]


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.delenv("DSML_SENTINELS", raising=False)
    monkeypatch.delenv("DSML_HANGWATCH", raising=False)
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.get_registry().reset()
        pkg.get_flight_recorder().clear()
        pkg.get_memory_ledger().clear()


def _sentinels(pkg, recorder_cls, sent_mod, directory, **cfg):
    reg = pkg.Registry(enabled=True)
    rec = recorder_cls(registry=reg, directory=str(directory))
    return reg, rec, sent_mod.TrainingSentinels(sent_mod.SentinelConfig(**cfg), registry=reg,
                                                recorder=rec)


# a loss curve with a spike at step 30, a grad-norm blowup at 36, an inf
# grad norm at 40 and a NaN loss from step 45 on
_LOSSES = [2.5 - 0.01 * i + 0.002 * ((i * 7) % 5) for i in range(60)]
_LOSSES[30] = 40.0
_LOSSES[45:] = [float("nan")] * 15
_GRADS = {36: 5e5, 40: float("inf")}


def _feed(sentinels, steps=range(60)):
    tripped = None
    for i in steps:
        try:
            sentinels.check(i, _LOSSES[i], grad_norm=_GRADS.get(i, 1.0))
        except (jsentinels.SentinelTripped, tsentinels.SentinelTripped) as e:
            tripped = (i, e.sentinel, str(e), e.bundle is not None)
            break
    return tripped


@pytest.mark.parametrize("policies", [
    dict(nonfinite="warn", spike="warn", gradnorm="warn"),
    dict(nonfinite="dump", spike="dump", gradnorm="off"),
    dict(nonfinite="halt", spike="warn", gradnorm="warn"),
    dict(nonfinite="warn", spike="halt", gradnorm="warn", spike_min_steps=8, spike_z=4.0),
    dict(nonfinite="off", spike="off", gradnorm="halt", gradnorm_max=1e3),
])
def test_sentinels_trip_at_the_same_steps_as_jax(tmp_path, policies):
    runs = []
    for name, pkg, rec_cls, mod in (("jax", jobs, JaxFlightRecorder, jsentinels),
                                    ("port", tobs, tflight.FlightRecorder, tsentinels)):
        out = tmp_path / name
        reg, rec, sent = _sentinels(pkg, rec_cls, mod, out, **policies)
        tripped = _feed(sent)
        bundles = sorted(p.name.split("_", 2)[2] for p in out.iterdir()) if out.exists() else []
        runs.append((tripped, sent.trips, reg.to_prometheus_text(), bundles,
                     [e["kind"] for e in rec.events()]))
    assert runs[1] == runs[0]
    assert runs[1][1], "the curve trips nothing under these policies"


def test_spike_zscore_math_equals_jax():
    js = jsentinels.TrainingSentinels(registry=jobs.Registry(enabled=True))
    ts = tsentinels.TrainingSentinels(registry=tobs.Registry(enabled=True))
    for i, loss in enumerate(_LOSSES[:30]):
        assert ts.spike_zscore(loss + 1.0) == js.spike_zscore(loss + 1.0)
        js.check(i, loss)
        ts.check(i, loss)
    assert ts.spike_zscore(40.0) == js.spike_zscore(40.0) > 6.0


@pytest.mark.parametrize("spec", ["", "0", "1", "off", "warn", "halt", "nonfinite=dump",
                                  "nonfinite=halt,spike=off,spike_z=3.5,spike_window=8",
                                  "gradnorm=warn,gradnorm_max=10,spike_min_steps=2",
                                  "banana", "spike=explode", "nonsense=warn"])
def test_sentinel_config_parses_as_jax(spec):
    def parse(mod):
        try:
            return mod.SentinelConfig.from_env(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    want, got = parse(jsentinels), parse(tsentinels)
    if want is None or isinstance(want, tuple):
        assert got == want
    else:
        assert vars(got) == vars(want)


@pytest.mark.parametrize("spec", ["", "0", "1", "on", "25", "0.5", "banana", "-3"])
def test_hangwatch_config_and_deadline_as_jax(spec):
    def parse(mod):
        try:
            return mod.config_from_env(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(thangwatch) == parse(jhangwatch) or \
        vars(parse(thangwatch)) == vars(parse(jhangwatch))
    tds = [mod.TrailingDeadline(multiplier=7.0, floor_s=0.5, min_samples=3)
           for mod in (jhangwatch, thangwatch)]
    for wall in (0.1, 0.3, 0.05, 0.2):
        assert tds[1].timeout_s() == tds[0].timeout_s()
        for td in tds:
            td.observe(wall)
    assert tds[1].timeout_s() == tds[0].timeout_s() == pytest.approx(1.05)


def test_hangwatch_fires_once_on_a_stall_and_disarm_prevents_it(tmp_path):
    reg = tobs.Registry(enabled=True)
    rec = tflight.FlightRecorder(registry=reg, directory=str(tmp_path))
    hw = thangwatch.HangWatch(registry=reg, recorder=rec, name="test-hw")
    try:
        tok = hw.arm("quiet", 0.05)
        hw.disarm(tok)
        hw.disarm(tok)  # idempotent
        rec.record("step", step=1)
        hw.arm("train_sync_window", 0.05, step=1)
        deadline = time.monotonic() + 10.0
        while not hw.fired and time.monotonic() < deadline:
            time.sleep(0.01)  # the stall: the window never closes
        time.sleep(0.1)
        assert len(hw.fired) == 1 and hw.fired[0]["watcher"] == "train_sync_window"
        assert reg.counter("hang_suspected_total", labels=("watcher",)).value(
            watcher="train_sync_window") == 1
        bundle = hw.fired[0]["bundle"]
        stacks = open(os.path.join(bundle, "stacks.txt")).read()
        assert f"thread {hw.fired[0]['armed_by_thread']}" in stacks
        events = [json.loads(ln) for ln in open(os.path.join(bundle, "events.jsonl"))]
        assert [e["kind"] for e in events] == ["step", "hang_suspected"]
        with hw.watching("op", 5.0):
            assert hw.armed_count() == 1
        assert hw.armed_count() == 0
    finally:
        hw.close()


def _bundle_of(pkg_recorder_cls, pkg, directory):
    reg = pkg.Registry(enabled=True)
    rec = pkg_recorder_cls(registry=reg, directory=str(directory), capacity=16)
    reg.counter("demo_total").inc()
    for i in range(20):
        rec.record("step", step=i)
    try:
        raise ValueError("boom at step 12")
    except ValueError as e:
        return rec.dump("schema check", exc=e, extra={"k": "v"})


def test_bundle_schema_equals_jax(tmp_path):
    jpath = _bundle_of(JaxFlightRecorder, jobs, tmp_path / "jax")
    tpath = _bundle_of(tflight.FlightRecorder, tobs, tmp_path / "port")
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath)) == BUNDLE_FILES
    assert tpath.endswith("_schema_check_1")
    manifests = [json.load(open(os.path.join(p, "MANIFEST.json"))) for p in (jpath, tpath)]
    for m in manifests:
        m.pop("time")
        m["exception"].pop("traceback")
    assert manifests[1] == manifests[0]
    assert manifests[1]["event_count"] == 16 and manifests[1]["exception"]["type"] == "ValueError"
    events = [json.loads(ln) for ln in open(os.path.join(tpath, "events.jsonl"))]
    assert [e["step"] for e in events] == list(range(4, 20))
    fp = json.load(open(os.path.join(tpath, "fingerprint.json")))
    assert fp["torch_version"] == torch.__version__ and fp["pid"] == os.getpid()
    assert "devices" not in fp and "cuda_version" not in fp  # CUDA is not initialised here
    mem = json.load(open(os.path.join(tpath, "memory.json")))
    assert mem["schema"] == "dsml.obs.memory_ledger/1"
    assert mem["measured"] == {"available": False, "source": "claimed", "devices": 0}


def test_disabled_recorder_records_nothing_but_dumps_on_demand(tmp_path):
    rec = tflight.FlightRecorder(registry=tobs.Registry(enabled=False), directory=str(tmp_path))
    for i in range(10):
        rec.record("step", step=i)
    assert len(rec) == 0
    path = rec.dump("on_demand")
    assert open(os.path.join(path, "events.jsonl")).read() == ""


def test_dumps_never_initialise_cuda(tmp_path, monkeypatch):
    """A dump, a snapshot, a scrape and an OOM check with CUDA not
    initialised call nothing that would initialise it."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a dump touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("init", "_lazy_init", "current_device", "device_count", "memory_stats",
                 "get_device_properties", "get_device_name", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    monkeypatch.setattr("dsml_tpu_torch.utils.platform.card_name_and_power_limit", forbidden)
    tobs.enable(forensics=False)
    ledger = tobs.get_memory_ledger()
    ledger.claim_tree("params", {"w": torch.ones(8)})
    ledger.note_step_peak(step=1)
    path = tobs.dump_postmortem("probe", directory=str(tmp_path))
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert "errors" not in manifest, manifest["errors"]
    assert json.load(open(os.path.join(path, "memory.json")))["claimed"]["params"] == {
        "total": 32.0}
    assert tobs.get_registry().to_prometheus_text()
    assert tmemory.maybe_dump_oom(ValueError("not an oom")) is None


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("whatever the message says"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"), True),
    (MemoryError("allocation failure"), True),
    (ValueError("shape mismatch"), False),
    (None, False),
])
def test_is_oom_matrix(exc, want):
    assert tmemory.is_oom(exc) is want
    if not isinstance(exc, torch.OutOfMemoryError):  # the JAX package knows text only
        assert jmemory.is_oom(exc) is want


def test_is_oom_sees_a_chained_oom():
    try:
        try:
            raise torch.OutOfMemoryError("x")
        except torch.OutOfMemoryError as inner:
            raise RuntimeError("step failed") from inner
    except RuntimeError as e:
        assert tmemory.is_oom(e)


def test_oom_bundle_carries_the_ledger_and_is_stamped(tmp_path):
    tobs.enable(forensics=False)
    ledger = tobs.get_memory_ledger()
    ledger.set_claim("params", 1234)
    ledger.note_step_peak(step=7)
    exc = torch.OutOfMemoryError("CUDA out of memory")
    path = tmemory.maybe_dump_oom(exc, directory=str(tmp_path))
    assert path and "resource_exhausted" in os.path.basename(path)
    assert exc.bundle == path and tmemory.maybe_dump_oom(exc) == path  # stamped: one bundle
    mem = json.load(open(os.path.join(path, "memory.json")))
    assert mem["claimed"]["params"] == {"total": 1234.0}
    assert mem["watermarks"][0]["step"] == 7 and mem["watermarks"][0]["source"] == "claimed"


def test_enable_disable_tear_down_cleanly():
    from dsml_tpu_torch.utils.logging import get_ring_handler

    prev_hook, prev_sig = sys.excepthook, signal.getsignal(signal.SIGTERM)
    tobs.enable()
    try:
        assert sys.excepthook is not prev_hook and get_ring_handler() is not None
        assert tflight.installed() and tobs.enabled()
    finally:
        tobs.disable()
    assert sys.excepthook is prev_hook and signal.getsignal(signal.SIGTERM) == prev_sig
    assert get_ring_handler() is None and not tflight.installed() and not tobs.enabled()


_CHILD = """
import os, signal, sys
import dsml_tpu_torch.obs as obs
obs.enable()
rec = obs.get_flight_recorder()
for i in range(60):
    rec.record("step", step=i)
from dsml_tpu_torch.utils.logging import get_logger
get_logger("child").info("about to die")
"""


@pytest.mark.parametrize("body,reason", [
    ("os.kill(os.getpid(), signal.SIGTERM)\n", "sigterm"),
    ("raise torch.OutOfMemoryError('no pages left')\n", "resource_exhausted"),
    ("raise RuntimeError('run died at 3am')\n", "unhandled_exception"),
])
def test_crash_hooks_dump_in_a_dying_process(tmp_path, body, reason):
    env = dict(os.environ, DSML_POSTMORTEM_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _CHILD + "import torch\n" + body],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode != 0
    dirs = [p for p in tmp_path.iterdir() if p.is_dir() and reason in p.name]
    assert len(dirs) == 1, (reason, list(tmp_path.iterdir()), proc.stderr[-2000:])
    events = [json.loads(ln) for ln in open(dirs[0] / "events.jsonl")]
    assert sum(e["kind"] == "step" for e in events) == 60
    log_tail = [json.loads(ln) for ln in open(dirs[0] / "log_tail.jsonl")]
    assert any("about to die" in r["msg"] for r in log_tail)


def test_trainer_halts_on_a_nan_loss_with_a_bundle(tmp_path, monkeypatch):
    """``DSML_SENTINELS=halt`` and a NaN injected into the loss at update 5:
    the port's Trainer raises SentinelTripped at the first loss sync that
    sees it, the bundle's events hold the loss syncs up to the trip, and no
    hang-watch deadline stays armed."""
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils import data as tdata

    monkeypatch.setenv("DSML_SENTINELS", "halt")
    monkeypatch.setenv("DSML_HANGWATCH", "1")
    model = MLP((8, 16, 3), device="cpu")
    loss, calls = model.loss, []

    def poisoned(x, y):
        calls.append(1)
        out = loss(x, y)
        return out * float("nan") if len(calls) >= 5 else out

    model.loss = poisoned
    data = tdata.synthetic_classification(400, 8, 3, seed=0)
    with pytest.raises(tsentinels.SentinelTripped) as err:
        Trainer(model, TrainConfig(epochs=2, batch_size=20, sync_every=2)).train(data)
    assert err.value.sentinel == "nonfinite" and "step 6" in str(err.value)
    bundle = err.value.bundle
    assert os.path.basename(bundle).split("_", 2)[2].startswith("sentinel_nonfinite")
    events = [json.loads(ln) for ln in open(os.path.join(bundle, "events.jsonl"))]
    syncs = [e for e in events if e["kind"] == "loss_sync"]
    assert [e["step"] for e in syncs] == [2, 4, 6] and np.isnan(syncs[-1]["loss"])
    assert events[-1]["kind"] == "sentinel_trip"
    assert thangwatch.get_hangwatch().armed_count() == 0
    fp = json.load(open(os.path.join(bundle, "fingerprint.json")))
    assert fp["env"]["DSML_SENTINELS"] == "halt"
