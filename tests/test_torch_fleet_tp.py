"""Decode workers over several devices (``dsml_tpu_torch/serving/
mesh_worker.py``: ``MeshDecodeWorker`` behind ``build_fleet(devices=)`` and
``DecodeFleet(devices_per_replica=2)``) against the JAX package's
multi-device decode workers.

One module-scoped fleet of four gloo rank processes (two tp = 2 workers)
serves every test, rebuilt per model and configuration; a kill ends two
of them and the next test that needs a pair spawns it:

- the port of ``tests/test_paged_kv.py::test_tp2_paged_fleet_matches_
  monolithic``: tiny GPT-2 (vocab 256, 4 heads) and a tiny GQA Llama,
  ``devices=["cpu"] * 4``, int4 pages, the prefix elided; greedy tokens
  equal the JAX fleet's on ``devices8[:4]`` and the port's monolithic
  paged batcher's bit for bit;
- a dense-cache tp = 2 fleet, and sampled tokens, against the port's
  monolithic batcher (the port's sampler is a counter hash, not
  ``jax.random``);
- the head cut of a handoff against the JAX ``P(None, "tp")`` placement,
  bit for bit, and a rank's own cut of a whole-head handoff;
- a tp worker killed through ``run_chaos_serving_fleet``, a tp replica
  through ``DecodeFleet.kill_replica``: no token lost, no process left;
- a rank SIGKILLed by hand: ``MeshWorkerError`` within 10 s, its peer
  killed."""

from __future__ import annotations

import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from dsml_tpu import serving as jserving
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.models import llama as jllama
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.runtime.chaos import run_chaos_serving, run_chaos_serving_fleet
from dsml_tpu_torch.runtime.controller import DecodeFleet
from dsml_tpu_torch.serving import (
    ContinuousBatcher,
    MeshDecodeWorker,
    MeshWorkerError,
    PrefillWorker,
    Router,
    build_fleet,
)
from dsml_tpu_torch.serving import mesh_worker
from dsml_tpu_torch.serving.batcher import head_block
from dsml_tpu_torch.serving.paging import pages_for

GPT2_CFG = dict(vocab_size=256, max_seq=256, n_layer=2, n_head=4, d_model=64, d_ff=128)
PAGED = dict(paged_kv="int4", page_size=8)
SLOTS, CHUNK, N_PAGES = 2, 8, 60
BUDGETS = [5] * 4
DEAD_WITHIN_S = 10.0


def _requests(vocab: int):
    """The JAX test's requests: a 16-token prefix heading two of four."""
    rng = np.random.default_rng(24)
    prefix = rng.integers(1, vocab, 16).astype(np.int64)
    prompts = []
    for i in range(4):
        tail = rng.integers(1, vocab, int(rng.integers(3, 10))).astype(np.int64)
        prompts.append(np.concatenate([prefix, tail]) if i % 2 else
                       rng.integers(1, vocab, int(rng.integers(5, 20))).astype(np.int64))
    return prefix, prompts


def _drain(srv, prompts, budgets, prefix=None):
    if prefix is not None:
        srv.register_prefix(prefix)
    rids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
    out = srv.run()
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """{family: (JAX model, JAX params, port model)} from the same weights."""
    out = {}
    for family, jm in (("gpt2", jgpt2.GPT2(jgpt2.GPT2Config(**GPT2_CFG))),
                       ("llama", jllama.Llama(jllama.LlamaConfig.tiny(vocab_size=256)))):
        jparams = jm.init(0)
        tcls = tgpt2.GPT2 if family == "gpt2" else tllama.Llama
        tcfg = (tgpt2.GPT2Config(**GPT2_CFG) if family == "gpt2"
                else tllama.LlamaConfig.tiny(vocab_size=256))
        tm = tcls(tcfg, device="cpu")
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
        out[family] = (jm, jparams, tm)
    return out


class _Pool:
    """The module's rank processes: tp = 2 workers, rebuilt for each use;
    ``take`` spawns pairs when fewer than asked are alive."""

    def __init__(self, fleet: Router):
        self.router = fleet
        self.workers = list(fleet.decode_workers)
        self.pids: set = {p for w in self.workers for p in w.pids}

    def take(self, n: int, model, exclude=(), **kwargs) -> list:
        live = [w for w in self.workers if w.alive and w not in exclude][:n]
        fresh = MeshDecodeWorker.spawn(model, [["cpu"] * 2] * (n - len(live)), **kwargs) \
            if len(live) < n else []
        self.workers += fresh
        self.pids |= {p for w in fresh for p in w.pids}
        return [w.rebuild(model, **kwargs) for w in live] + fresh


@pytest.fixture(scope="module")
def pool(models):
    """``build_fleet(devices=["cpu"] * 4)``: two tp = 2 workers, four ranks."""
    tm = models["gpt2"][2]
    fleet = build_fleet(tm, n_prefill=1, n_decode=2, prefill_chunk=CHUNK, n_slots=SLOTS,
                        n_pages=N_PAGES, devices=["cpu"] * 4, **PAGED)
    p = _Pool(fleet)
    yield p
    for w in p.workers:
        w.close()
    assert not [w.alive_pids() for w in p.workers if w.alive_pids()]
    for pid in p.pids:  # every rank process is gone, not a zombie of this one
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.fixture(scope="module")
def jax_fleets(models, devices8):
    """The JAX paged fleets at tp = 2 (``devices=devices8[:4]``)."""
    out = {}
    for family, (jm, jp, _) in models.items():
        prefix, prompts = _requests(256)
        router = jserving.build_fleet(jm, jp, n_prefill=1, n_decode=2, prefill_chunk=CHUNK,
                                      n_slots=SLOTS, n_pages=N_PAGES, devices=devices8[:4],
                                      **PAGED)
        assert all(dw.mesh.shape["tp"] == 2 for dw in router.decode_workers)
        out[family] = _drain(router, [p.astype(np.int32) for p in prompts], BUDGETS,
                             prefix.astype(np.int32))
    return out


def _mono(tm, paged=True, **kw):
    prefix, prompts = _requests(256)
    if paged:
        srv = ContinuousBatcher(tm, n_slots=SLOTS, prefill_chunk=CHUNK, n_pages=N_PAGES,
                                **PAGED, **kw)
        return _drain(srv, prompts, BUDGETS, prefix)
    return _drain(ContinuousBatcher(tm, n_slots=SLOTS, prefill_chunk=CHUNK, **kw), prompts,
                  BUDGETS)


def _router(pool, tm, paged=True, n=2, **kw):
    cfg = dict(n_slots=SLOTS, n_pages=N_PAGES, **PAGED) if paged else dict(n_slots=SLOTS)
    workers = pool.take(n, tm, **cfg, **kw)
    pw = (PrefillWorker(tm, CHUNK, paged_kv="int4", page_size=8) if paged
          else PrefillWorker(tm, CHUNK))
    return Router([pw], workers)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_tp2_paged_fleet_matches_jax_and_monolithic(models, pool, jax_fleets, family):
    tm = models[family][2]
    router = pool.router if family == "gpt2" else _router(pool, tm)
    prefix, prompts = _requests(256)
    got = _drain(router, prompts, BUDGETS, prefix)
    assert got == jax_fleets[family] == _mono(tm)
    heads = tm._n_cache_heads
    for dw in router.decode_workers:
        assert dw.mesh is not None and dw.mesh.shape["tp"] == 2
        assert dw.pool_heads == heads // 2
        assert dw.used_pages == pages_for(len(prefix), 8)  # the registry's, the rest back
    assert router.prefill_workers[0].ship_prefix_pages  # the handoffs elide the prefix


def test_tp2_dense_fleet_matches_monolithic(models, pool):
    tm = models["gpt2"][2]
    router = _router(pool, tm, paged=False)
    _, prompts = _requests(256)
    assert _drain(router, prompts, BUDGETS) == _mono(tm, paged=False)
    assert all(dw.pool_heads == 2 and not dw.paged for dw in router.decode_workers)


def test_tp2_sampled_fleet_equals_monolithic(models, pool):
    tm = models["llama"][2]
    kw = dict(temperature=0.8, seed=7)
    router = _router(pool, tm, **kw)
    prefix, prompts = _requests(256)
    want = _mono(tm, **kw)
    assert _drain(router, prompts, BUDGETS, prefix) == want
    assert want != _mono(tm)  # the sampler drew: not the greedy chains


def test_head_cut_equals_jax_placement_bit_for_bit(models, pool, devices8):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(5)
    tree = [{"k": rng.integers(0, 255, (3, 4, 8, 4)).astype(np.uint8),
             "k_s": rng.standard_normal((3, 4, 8, 1)).astype(np.float32)},
            {"k": rng.standard_normal((1, 4, 16, 8)).astype(np.float32)}]
    mesh = Mesh(np.asarray(devices8[:2]), ("tp",))
    for layer in tree:
        for key, arr in layer.items():
            placed = jax.device_put(arr, NamedSharding(mesh, P(None, "tp")))
            by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
            for r, dev in enumerate(devices8[:2]):
                cut = head_block([{key: torch.from_numpy(arr)}], 2, r)[0][key]
                np.testing.assert_array_equal(cut.numpy(), by_device[dev])
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        head_block([{"k": torch.zeros(1, 4, 2)}], 3, 0)

    # a rank given the whole-head handoff cuts its own block: the same tokens
    # as the supervisor's cut
    tm = models["gpt2"][2]
    (w,) = pool.take(1, tm, n_slots=SLOTS, n_pages=N_PAGES, **PAGED)
    pw = PrefillWorker(tm, CHUNK, paged_kv="int4", page_size=8)
    _, prompts = _requests(256)
    for i, p in enumerate(prompts[:2]):
        pw.submit(p, 5, frid=i, key_rid=i)
    handoffs = []
    while len(handoffs) < 2:
        handoffs += pw.step()
    for h in handoffs:
        w.inject(h.prompt, h.max_new_tokens, logits_row=h.logits, key_rid=h.key_rid,
                 kv_pages=h.cache1, page_size=8)
        w._call("inject", h.prompt, h.max_new_tokens, logits_row=mesh_worker._pack(h.logits),
                key_rid=h.key_rid, kv_pages=mesh_worker._pack(h.cache1), page_size=8)
    out = w.run()
    assert [out[0], out[2]] == [out[1], out[3]]
    assert out[0] == _mono(tm)[0]


def test_tp_decode_worker_killed_through_chaos_harness(models, pool):
    tm = models["gpt2"][2]
    router = _router(pool, tm)
    prefix, prompts = _requests(256)
    router.register_prefix(prefix)
    victim = router.decode_workers[-1]

    class WhenBusy:  # the kill lands once the victim holds work
        fired = False

        def get(self, tick):
            if self.fired or not (victim.n_active or victim.n_injected):
                return None
            self.fired = True
            return ("decode", None)

    report = run_chaos_serving_fleet(router, prompts, BUDGETS, WhenBusy())
    assert report["requeued_decode"] >= 1 and report["requeued_requests"] >= 1
    assert [report["results"][f] for f in sorted(report["results"])] == _mono(tm)
    assert report["trace_requeue_same"] == report["trace_retry_recorded"] == 1
    assert report["trace_burn_full_latency"] == 1
    assert not victim.alive and victim.alive_pids() == []
    for pid in victim.pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert len(router.decode_workers) == 1


def test_decode_fleet_tp2_replicas_survive_a_kill(models, pool):
    tm = models["gpt2"][2]
    kw = dict(n_slots=SLOTS, prefill_chunk=CHUNK, n_pages=N_PAGES, **PAGED)
    made = []

    def make_replica(span):
        assert len(span) == 2
        made.extend(pool.take(1, tm, exclude=made, **kw))
        return made[-1]

    _, prompts = _requests(256)
    (ref,) = pool.take(1, tm, **kw)
    want = _drain(ref, prompts, BUDGETS)  # one tp = 2 replica alone
    assert want == _drain(ContinuousBatcher(tm, **kw), prompts, BUDGETS)
    fleet = DecodeFleet(make_replica, min_replicas=2, max_replicas=2, scale_up_queue_depth=99,
                        devices=["cpu"] * 4, devices_per_replica=2)
    replicas = dict(fleet._replicas)
    assert all(r.mesh.shape["tp"] == 2 for r in replicas.values())
    report = run_chaos_serving(fleet, prompts, 5, {3: None})
    killed = replicas[max(replicas)]
    assert [report["results"][f] for f in sorted(report["results"])] == want
    assert any(e.get("requeued", 0) >= 1 for e in fleet.scale_events)
    assert not killed.alive and killed.alive_pids() == []
    assert len(fleet._device_pool) == 2  # the killed replica's devices came back


def test_sigkilled_rank_surfaces_as_named_error(models, pool):
    tm = models["gpt2"][2]
    (w,) = pool.take(1, tm, n_slots=SLOTS, prefill_chunk=CHUNK, n_pages=N_PAGES, **PAGED)
    _, prompts = _requests(256)
    for p in prompts:
        w.submit(p, 5)
    w.step()
    os.kill(w.pids[1], signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(MeshWorkerError, match="rank 1: died") as err:
        for _ in range(50):
            w.step()
    assert time.monotonic() - t0 < DEAD_WITHIN_S
    assert err.value.rank == 1
    assert not w.alive and w.alive_pids() == []
    with pytest.raises(MeshWorkerError, match="dead"):
        w.step()
