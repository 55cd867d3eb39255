"""The port's serving fleet (``dsml_tpu_torch/serving/{prefill,handoff,
router}.py``, ``ContinuousBatcher.inject``, ``utils/crc32c.py``) against
the JAX package's.

Same weights in both packages (``params_from_jax``), the JAX fleet tests'
tiny GPT-2 (vocab 256, max_seq 256, 2 layers, 4 heads, d 64, d_ff 128):

- CRC32C and the frame table equal the JAX ones byte for byte; the codec
  writes the JAX header, payload and CRCs, and each package decodes the
  other's frame;
- a ``PrefillWorker``'s handoff (dense rows or int4 pages, and the logits
  row) matches the JAX worker's: codes bit for bit, f32 values at 1e-5;
- fleet greedy tokens equal the JAX fleet's and the port's monolithic
  batcher's bit for bit (dense and paged int4), also through the codec,
  a failing transport and worker kills. Sampled tokens equal the port's
  monolithic batcher's: the port's sampler draws from a counter hash, not
  ``jax.random`` (``serving/batcher.py``), so the JAX fleet's sampled
  bits are not the port's;
- router policy, inject's validation, abandon, preemption and the
  request trace as the JAX suite pins them.

The JAX fleets drain once per module (fixtures)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dsml_tpu import obs as jobs
from dsml_tpu import serving as jserving
from dsml_tpu.comm import migration as jmigration
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.runtime import native as jnative
from dsml_tpu.serving import handoff as jhandoff
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.obs.cluster import snapshot, stitch_traces, trace_summary
from dsml_tpu_torch.serving import (
    ContinuousBatcher,
    Handoff,
    HandoffIntegrityError,
    PrefillWorker,
    QueueFull,
    Router,
    SLOClass,
    build_fleet,
    decode_handoff,
    encode_handoff,
    fetch_from_migrator,
    frame_transport,
    register_with_donor,
    stream_transport,
)
from dsml_tpu_torch.serving.paging import pages_for
from dsml_tpu_torch.utils import crc32c as tcrc

CFG = dict(vocab_size=256, max_seq=256, n_layer=2, n_head=4, d_model=64, d_ff=128)
PAGED = dict(paged_kv="int4", page_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tiny models' ops gain nothing from more, and
    the suite's parallel workers would oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.get_registry().reset()
        pkg.get_tracer().reset()
        pkg.get_flight_recorder().clear()
        pkg.get_memory_ledger().clear()


@pytest.fixture(scope="module")
def models():
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config(**CFG))
    jparams = jmodel.init(0)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config(**CFG), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG["vocab_size"], (n,)).astype(np.int64) for n in lengths]


def _prefixed(seed=13, n=6, prefix_len=20):
    """Half the prompts head with one prefix (prefix + 3..9 tokens)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, CFG["vocab_size"], prefix_len).astype(np.int64)
    prompts = []
    for i in range(n):
        if i % 2:
            prompts.append(np.concatenate(
                [prefix, rng.integers(1, CFG["vocab_size"], int(rng.integers(3, 10)))]))
        else:
            prompts.append(rng.integers(1, CFG["vocab_size"], int(rng.integers(5, 25))))
    return prefix, prompts


def _drain(srv, prompts, budgets, prefix=None):
    if prefix is not None:
        srv.register_prefix(prefix)
    rids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
    out = srv.run()
    return [list(map(int, out[r])) for r in rids]


DENSE_PROMPTS = _prompts([5, 17, 32, 9, 26, 40])
DENSE_BUDGETS = [5, 3, 6, 5, 3, 4]
PREFIX, PAGED_PROMPTS = _prefixed()
PAGED_BUDGETS = [6] * 6


@pytest.fixture(scope="module")
def jax_fleets(models):
    """The JAX fleets' greedy tokens: dense, and paged int4 with a
    registered prefix whose pages the handoffs elide."""
    jmodel, jparams, _ = models
    as32 = [[p.astype(np.int32) for p in ps] for ps in (DENSE_PROMPTS, PAGED_PROMPTS)]
    dense = jserving.build_fleet(jmodel, jparams, n_prefill=2, n_decode=2, prefill_chunk=8,
                                 n_slots=2)
    paged = jserving.build_fleet(jmodel, jparams, n_prefill=2, n_decode=2, prefill_chunk=8,
                                 n_slots=2, n_pages=80, **PAGED)
    return {"dense": _drain(dense, as32[0], DENSE_BUDGETS),
            "int4": _drain(paged, as32[1], PAGED_BUDGETS, PREFIX.astype(np.int32))}


@pytest.fixture(scope="module")
def mono(models):
    """The port's monolithic batchers' tokens for the same requests."""
    tmodel = models[2]
    return {"dense": _drain(ContinuousBatcher(tmodel, n_slots=2), DENSE_PROMPTS, DENSE_BUDGETS),
            "int4": _drain(ContinuousBatcher(tmodel, n_slots=2, prefill_chunk=8, n_pages=80,
                                             **PAGED), PAGED_PROMPTS, PAGED_BUDGETS, PREFIX)}


def _fleet(tmodel, kind, **kw):
    if kind == "int4":
        return build_fleet(tmodel, n_prefill=2, n_decode=2, prefill_chunk=8, n_slots=2,
                           n_pages=80, **PAGED, **kw)
    return build_fleet(tmodel, n_prefill=2, n_decode=2, prefill_chunk=8, n_slots=2, **kw)


def _fleet_tokens(router, kind):
    if kind == "int4":
        return _drain(router, PAGED_PROMPTS, PAGED_BUDGETS, PREFIX)
    return _drain(router, DENSE_PROMPTS, DENSE_BUDGETS)


# ---------------------------------------------------------------------------
# CRC32C and the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4095, tcrc.MIGRATE_CHUNK, tcrc.MIGRATE_CHUNK + 17])
def test_crc32c_and_frame_table_equal_jax(n):
    payload = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tcrc.MIGRATE_CHUNK == jmigration.MIGRATE_CHUNK
    assert tcrc.crc32c(payload) == jnative.crc32c(payload) == jnative._crc32c_py(payload)
    assert tcrc.payload_chunk_crcs(payload) == jmigration.payload_chunk_crcs(payload)
    # rolling across a split equals the whole
    assert tcrc.crc32c(payload[n // 3:], tcrc.crc32c(payload[: n // 3])) == tcrc.crc32c(payload)
    assert tcrc.crc32c(memoryview(payload)) == tcrc.crc32c(payload)


def _handoff_leaves(paged: bool, rng, n_layer=2):
    if paged:
        return [{"k": rng.integers(0, 255, (3, 4, 8, 8)).astype(np.uint8),
                 "k_s": rng.standard_normal((3, 4, 8, 1)).astype(np.float32),
                 "v": rng.integers(0, 255, (3, 4, 8, 8)).astype(np.uint8),
                 "v_s": rng.standard_normal((3, 4, 8, 1)).astype(np.float32)}
                for _ in range(n_layer)]
    return [{"k": rng.standard_normal((1, 4, 64, 16)).astype(np.float32),
             "v": rng.standard_normal((1, 4, 64, 16)).astype(np.float32)} for _ in range(n_layer)]


def _pair(paged: bool, seed=0):
    """The same handoff in each package: numpy leaves (JAX), tensors (port)."""
    rng = np.random.default_rng(seed)
    leaves = _handoff_leaves(paged, rng)
    logits = rng.standard_normal(256).astype(np.float32)
    common = dict(frid=7, max_new_tokens=4, prefill_len=21, submitted_at=1.5,
                  prefill_done_at=2.25, key_rid=7, page_size=8 if paged else None,
                  prefix_rows=16 if paged else 0, trace_id="abc-1-2", parent_span="prefill_chunk")
    prompt = rng.integers(0, 256, 21)
    jh = jhandoff.Handoff(prompt=prompt.astype(np.int32), cache1=leaves, logits=logits, **common)
    th = Handoff(prompt=prompt, logits=torch.from_numpy(logits),
                 cache1=[{k: torch.from_numpy(v) for k, v in layer.items()} for layer in leaves],
                 **common)
    return jh, th


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_encode_equals_jax_byte_for_byte_and_decodes_across(paged):
    jh, th = _pair(paged)
    jf, tf = jhandoff.encode_handoff(jh), encode_handoff(th)
    assert tf["header"] == jf["header"] and tf["payload"] == jf["payload"]
    assert tf["chunk_crcs"] == jf["chunk_crcs"]
    back = decode_handoff(jf)  # the port reads the JAX frame
    jback = jhandoff.decode_handoff(tf)  # and the JAX package the port's
    for got_t, got_j, want in zip(back.cache1, jback.cache1, jh.cache1):
        for key, arr in want.items():
            assert got_t[key].device.type == "cpu"
            np.testing.assert_array_equal(got_t[key].numpy(), arr)
            np.testing.assert_array_equal(got_j[key], arr)
    np.testing.assert_array_equal(back.logits.numpy(), jh.logits)
    for field in ("frid", "max_new_tokens", "prefill_len", "submitted_at", "prefill_done_at",
                  "key_rid", "page_size", "prefix_rows", "trace_id", "parent_span"):
        assert getattr(back, field) == getattr(jh, field) == getattr(jback, field)
    np.testing.assert_array_equal(back.prompt, jh.prompt)


def test_a_flipped_byte_fails_its_frame_and_bad_headers_raise():
    rng = np.random.default_rng(3)
    big = [{"k": torch.from_numpy(rng.integers(0, 255, (9, 4, 8, 8 * 256)).astype(np.uint8))}]
    h = Handoff(frid=3, prompt=np.arange(5), max_new_tokens=2, prefill_len=5, cache1=big,
                logits=torch.zeros(256), page_size=8)
    frame = encode_handoff(h)
    assert len(frame["chunk_crcs"]) == 3  # 576 KiB + logits over 256 KiB frames
    for frame_idx in (0, 1, 2):
        corrupt = bytearray(frame["payload"])
        corrupt[frame_idx * tcrc.MIGRATE_CHUNK + 5] ^= 0xFF
        for pkg in (jhandoff, None):
            with pytest.raises(pkg.HandoffIntegrityError if pkg else HandoffIntegrityError,
                               match=rf"frame\(s\) \[{frame_idx}\] of 3"):
                (pkg.decode_handoff if pkg else decode_handoff)({**frame,
                                                                 "payload": bytes(corrupt)})
    # validate=False skips the CRCs only: sizes and the schema always count
    assert decode_handoff({**frame, "payload": bytes(corrupt)}, validate=False).frid == 3
    with pytest.raises(HandoffIntegrityError, match="header says"):
        decode_handoff({**frame, "payload": frame["payload"][:-1]})
    with pytest.raises(HandoffIntegrityError, match="unknown handoff schema"):
        decode_handoff({**frame, "header": {**frame["header"], "schema": "x"}})


def test_bf16_leaves_round_trip_under_the_jax_dtype_name():
    rng = np.random.default_rng(4)
    leaf = torch.from_numpy(rng.standard_normal((1, 4, 64, 16)).astype(np.float32)).bfloat16()
    h = Handoff(frid=1, prompt=np.arange(3), max_new_tokens=2, prefill_len=3,
                cache1=[{"k": leaf, "v": leaf + 1}], logits=torch.randn(256).bfloat16())
    frame = encode_handoff(h)
    assert {lf["dtype"] for lf in frame["header"]["leaves"]} == {"bfloat16"}
    back = decode_handoff(frame)
    assert back.cache1[0]["k"].dtype == torch.bfloat16
    assert torch.equal(back.cache1[0]["k"], leaf) and torch.equal(back.cache1[0]["v"], leaf + 1)
    assert torch.equal(back.logits, h.logits.float())
    jback = jhandoff.decode_handoff(frame)  # ml_dtypes' bfloat16 on the JAX side: same bits
    assert str(jback.cache1[0]["k"].dtype) == "bfloat16"
    np.testing.assert_array_equal(jback.cache1[0]["k"].view(np.uint16),
                                  leaf.view(torch.int16).numpy().view(np.uint16))


def test_donor_and_migrator_paths_raise_citing_item_14():
    """The stream path is ported (item 14): a handoff registers on a
    ``StateDonor``, and a pull that no donor can serve raises
    ``MigrationError`` (the router's cue to re-prefill)."""
    from dsml_tpu_torch.comm.device_server import DeviceRuntime
    from dsml_tpu_torch.comm.migration import MigrationConfig, MigrationError, ShardMigrator, \
        StateDonor

    h = _pair(False)[1]
    donor = StateDonor(DeviceRuntime(301, mem_size=0x200000, device="cpu"))
    desc = register_with_donor(donor, h)
    assert desc["prefix"] == "handoff/7" and len(donor.keys()) == 5
    assert desc["header"] == encode_handoff(h)["header"]
    mig = ShardMigrator(DeviceRuntime(302, mem_size=0x200000, device="cpu"), 0, [],
                        config=MigrationConfig(timeout_s=2.0, retries=0))
    with pytest.raises(MigrationError, match="no live donor"):
        fetch_from_migrator(mig, desc)
    assert donor.unregister(desc["prefix"]) == 5 and donor.keys() == []


@pytest.fixture(scope="module")
def two_hosts():
    """A prefill host's and a decode host's device servers, over gRPC."""
    from dsml_tpu_torch.comm.device_server import serve_device
    from dsml_tpu_torch.comm.migration import MigrationConfig, ShardMigrator

    recv = serve_device(311, mem_size=0x400000, device="cpu")
    donor = serve_device(312, mem_size=0x400000, device="cpu")
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    mig = ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                        config=MigrationConfig(timeout_s=10.0), local_address=recv.address)
    yield donor.runtime.donor, mig
    mig.close()
    recv.stop()
    donor.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_stream_pull_returns_the_handoff_bit_for_bit(two_hosts, paged):
    donor, mig = two_hosts
    h = _pair(paged)[1]
    back = fetch_from_migrator(mig, register_with_donor(donor, h))
    donor.unregister(f"handoff/{h.frid}")
    assert encode_handoff(back) == encode_handoff(h)


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_fleet_over_the_cross_host_stream_pull(models, mono, two_hosts, kind):
    """Every handoff published on one device server's donor and pulled by
    another's migrator over gRPC: the greedy tokens of the in-process
    handoff, bit for bit."""
    donor, mig = two_hosts
    router = _fleet(models[2], kind, transport=stream_transport(donor, mig))
    assert _fleet_tokens(router, kind) == mono[kind]
    assert donor.keys() == []  # every handoff unregistered after its pull


# ---------------------------------------------------------------------------
# the prefill worker against the JAX one
# ---------------------------------------------------------------------------


def _one_handoff(pw, prompt, max_new=4):
    pw.submit(prompt, max_new, frid=0, key_rid=0)
    for _ in range(64):
        done = pw.step()
        if done:
            return done[0]
    raise AssertionError("prefill did not complete")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "int4_pages"])
def test_prefill_worker_handoff_matches_jax(models, paged):
    jmodel, jparams, tmodel = models
    prompt = _prompts([37], seed=5)[0]
    kw = dict(paged_kv="int4", page_size=8) if paged else {}
    jh = _one_handoff(jserving.PrefillWorker(jmodel, jparams, 8, **kw), prompt.astype(np.int32))
    th = _one_handoff(PrefillWorker(tmodel, 8, **kw), prompt)
    assert (th.prefill_len, th.page_size, th.prefix_rows) == (jh.prefill_len, jh.page_size,
                                                             jh.prefix_rows)
    np.testing.assert_allclose(th.logits.numpy(), np.asarray(jh.logits), rtol=1e-5, atol=1e-5)
    for got, want in zip(th.cache1, jh.cache1):
        assert sorted(got) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            assert tuple(got[key].shape) == w.shape
            if w.dtype == np.uint8:  # int4 codes: bit for bit
                np.testing.assert_array_equal(got[key].numpy(), w)
            else:
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-5)
    if paged:  # the pages the job reserved went back
        assert th.cache1[0]["k"].shape[0] == pages_for(40, 8)


def test_prefix_hit_ships_only_the_suffix(models):
    """A paged worker with ``ship_prefix_pages`` leaves the prefix's full
    pages out of the handoff, as the JAX worker does; a dense worker's
    prefix hit prefills only the suffix."""
    jmodel, jparams, tmodel = models
    prefix = _prompts([24], seed=6)[0]
    prompt = np.concatenate([prefix, _prompts([13], seed=7)[0]])
    handoffs = []
    for pw, cast in ((jserving.PrefillWorker(jmodel, jparams, 8, **PAGED),
                      lambda a: a.astype(np.int32)),
                     (PrefillWorker(tmodel, 8, **PAGED), lambda a: a)):
        pw.register_prefix(cast(prefix))
        pw.ship_prefix_pages = True
        handoffs.append((_one_handoff(pw, cast(prompt)), pw))
    (jh, jpw), (th, tpw) = handoffs
    assert th.prefix_rows == jh.prefix_rows == 24
    assert th.cache1[0]["k"].shape[0] == np.asarray(jh.cache1[0]["k"]).shape[0] == \
        pages_for(40, 8) - 3
    np.testing.assert_array_equal(th.cache1[1]["v"].numpy(), np.asarray(jh.cache1[1]["v"]))
    assert tpw.n_chunk_dispatches == jpw.n_chunk_dispatches
    assert tpw._pages.free_pages == tpw.n_pages - 1 - tpw._registry_pages
    dense = PrefillWorker(tmodel, 8)
    dense.register_prefix(prefix)
    h = _one_handoff(dense, prompt)
    assert dense.n_chunk_dispatches == 2  # the suffix's 2 chunks (registration is setup)
    exact = _one_handoff(dense, prefix.copy())
    assert exact.parent_span == "prefix_hit" and dense.n_chunk_dispatches == 2
    assert h.prefix_rows == 0 and dense.queue_tokens == 0


def test_prefill_worker_load_signals_and_abandon(models):
    tmodel = models[2]
    pw = PrefillWorker(tmodel, 8, max_queue=2)
    assert pw.estimate_ms(16) == 0.0  # nothing measured yet
    pw.submit(_prompts([20])[0], 4, frid=5)
    pw.submit(_prompts([9])[0], 4)
    assert pw.queue_tokens == 29 and pw.n_queued == 2
    with pytest.raises(QueueFull, match="prefill queue at its cap"):
        pw.submit(_prompts([3])[0], 4)
    assert pw.step() == [] and pw.n_pending == 1 and pw.queue_tokens == 21
    assert pw.chunk_s_ewma > 0 and pw.estimate_ms(8) == pytest.approx(
        4 * pw.chunk_s_ewma * 1e3)
    specs = pw.abandon()
    assert [s["frid"] for s in specs] == [5, 6] and pw.queue_tokens == 0
    for bad, match in (((np.zeros(0, np.int64), 2), "empty prompt"),
                       ((_prompts([250])[0], 10), "exceeds max_seq")):
        with pytest.raises(ValueError, match=match):
            pw.submit(*bad)
    with pytest.raises(ValueError, match="prefill_chunk must be in"):
        PrefillWorker(tmodel, 0)


# ---------------------------------------------------------------------------
# fleet tokens: the JAX fleet's and the monolithic batcher's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_fleet_greedy_equals_jax_fleet_and_monolithic(models, jax_fleets, mono, kind):
    router = _fleet(models[2], kind)
    got = _fleet_tokens(router, kind)
    assert got == jax_fleets[kind] == mono[kind]
    if kind == "int4":
        assert all(pw.ship_prefix_pages for pw in router.prefill_workers)
        for dw in router.decode_workers:  # every decode pool back to its registry pages
            assert dw.used_pages == pages_for(len(PREFIX), 8)
        for pw in router.prefill_workers:
            assert pw._pages.used_pages == pw._registry_pages


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_fleet_through_the_frame_codec(models, mono, kind):
    assert _fleet_tokens(_fleet(models[2], kind, transport=frame_transport), kind) == mono[kind]


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_fleet_sampled_equals_monolithic(models, mono, kind):
    tmodel = models[2]
    kw = dict(temperature=0.8, seed=7)
    if kind == "int4":
        ref = ContinuousBatcher(tmodel, n_slots=2, prefill_chunk=8, n_pages=80, **PAGED, **kw)
    else:
        ref = ContinuousBatcher(tmodel, n_slots=2, **kw)
    want = _fleet_tokens(ref, kind)
    assert _fleet_tokens(_fleet(tmodel, kind, **kw), kind) == want
    assert want != mono[kind]  # the sampler drew: not the greedy chains


def test_failing_transport_reprefills_without_token_loss(models, mono):
    calls = {"n": 0}

    def flaky(h):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HandoffIntegrityError("injected wire corruption")
        return frame_transport(h)

    router = _fleet(models[2], "dense", transport=flaky)
    assert _fleet_tokens(router, "dense") == mono["dense"]
    assert router.transport_failures == 1 and router._retries == {}


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_worker_kills_lose_no_tokens(models, mono, kind):
    """A prefill worker dies mid-handoff (tick 1) and a decode worker
    later (tick 6): interrupted requests re-prefill on survivors, with
    tokens equal to the monolithic batcher's."""
    router = _fleet(models[2], kind, max_queue=8)
    prompts, budgets = ((PAGED_PROMPTS, PAGED_BUDGETS) if kind == "int4"
                        else (DENSE_PROMPTS, DENSE_BUDGETS))
    if kind == "int4":
        router.register_prefix(PREFIX)
    frids = [router.submit(p, n) for p, n in zip(prompts, budgets)]
    out, ticks = {}, 0
    while router.outstanding:
        ticks += 1
        router.tick()
        if ticks == 1:
            router.kill_prefill_worker()
        if ticks == 6:
            router.kill_decode_worker()
        out.update(router._results)
        router._results.clear()
    assert [list(map(int, out[f])) for f in frids] == mono[kind]
    assert router.requeued_prefill >= 1 and router.requeued_decode >= 1
    with pytest.raises(RuntimeError, match="last prefill worker"):
        router.kill_prefill_worker()
    with pytest.raises(RuntimeError, match="last decode worker"):
        router.kill_decode_worker()
    assert any(rec["retries"] for rec in router.request_records.values())


def test_speculative_decode_workers_feed_the_cost_model(models, mono):
    router = _fleet(models[2], "dense", speculative_window=3)
    assert all(router.decode_cost_s(dw) == 0.0 for dw in router.decode_workers)
    assert _fleet_tokens(router, "dense") == mono["dense"]
    for dw in router.decode_workers:
        predicted = dw.predicted_tpot_s()
        assert predicted is not None and router.decode_cost_s(dw) == predicted


# ---------------------------------------------------------------------------
# router policy, metrics and validation
# ---------------------------------------------------------------------------


def test_router_sheds_by_class_cap_and_counts_it(models):
    tobs.enable(forensics=False)
    prompt = _prompts([9], seed=6)[0]
    want = _drain(ContinuousBatcher(models[2], n_slots=2), [prompt], [3])[0]
    router = build_fleet(models[2], n_prefill=2, n_decode=1, prefill_chunk=8, n_slots=2,
                         slo_classes=[SLOClass("interactive", max_queue=2),
                                      SLOClass("batch", priority=1)])
    shed = tobs.get_registry().counter("serving_shed_total", labels=("replica", "role"))
    admitted, shed_n = [], 0
    for _ in range(8):
        try:
            admitted.append(router.submit(prompt, 3, slo="interactive"))
        except QueueFull as err:
            assert "SLO class 'interactive' shed (backlog at cap 2)" in str(err)
            shed_n += 1
            admitted.append(router.submit(prompt, 3, slo="batch"))
    assert shed_n == 6 and shed.value(replica="router", role="router") == shed_n
    assert router.shed_counts == {"interactive": 6, "batch": 0}
    out = router.run()
    assert all(list(map(int, out[f])) == want for f in admitted)


def test_router_sheds_on_the_measured_ttft_budget(models):
    router = build_fleet(models[2], n_prefill=1, n_decode=1, prefill_chunk=8, n_slots=2,
                         slo_classes=[SLOClass("interactive", ttft_budget_ms=0.5),
                                      SLOClass("batch", priority=1)])
    warm = _prompts([17], seed=7)[0]
    assert router.estimate_ttft_ms(32) == 0.0  # nothing measured: the cap rules
    router.submit(warm, 2, slo="batch")
    router.run()
    assert router.prefill_workers[0].chunk_s_ewma is not None
    for p in _prompts([64] * 6, seed=8):
        router.submit(p, 2, slo="batch")
    assert router.estimate_ttft_ms(32) > 0.5
    with pytest.raises(QueueFull, match="estimated TTFT"):
        router.submit(warm, 2, slo="interactive")
    router.run()


def test_unknown_class_mixed_fleet_and_edge_validation(models):
    tmodel = models[2]
    router = build_fleet(tmodel, prefill_chunk=8, n_slots=2)
    with pytest.raises(ValueError, match="unknown SLO class 'nope'"):
        router.submit(np.asarray([1, 2, 3]), 2, slo="nope")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        router.submit(_prompts([250])[0], 10)
    paged = ContinuousBatcher(tmodel, n_slots=2, n_pages=40, **PAGED)
    with pytest.raises(ValueError, match="mixed fleet"):
        Router([PrefillWorker(tmodel, 8)], [paged])
    with pytest.raises(ValueError, match="disagrees on"):
        Router([PrefillWorker(tmodel, 8, paged_kv="int8", page_size=8)], [paged])
    with pytest.raises(ValueError, match="duplicate SLO class"):
        Router([PrefillWorker(tmodel, 8)], [ContinuousBatcher(tmodel)],
               slo_classes=[SLOClass("a"), SLOClass("a")])
    with pytest.raises(ValueError, match="need at least one"):
        Router([], [paged])
    # devices: a slice of one device is a batcher there; of two, a tp = 2 worker of
    # two rank processes (tests/test_torch_fleet_tp.py serves through them)
    two = build_fleet(tmodel, n_decode=2, prefill_chunk=8, devices=["cpu", "cpu"])
    assert len(two.decode_workers) == 2
    with build_fleet(tmodel, n_decode=2, prefill_chunk=8, devices=["cpu"] * 4) as four:
        assert len(four.decode_workers) == 2
        assert all(dw.mesh.shape["tp"] == 2 for dw in four.decode_workers)
    assert not [dw.alive_pids() for dw in four.decode_workers if dw.alive_pids()]
    with pytest.raises(ValueError, match="cannot back"):
        build_fleet(tmodel, n_decode=2, prefill_chunk=8, devices=["cpu"])


def test_role_labels_split_the_fleet_metrics(models):
    tobs.enable(forensics=False)
    reg = tobs.get_registry()
    router = build_fleet(models[2], n_prefill=1, n_decode=1, prefill_chunk=8, n_slots=2,
                         **PAGED)
    for p, n in zip(_prompts([6, 18], seed=10), (4, 4)):
        router.submit(p, n)
    router.run()
    assert reg.counter("serving_tokens_total", labels=("replica", "role")).value(
        replica="0", role="decode") == 8
    assert reg.counter("serving_handoffs_total", labels=("replica", "role")).value(
        replica="0", role="prefill") == 2
    for name, replica, role in (("serving_ttft_ms", "router", "router"),
                                ("serving_tpot_ms", "0", "decode"),
                                ("serving_prefill_chunk_ms", "0", "prefill"),
                                ("serving_admission_ms", "0", "decode")):
        assert reg.histogram(name, labels=("replica", "role")).summary(
            replica=replica, role=role)["count"] > 0, name
    depth = reg.gauge("serving_queue_depth", labels=("replica", "role"))
    assert depth.value(replica="0", role="prefill") == 0
    assert depth.value(replica="router", role="router") == 0
    text = reg.to_prometheus_text()  # the pool gauges refresh at scrape time, per role
    assert 'serving_page_pool_free{replica="0",role="prefill"}' in text
    assert 'serving_page_pool_free{replica="0",role="decode"}' in text


def test_sample_buffer_is_bounded(models, monkeypatch):
    monkeypatch.setenv("DSML_SERVING_SAMPLES", "2")
    tobs.enable(forensics=False)
    router = build_fleet(models[2], prefill_chunk=8, n_slots=2)
    for p in _prompts([5, 6, 7, 8, 9], seed=11):
        router.submit(p, 3)
    router.run()
    assert len(router.latency_samples) == 2 and router.dropped_samples == 3
    assert len(router.request_records) == 2
    assert tobs.get_registry().counter("serving_samples_dropped_total",
                                       labels=("replica", "role")).value(
        replica="router", role="router") == 3


# ---------------------------------------------------------------------------
# inject
# ---------------------------------------------------------------------------


def _inject_errors(dw, cache1, logits, pages, prompt):
    """Every validation error of ``inject`` on ``dw`` (dense or paged), in
    order: (exception type name, message)."""
    calls = []
    if not dw.paged:
        calls += [lambda: dw.inject(prompt, 4, cache1[:1], logits),
                  lambda: dw.inject(prompt, 4, cache1, logits, kv_pages=pages, page_size=8),
                  lambda: dw.inject(prompt[:0], 4, cache1, logits),
                  lambda: dw.inject(prompt, 300, cache1, logits)]
    else:
        calls += [lambda: dw.inject(prompt, 2, cache1, logits),
                  lambda: dw.inject(prompt, 2, logits_row=logits, kv_pages=pages, page_size=16),
                  lambda: dw.inject(prompt, 2, logits_row=logits, kv_pages=pages[:1],
                                    page_size=8),
                  lambda: dw.inject(prompt, 2, logits_row=logits,
                                    kv_pages=[{"k": pages[0]["k"]}] * 2, page_size=8),
                  lambda: dw.inject(prompt, 2, logits_row=logits, kv_pages=pages, page_size=8,
                                    prefix_rows=5),
                  lambda: dw.inject(np.arange(1, 20), 2, logits_row=logits, kv_pages=pages,
                                    page_size=8, prefix_rows=8),
                  lambda: dw.inject(np.arange(1, 20), 200, logits_row=logits, kv_pages=pages,
                                    page_size=8)]
    out = []
    for call in calls:
        with pytest.raises((ValueError, RuntimeError)) as err:
            call()
        out.append((type(err.value).__name__, str(err.value)))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inject_validation_texts_equal_jax(models, paged):
    jmodel, jparams, tmodel = models
    kw = dict(n_slots=2, n_pages=20, **PAGED) if paged else dict(n_slots=1, max_queue=1)
    jdw, tdw = jserving.ContinuousBatcher(jmodel, jparams, **kw), ContinuousBatcher(tmodel, **kw)
    prompt = np.asarray([1, 2, 3])
    jcache = jmodel.init_cache(1)
    tcache = tmodel.init_cache(1)
    zeros = np.zeros(CFG["vocab_size"], np.float32)
    jpages = [{k: np.zeros((1, *np.asarray(a).shape[1:]), np.asarray(a).dtype)
               for k, a in layer.items()} for layer in jdw._pool] if paged else None
    tpages = [{k: torch.zeros((1, *a.shape[1:]), dtype=a.dtype) for k, a in layer.items()}
              for layer in tdw._pool] if paged else None
    if not paged:  # a dense worker handed pages: any non-None payload
        jpages = tpages = [{"k": np.zeros((1, 4, 8, 8), np.uint8)}] * 2
    want = _inject_errors(jdw, jcache, zeros, jpages, prompt.astype(np.int32))
    got = _inject_errors(tdw, tcache, torch.zeros(CFG["vocab_size"]), tpages, prompt)
    assert got == want
    if not paged:  # the inject queue's cap sheds as the JAX batcher's does
        tdw.inject(prompt, 4, tcache, torch.zeros(CFG["vocab_size"]))
        with pytest.raises(QueueFull, match="admission queue at its cap"):
            tdw.inject(prompt, 4, tcache, torch.zeros(CFG["vocab_size"]))
        assert len(tdw.run()) == 1


def test_abandon_evacuates_injected_requests(models):
    tmodel = models[2]
    h = _one_handoff(PrefillWorker(tmodel, 8), _prompts([9], seed=12)[0])
    dw = ContinuousBatcher(tmodel, n_slots=1)
    rid = dw.inject(h.prompt, 4, h.cache1, h.logits)
    assert dw.n_injected == 1 and dw.n_active == 0
    assert [r.rid for r in dw.abandon()] == [rid]
    assert dw.n_injected == 0 and dw.run() == {}
    paged = ContinuousBatcher(tmodel, n_slots=1, n_pages=20, **PAGED)
    hp = _one_handoff(PrefillWorker(tmodel, 8, **PAGED), _prompts([9], seed=12)[0])
    paged.inject(hp.prompt, 4, logits_row=hp.logits, kv_pages=hp.cache1, page_size=8)
    paged.step()
    assert paged.n_active == 1 and paged.free_pages < paged.n_pages - 1
    paged.abandon()
    assert paged.free_pages == paged.n_pages - 1


def test_preemption_keeps_an_injected_slots_cow_boundary(models):
    """A paged handoff admission records its shared prefix pages: a later
    eviction drops the reference instead of swapping registry pages out.
    Fleet + preemption drains with the monolithic tokens, preemptions
    exercised, every decode pool back to its registry pages."""
    tmodel = models[2]
    rng = np.random.default_rng(30)
    prefix = rng.integers(1, CFG["vocab_size"], 16)  # 2 pages
    prompts = [np.concatenate([prefix, rng.integers(1, CFG["vocab_size"], 5)]) for _ in range(3)]
    ref = ContinuousBatcher(tmodel, n_slots=3, prefill_chunk=8, n_pages=60, **PAGED)
    want = _drain(ref, prompts, [10] * 3, prefix)
    router = build_fleet(tmodel, n_prefill=1, n_decode=1, prefill_chunk=8, n_slots=3, n_pages=8,
                         preemption=True, **PAGED)
    router.register_prefix(prefix)
    dw = router.decode_workers[0]
    frids = [router.submit(p, 10) for p in prompts]
    shared = 0
    for _ in range(10_000):
        if not router.outstanding:
            break
        router.tick()
        for s in np.flatnonzero(dw._slot_rid >= 0):
            shared = max(shared, int(dw._slot_shared[int(s)]))
    out = router.run(max_ticks=1)
    assert [list(map(int, out[f])) for f in frids] == want
    assert dw.n_preemptions > 0 and shared == 2
    assert dw.used_pages == pages_for(len(prefix), 8)


def test_paged_decode_only_worker_admits_by_inject_only(models):
    tmodel = models[2]
    dw = ContinuousBatcher(tmodel, n_slots=2, n_pages=40, **PAGED)  # prefill_chunk=0
    with pytest.raises(ValueError, match="decode-only paged workers admit via inject"):
        dw.submit(np.asarray([1, 2, 3]), 2)
    h = _one_handoff(PrefillWorker(tmodel, 8, **PAGED), _prompts([30], seed=14)[0], 5)
    rid = dw.inject(h.prompt, 5, logits_row=h.logits, kv_pages=h.cache1, page_size=8,
                    key_rid=0)
    want = _drain(ContinuousBatcher(tmodel, n_slots=2, prefill_chunk=8, n_pages=40, **PAGED),
                  [h.prompt], [5])[0]
    assert list(map(int, dw.run()[rid])) == want and dw.free_pages == dw.n_pages - 1


# ---------------------------------------------------------------------------
# request tracing and SLO accounting through the fleet
# ---------------------------------------------------------------------------


def test_a_fleet_requests_trace_holds_prefill_handoff_and_decode(models):
    tobs.enable(forensics=False)
    router = build_fleet(models[2], n_prefill=1, n_decode=1, prefill_chunk=8, n_slots=2,
                         slo_classes=[SLOClass("interactive", ttft_budget_ms=1e6,
                                               tpot_budget_ms=1e6, objective=0.9)],
                         transport=frame_transport)
    frid = router.submit(_prompts([20], seed=15)[0], 4, slo="interactive")
    tid = router.trace_of(frid).trace_id
    router.run()
    summary = trace_summary(stitch_traces([snapshot(role="fleet")]))[tid]
    assert {"router_submit", "prefill_chunk", "serving_first_token"} <= set(summary["names"])
    assert summary["flow"] == {"s": 1, "t": 2, "f": 1}  # handoff and inject steps, one end
    rec = router.request_records[frid]
    assert rec["trace_id"] == tid and set(rec["stages_s"]) == {
        "queue", "prefill", "handoff", "first_decode", "decode"}
    report = router.slo.report()["interactive"]
    assert report["requests"] == report["good_requests"] == 1 and report["status"] == "ok"
    assert report["tail"]["worst_trace_id"] == tid
