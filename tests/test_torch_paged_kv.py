"""The port's continuous batcher and page allocator
(``dsml_tpu_torch.serving``) — within the port, and against the JAX
package's.

Within the port (the counterparts of ``tests/test_paged_kv.py``): the paged
cache is a pure capacity optimisation, so greedy tokens through paged int4
pages equal the dense ``kv_quant="int4"`` batcher's bit for bit (and paged
fp equals the plain dense cache), whatever the pool's backpressure, CoW
prefix sharing or preemption did; every page comes back. Sampled tokens
depend only on (seed, rid, step). Against JAX: the allocator's plans, and
greedy tokens of the two batchers at f32 for fp and int4 pages."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.serving import ContinuousBatcher as JaxBatcher
from dsml_tpu.serving import paging as jpaging
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.serving import ContinuousBatcher, QueueFull
from dsml_tpu_torch.serving import batcher as tbatcher
from dsml_tpu_torch.serving import paging as tpaging

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGED = dict(prefill_chunk=8, paged_kv="int4", page_size=8)


@pytest.fixture(scope="module")
def setup():
    cfg = tgpt2.GPT2Config.tiny()  # max_seq 128, 8 heads, d 64 -> hd 8
    model = tgpt2.GPT2(cfg, device="cpu").init(0)
    m4 = tgpt2.GPT2(dataclasses.replace(cfg, kv_quant="int4"), device="cpu")
    m4.load_state_dict(model.state_dict())
    return cfg, model, m4


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int64) for n in lengths]


def _drain(batcher, prompts, budgets, **kw):
    rids = [batcher.submit(p, n, **kw) for p, n in zip(prompts, budgets)]
    out = batcher.run()
    return [out[r] for r in rids]


# ---------------------------------------------------------------------------
# the allocator against JAX
# ---------------------------------------------------------------------------


def _allocator_script(paging):
    """One scripted sequence over PagePool + plan_admission → every
    observable: pages handed out, refcounts, free counts and the Nones."""
    def view(plan):
        return None if plan is None else (plan.pages, plan.n_shared, plan.copy)

    pool = paging.PagePool(32)
    seen = [pool.alloc(3), pool.free_pages]
    prefix = pool.alloc(2)
    seen.append(prefix)
    for rows, plen in ((20, 12), (9, 16), (40, 12), (70, 12), (16, 0)):
        seen.append(view(paging.plan_admission(pool, 8, rows, prefix_pages=prefix, prefix_len=plen)))
        seen.append([pool.refcount(p) for p in range(32)])
    pool.release(seen[0][:2])
    pool.share(prefix)
    seen += [pool.free_pages, pool.used_pages, pool.shared_pages, pool.alloc(1),
             view(paging.plan_admission(pool, 8, 20, prefix, 12, share_prefix=False)),
             view(paging.plan_admission(pool, 8, 30, prefix, 12)),
             view(paging.plan_admission(pool, 8, 800, prefix, 12)),  # cannot fit: None
             pool.free_pages, paging.pages_for(17, 8)]
    free = next(p for p in range(1, 32) if pool.refcount(p) == 0)
    assert None in seen
    for bad in (lambda: pool.release([0]), lambda: pool.release([free]), lambda: pool.alloc(100),
                lambda: pool.share([free])):
        with pytest.raises(RuntimeError) as err:
            bad()
        seen.append(str(err.value))
    return seen


def test_allocator_plans_match_jax():
    assert _allocator_script(tpaging) == _allocator_script(jpaging)


# ---------------------------------------------------------------------------
# the batcher within the port
# ---------------------------------------------------------------------------


def test_paged_batcher_matches_dense_same_codec(setup):
    cfg, model, m4 = setup
    prompts = _prompts(cfg, [5, 17, 32, 9, 26], seed=4)
    budgets = [5, 3, 6, 5, 3]
    want4 = _drain(ContinuousBatcher(m4, n_slots=2, prefill_chunk=8), prompts, budgets)
    paged = ContinuousBatcher(model, n_slots=2, n_pages=40, **PAGED)
    assert _drain(paged, prompts, budgets) == want4
    assert paged.free_pages == paged.n_pages - 1  # everything reclaimed
    want = _drain(ContinuousBatcher(model, n_slots=2, prefill_chunk=8), prompts, budgets)
    paged_fp = ContinuousBatcher(model, n_slots=2, prefill_chunk=8, paged_kv="fp", page_size=8,
                                 n_pages=40)
    assert _drain(paged_fp, prompts, budgets) == want
    # whole-prompt bucketed admission gives the chunked path's tokens
    assert _drain(ContinuousBatcher(model, n_slots=2), prompts, budgets) == want


def test_paged_capacity_backpressure_and_reuse(setup):
    """A pool too small for every request at once: admissions wait for
    pages and the drain completes with the same tokens; a request that can
    never fit fails at submit."""
    cfg, model, m4 = setup
    prompts = _prompts(cfg, [30, 28, 25, 27], seed=6)
    want = _drain(ContinuousBatcher(m4, n_slots=4, prefill_chunk=8), prompts, [6] * 4)
    paged = ContinuousBatcher(model, n_slots=4, n_pages=11, **PAGED)
    assert _drain(paged, prompts, [6] * 4) == want
    assert paged.free_pages == 10
    with pytest.raises(ValueError, match="ever reservable"):
        paged.submit(_prompts(cfg, [100], seed=7)[0], 20)


def test_cow_prefix_pages_shared_and_reclaimed(setup):
    cfg, model, _ = setup
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, cfg.vocab_size, 20).astype(np.int64)  # 2 full pages + a straddle
    prompts = [np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 7)]) for _ in range(3)]
    want = _drain(ContinuousBatcher(model, n_slots=3, n_pages=60, **PAGED), prompts, [5] * 3)

    srv = ContinuousBatcher(model, n_slots=3, n_pages=60, **PAGED)
    srv.register_prefix(prefix)
    base_used = srv.used_pages
    assert base_used == tpaging.pages_for(len(prefix), 8) == 3
    rids = [srv.submit(p, 5) for p in prompts]
    srv.step()
    assert srv.shared_pages == 2 and srv.n_cow_copies >= 1  # live sharing, private straddles
    out = srv.run()
    assert [out[r] for r in rids] == want
    assert srv.used_pages == base_used  # request pages reclaimed, the registry's kept

    # exact hit: the whole prompt is the prefix, admitted with no prefill
    srv2 = ContinuousBatcher(model, n_slots=2, n_pages=60, **PAGED)
    srv2.register_prefix(prefix)
    before = srv2.n_prefill_dispatches
    rid = srv2.submit(prefix, 4)
    got = srv2.run()[rid]
    assert srv2.n_prefill_dispatches == before
    assert got == _drain(ContinuousBatcher(model, n_slots=2, n_pages=60, **PAGED), [prefix], [4])[0]


def test_dense_prefix_cache_gives_the_same_tokens(setup):
    cfg, model, _ = setup
    rng = np.random.default_rng(8)
    prefix = rng.integers(1, cfg.vocab_size, 11).astype(np.int64)
    prompts = [prefix, np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 9)])]
    want = _drain(ContinuousBatcher(model, n_slots=2, prefill_chunk=8), prompts, [4, 4])
    srv = ContinuousBatcher(model, n_slots=2, prefill_chunk=8)
    srv.register_prefix(prefix)
    assert _drain(srv, prompts, [4, 4]) == want
    assert srv.n_insert_dispatches == 1  # the exact hit copied the stored rows


def test_never_fits_accounts_for_registry_pages(setup):
    cfg, model, _ = setup
    rng = np.random.default_rng(16)
    prefix = rng.integers(1, cfg.vocab_size, 48).astype(np.int64)  # 6 pages
    srv = ContinuousBatcher(model, n_slots=2, n_pages=10, **PAGED)
    srv.register_prefix(prefix)  # 9 usable - 6 registry = 3 reservable
    with pytest.raises(ValueError, match="ever reservable"):
        srv.submit(rng.integers(1, cfg.vocab_size, 50), 10)
    rid = srv.submit(np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 6)]), 6)
    assert len(srv.run()[rid]) == 6


def _pressure_prompts(cfg, seed=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int64) for n in (17, 9, 13)], [12, 12, 10]


@pytest.mark.parametrize("policy", ["auto", "swap", "recompute"])
def test_preemption_under_pressure_identical_tokens(setup, policy):
    cfg, model, _ = setup
    prompts, budgets = _pressure_prompts(cfg)
    want = _drain(ContinuousBatcher(model, n_slots=3, n_pages=40, **PAGED), prompts, budgets)
    srv = ContinuousBatcher(model, n_slots=3, n_pages=8, preemption=True, preempt_policy=policy,
                            **PAGED)
    assert _drain(srv, prompts, budgets) == want
    assert srv.n_preemptions > 0
    if policy == "swap":
        assert srv.n_swap_evictions == srv.n_preemptions
    elif policy == "recompute":
        assert srv.n_recompute_evictions == srv.n_preemptions
    assert srv.free_pages == srv.n_pages - 1 and srv.n_preempted == 0


def test_preemption_victim_order_priority_then_youngest(setup):
    _, model, _ = setup
    srv = ContinuousBatcher(model, n_slots=3, n_pages=20, preemption=True, **PAGED)
    srv._slot_rid[:] = [5, 6, 7]
    srv._slot_prio[:] = [1, 0, 0]
    assert srv._pick_victim() == 2  # priority 0, youngest rid 7
    assert srv._pick_victim(exclude=2) == 1
    srv._slot_rid[:] = [5, -1, -1]
    assert srv._pick_victim(exclude=0) is None


def test_preemption_priority_protects_high_priority_slot(setup):
    cfg, model, _ = setup
    prompts, budgets = _pressure_prompts(cfg)
    want = _drain(ContinuousBatcher(model, n_slots=3, n_pages=40, **PAGED), prompts, budgets)
    srv = ContinuousBatcher(model, n_slots=3, n_pages=8, preemption=True, **PAGED)
    evicted, orig = [], srv._evict_slot
    srv._evict_slot = lambda slot: (evicted.append(int(srv._slot_rid[slot])), orig(slot))
    rids = [srv.submit(p, n, priority=10 if i == 0 else 0)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    out = srv.run()
    assert [out[r] for r in rids] == want
    assert evicted and rids[0] not in evicted


def test_preemption_never_evicts_shared_cow_pages(setup):
    cfg, model, _ = setup
    rng = np.random.default_rng(22)
    prefix = rng.integers(1, cfg.vocab_size, 16).astype(np.int64)  # 2 pages
    prompts = [np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 5)]) for _ in range(3)]
    plain = ContinuousBatcher(model, n_slots=3, n_pages=40, **PAGED)
    plain.register_prefix(prefix)
    want = _drain(plain, prompts, [10] * 3)
    srv = ContinuousBatcher(model, n_slots=3, n_pages=8, preemption=True, **PAGED)
    srv.register_prefix(prefix)
    reg = list(srv._prefixes[0][1])
    master = [{k: a[reg].clone() for k, a in layer.items()} for layer in srv._pool]
    rids = [srv.submit(p, 10) for p in prompts]
    out, min_ref = {}, 10 ** 9
    while srv.n_active or srv.n_queued or srv.n_pending or srv.n_preempted:
        out.update(srv.step())
        min_ref = min(min_ref, *(srv._pages.refcount(p) for p in reg))
    out.update(srv.collect())
    assert [out[r] for r in rids] == want
    assert srv.n_preemptions > 0 and min_ref >= 1
    for layer, m in zip(srv._pool, master):
        assert all(torch.equal(layer[k][reg], m[k]) for k in m)  # registry bytes untouched
    assert srv.used_pages == len(reg)


def test_sampled_tokens_independent_of_slots_and_quantum(setup):
    cfg, model, m4 = setup
    prompts = _prompts(cfg, [6, 14, 23, 9], seed=5)
    kw = dict(temperature=0.8, top_k=20, seed=7, prefill_chunk=8)
    want = _drain(ContinuousBatcher(model, n_slots=2, **kw), prompts, [6] * 4)
    assert _drain(ContinuousBatcher(model, n_slots=3, decode_quantum=3, **kw), prompts, [6] * 4) \
        == want
    assert _drain(ContinuousBatcher(model, n_slots=1, decode_quantum=2, **kw), prompts, [6] * 4) \
        == want
    assert _drain(ContinuousBatcher(model, n_slots=4, **kw), prompts, [6] * 4) == want
    # paged int4 samples what the dense int4 cache samples
    kw4 = dict(temperature=0.8, top_k=20, seed=7, n_slots=2)
    want4 = _drain(ContinuousBatcher(m4, prefill_chunk=8, **kw4), prompts, [6] * 4)
    assert _drain(ContinuousBatcher(model, n_pages=40, **kw4, **PAGED), prompts, [6] * 4) == want4
    # deterministic in the seed, and the seed matters
    assert _drain(ContinuousBatcher(model, n_slots=2, **kw), prompts, [6] * 4) == want
    other = _drain(ContinuousBatcher(model, n_slots=2, **{**kw, "seed": 8}), prompts, [6] * 4)
    assert other != want
    # the sampler key follows key_rid, not the local rid
    srv = ContinuousBatcher(model, n_slots=2, **kw)
    srv.submit(prompts[0], 2)  # shifts the local rids by one
    got = _drain(srv, prompts, [6] * 4, key_rid=None)
    assert got != want
    srv2 = ContinuousBatcher(model, n_slots=2, **kw)
    srv2.submit(prompts[0], 2)
    rids = [srv2.submit(p, 6, key_rid=i) for i, p in enumerate(prompts)]
    out = srv2.run()
    assert [out[r] for r in rids] == want


def test_request_uniform_is_a_counter_hash():
    keys = torch.tensor([tbatcher.request_key(7, r) for r in range(3)])
    u = tbatcher.request_uniform(keys, torch.tensor([0, 0, 5]), 1000)
    assert u.dtype == torch.float32 and u.shape == (3, 1000)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # each (request, step) row is its own: batch composition changes nothing
    solo = tbatcher.request_uniform(keys[2:], torch.tensor([5]), 1000)
    assert torch.equal(solo[0], u[2])
    # roughly uniform: mean 1/2, variance 1/12
    assert abs(float(u.mean()) - 0.5) < 0.02 and abs(float(u.var()) - 1 / 12) < 0.01
    assert tbatcher.request_key(7, 1) != tbatcher.request_key(8, 1) != tbatcher.request_key(7, 2)


def test_queue_cap_abandon_and_latency_stats(setup):
    cfg, model, _ = setup
    prompts = _prompts(cfg, [9, 12, 7], seed=9)
    srv = ContinuousBatcher(model, n_slots=1, max_queue=2, n_pages=40, **PAGED)
    srv.submit(prompts[0], 4)
    srv.submit(prompts[1], 4)
    with pytest.raises(QueueFull):
        srv.submit(prompts[2], 4)
    srv.step()
    live = srv.abandon()
    assert len(live) == 2 and srv.free_pages == srv.n_pages - 1 and srv.n_active == 0
    _drain(srv, prompts[:2], [3, 3])
    stats = srv.latency_stats()
    assert stats["n_requests"] == 2 and stats["ttft_p50_s"] <= stats["e2e_p99_s"]
    assert srv.n_plain_ticks > 0 and srv.n_prefill_dispatches >= 2


def test_constructor_and_submit_validation(setup, monkeypatch):
    cfg, model, _ = setup
    # a mesh serves tensor-parallel (tests/test_torch_tp_serving.py); quantized
    # weights stay single-device, as in the JAX batcher
    with pytest.raises(ValueError, match="single-device replicas"):
        ContinuousBatcher(model, mesh=object(), weight_quant="int8")
    # the turbo, adaptive and speculative ticks (item 5) are ported, with the
    # JAX validation (tests/test_torch_speculative.py holds every message)
    assert ContinuousBatcher(model, turbo_factor=2).turbo_factor == 2
    assert ContinuousBatcher(model, adaptive_quantum=4).adaptive_quantum == 4
    assert ContinuousBatcher(model, speculative_window=3).speculative_window == 3
    with pytest.raises(ValueError, match="speculative_adaptive adapts"):
        ContinuousBatcher(model, speculative_adaptive=True)
    # weight_quant (item 4) is ported: explicit or through the env knob
    assert ContinuousBatcher(model, weight_quant="int8").weight_quant == "int8"
    monkeypatch.setenv("DSML_WEIGHT_QUANT", "int4")
    assert ContinuousBatcher(model).weight_quant == "int4"
    monkeypatch.setenv("DSML_WEIGHT_QUANT", "off")
    srv = ContinuousBatcher(model, n_pages=20, **PAGED)  # "off" serves full-precision weights
    with pytest.raises(ValueError, match="weight_quant must be"):
        ContinuousBatcher(model, weight_quant="int3")
    # inject (item 13) is ported: a paged worker takes pages, not a dense cache
    with pytest.raises(ValueError, match="inject needs kv_pages="):
        srv.inject(np.ones(3), 2)
    with pytest.raises(ValueError, match="one process per device"):
        ContinuousBatcher.for_devices(model, ["cpu", "cpu"])  # no rank, no rendezvous
    assert ContinuousBatcher.for_devices(model, ["cpu"]).n_slots == 8
    with pytest.raises(ValueError, match="preemption is a paged_kv"):
        ContinuousBatcher(model, preemption=True)
    with pytest.raises(ValueError, match="preempt_policy"):
        ContinuousBatcher(model, preempt_policy="lru")
    with pytest.raises(ValueError, match="page_size must divide"):
        ContinuousBatcher(model, prefill_chunk=8, paged_kv="int4", page_size=7)
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        ContinuousBatcher(model, paged_kv="int4", page_size=8).submit(np.ones(4), 2)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        ContinuousBatcher(model, prompt_buckets=(16, 32)).submit(np.ones(40), 2)
    with pytest.raises(ValueError, match="unknown page quant mode"):
        ContinuousBatcher(model, prefill_chunk=8, paged_kv="int2")


# ---------------------------------------------------------------------------
# the batcher against JAX
# ---------------------------------------------------------------------------


def _margins(model, prompt, tokens):
    """Top-2 logit margin at each greedy step, teacher-forced with
    ``tokens`` through the port's plain prefill — printed on a mismatch."""
    out = []
    for i in range(len(tokens)):
        seq = np.concatenate([prompt, np.asarray(tokens[:i], np.int64)])
        logits, _ = model.prefill(torch.from_numpy(seq[None]))
        top2 = logits[0].topk(2).values
        out.append(round(float(top2[0] - top2[1]), 6))
    return out


def test_paged_batcher_serves_from_checkpoint(setup, tmp_path):
    """``ContinuousBatcher.from_checkpoint`` (it raised before the
    checkpointing slice): a training checkpoint ({params, opt_state, meta})
    served through int4 pages gives the tokens of a batcher built from the
    in-memory weights, the optimizer state unread; ``param_dtype`` serves
    the weights in bf16 from the f32 checkpoint."""
    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.checkpoint.optim_state import optax_state, param_tree

    cfg, model, _ = setup
    opt = torch.optim.AdamW(model.parameters(), lr=0.0)
    with CheckpointManager(str(tmp_path / "ck")) as m:
        m.save(5, {"params": param_tree(model), "opt_state": optax_state(opt, model, "adamw", 5),
                   "meta": {"epoch": 5}})
    prompts = _prompts(cfg, [5, 21, 12, 30], seed=3)
    budgets = [6, 4, 7, 5]
    kw = dict(n_slots=2, n_pages=40, **PAGED)
    want = _drain(ContinuousBatcher(model, **kw), prompts, budgets)
    fresh = tgpt2.GPT2(cfg, device="cpu")  # uninitialised: every weight comes from the checkpoint
    srv = ContinuousBatcher.from_checkpoint(fresh, str(tmp_path / "ck"), **kw)
    assert _drain(srv, prompts, budgets) == want
    assert srv.free_pages == srv.n_pages - 1
    bf16 = ContinuousBatcher.from_checkpoint(fresh, str(tmp_path / "ck"),
                                             param_dtype=torch.bfloat16, **kw)
    assert bf16.model.config.dtype == "bfloat16"
    assert torch.equal(bf16.model.wte, model.wte.to(torch.bfloat16))


@pytest.mark.parametrize("paged_kv", ["fp", "int4"])
def test_batcher_greedy_tokens_match_jax(paged_kv):
    """Staggered requests (three at first, two more after two ticks)
    through both batchers at f32 from the same weights. The two packages
    sum the f32 projections in another order, so an int4 row whose x/s
    lies within ~1e-5 of a half-integer may land one step apart; seed 11's
    weights and prompts hit no such tie."""
    jcfg = jgpt2.GPT2Config.tiny()
    jmodel = jgpt2.GPT2(jcfg)
    jparams = jmodel.init(11)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    prompts = _prompts(tmodel.config, [5, 21, 12, 30, 9], seed=11)
    budgets = [6, 4, 7, 5, 6]
    kw = dict(n_slots=2, prefill_chunk=8, paged_kv=paged_kv, page_size=8, n_pages=40)
    jsrv, tsrv = JaxBatcher(jmodel, jparams, **kw), ContinuousBatcher(tmodel, **kw)
    results = []
    for srv, cast in ((jsrv, lambda p: p.astype(np.int32)), (tsrv, lambda p: p)):
        rids = [srv.submit(cast(p), n) for p, n in zip(prompts[:3], budgets[:3])]
        srv.step()
        srv.step()
        rids += [srv.submit(cast(p), n) for p, n in zip(prompts[3:], budgets[3:])]
        done = srv.run()
        results.append([list(map(int, done[r])) for r in rids])
    want, got = results
    assert got == want, (
        f"greedy tokens differ:\nport {got}\njax  {want}\n"
        f"top-2 margins per step: {[_margins(tmodel, p, w) for p, w in zip(prompts, want)]}")
    assert tsrv.free_pages == tsrv.n_pages - 1


def test_serve_continuous_cli_runs_and_logs():
    proc = subprocess.run(
        [sys.executable, "-m", "dsml_tpu_torch.cli.serve_continuous", "--device", "cpu",
         "--model", "tiny", "--requests", "6", "--paged_kv", "int4", "--prefill_chunk", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    for line in ("dsml.serve: workload: 6 requests", "dsml.serve: continuous:",
                 "dsml.serve: static    :", "dsml.serve: tokens/s: continuous",
                 "dsml.serve: paged KV (int4)"):
        assert line in proc.stderr, proc.stderr
