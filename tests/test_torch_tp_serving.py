"""The port's tensor-parallel serving (``GPT2.generate_spmd``, the batcher's
``mesh``, ``for_devices``, ``from_checkpoint(mesh=)`` and ``generate_text
--tp``) against the JAX package and the port's single-device serving, on
the CPU.

Two spawns over gloo, once for the module: two ranks (a tp = 2 mesh) and
four (a tp = 4 mesh, then dp = 2 × tp = 2 in the same processes). Every
rank takes the JAX ``init`` weights through ``params_from_jax`` (the whole
model, which the batcher cuts, or the rank's shard), serves, and saves
its tokens and logits. The JAX references (``generate_spmd`` and the tp
batcher on the 8 virtual CPU devices) run in this process while the ranks
work. The scenarios are the JAX suite's tp tests (``tests/
test_generate.py``, ``test_serving.py``, ``test_paged_kv.py``,
``test_serving_adaptive.py``), plus the port's other tick kinds against
its own single-device batcher."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.cli import generate_text
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.parallel import tp as ttp
from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from dsml_tpu_torch.serving import ContinuousBatcher

SEED = 13
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GEN_NEW = 10  # tests/test_generate.py::test_tp_sharded_generate_matches_single_device
DP_PROMPT = (8, 6)  # tests/test_generate.py::test_generate_spmd_dp_sharded_matches_unsharded
PAGED = dict(prefill_chunk=8, page_size=8)

# name: (family, init seed, config changes, prompt lengths, prompt seed, budgets,
#        batcher kwargs, held against the JAX tp batcher)
SCENARIOS = {
    # tests/test_serving.py::test_tp_sharded_batcher_matches_single_device
    "dense_quantum3": ("gpt2", 10, {}, [5, 17, 9, 26], 10, [6] * 4,
                       dict(n_slots=2, prompt_buckets=(8, 32), decode_quantum=3), True),
    # tests/test_serving.py::test_tp_sharded_batcher_llama_kv_quant
    "llama_kv_quant": ("llama", 11, {"kv_quant": True}, [7, 13], 11, [5, 5],
                       dict(n_slots=2, prompt_buckets=(16,)), True),
    # tests/test_paged_kv.py::test_tp2_paged_batcher_matches_single_device, under
    # the pool pressure of tests/test_torch_paged_kv.py's preemption tests
    "paged_int4_preempt": ("gpt2", 0, {}, [17, 9, 13], 20, [12, 12, 10],
                           dict(n_slots=3, n_pages=8, preemption=True, paged_kv="int4", **PAGED),
                           True),
    # tests/test_serving_adaptive.py::test_adaptive_tp_matches_single_device
    "adaptive": ("gpt2", 5, {}, [5, 12, 9], 5, [15] * 3,
                 dict(n_slots=2, prompt_buckets=(16,), adaptive_quantum=32), True),
    # tests/test_serving.py::test_speculative_batcher_llama_and_tp
    "speculative": ("llama", 18, {}, [7, 21, 12], 18, [6] * 3,
                    dict(n_slots=2, prompt_buckets=(8, 32), speculative_window=4), True),
    # the other tick kinds, against the port's single-device batcher
    "turbo": ("gpt2", 10, {}, [5, 17, 9, 26], 10, [9] * 4,
              dict(n_slots=2, prompt_buckets=(8, 32), decode_quantum=2, turbo_factor=2), False),
    "dense_chunked": ("llama", 11, {"kv_quant": "int4"}, [7, 21, 12], 12, [6] * 3,
                      dict(n_slots=2, prefill_chunk=8), False),
    "paged_int8": ("llama", 11, {}, [7, 21, 12], 12, [6] * 3,
                   dict(n_slots=2, n_pages=40, paged_kv="int8", **PAGED), False),
    "paged_fp_speculative": ("gpt2", 0, {}, [5, 17, 32, 9], 23, [5, 3, 6, 5],
                             dict(n_slots=2, n_pages=40, paged_kv="fp", speculative_window=3,
                                  **PAGED), False),
    # an expert model on a serving mesh: the MoE block's all_to_all branch
    # (capacity 8: no drops, as the port's MoE parity tests)
    "mixtral": ("llama", 3, {"n_experts": 4, "capacity_factor": 8.0}, [7, 12], 3, [5, 5],
                dict(n_slots=2, prompt_buckets=(16,)), False),
}
JAX_TP = [name for name, sc in SCENARIOS.items() if sc[7]]


def _port_cfg(family, changes):
    base = tgpt2.GPT2Config.tiny() if family == "gpt2" else tllama.LlamaConfig.tiny()
    return dataclasses.replace(base, **changes)


def _port_cls(family):
    return tgpt2.GPT2 if family == "gpt2" else tllama.Llama


def _jax_model(family, changes):
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import Llama, LlamaConfig

    if family == "gpt2":
        return GPT2(dataclasses.replace(GPT2Config.tiny(), **changes))
    return Llama(dataclasses.replace(LlamaConfig.tiny(), **changes))


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int64) for n in lengths]


def _gen_prompt(vocab, shape=(2, 12), seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


def _whole(family, changes, tree):
    model = _port_cls(family)(_port_cfg(family, changes), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _drain(srv, prompts, budgets):
    rids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
    out = srv.run()
    return [list(map(int, out[r])) for r in rids]


def _scenario_run(name, trees, mesh=None):
    family, seed, changes, lengths, pseed, budgets, kw, _ = SCENARIOS[name]
    model = _whole(family, changes, trees[(family, seed, tuple(sorted(changes.items())))])
    srv = ContinuousBatcher(model, mesh=mesh, **kw)
    toks = _drain(srv, _prompts(model.config.vocab_size, lengths, pseed), budgets)
    return toks, srv


def _tree_key(name):
    family, seed, changes = SCENARIOS[name][:3]
    return (family, seed, tuple(sorted(changes.items())))


def _logit_trace(model, prompt, n):
    """Greedy prefill + decode on ``model``: the logits of every step and
    the cache's head count."""
    logits, cache = model.prefill(torch.as_tensor(prompt))
    steps, heads = [logits], cache[0]["k"].shape[1]
    for i in range(n - 1):
        logits, cache = model.decode_step(cache, logits.argmax(-1), prompt.shape[1] + i)
        steps.append(logits)
    return torch.stack(steps), heads


def _gen_side(family, mesh, trees):
    """generate_spmd on this rank's shard: greedy and sampled tokens, the
    logits of every greedy step, the cache's heads and the tp collectives
    of one decode step."""
    cfg = _port_cfg(family, {})
    shard = _port_cls(family)(cfg, device="cpu", tp_group=mesh.group("tp"))
    shard.load_state_dict(params_from_jax(trees[(family, SEED, ())], model=shard))
    prompt = _gen_prompt(cfg.vocab_size)
    logits, heads = _logit_trace(shard, prompt, GEN_NEW)
    _, cache = shard.prefill(torch.as_tensor(prompt))
    ttp.reset_stats()
    shard.decode_step(cache, torch.zeros(2, dtype=torch.long), prompt.shape[1])
    stats = dict(ttp.STATS)
    return {"greedy": shard.generate_spmd(prompt, GEN_NEW, mesh),
            "sampled": shard.generate_spmd(prompt, 8, mesh, temperature=0.8, top_k=20, seed=4),
            "logits": logits, "cache_heads": heads, "decode_stats": stats}


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _tp2_worker(rank, tmp, trees, ckpt_dir):
    torch.set_num_threads(1)
    mesh = build_mesh(MeshSpec(tp=2), rank, 2, os.path.join(tmp, "rendezvous"), "cpu")
    res = {"gen": {fam: _gen_side(fam, mesh, trees) for fam in ("gpt2", "llama")}}
    cfg = _port_cfg("gpt2", {})
    shard = tgpt2.GPT2(cfg, device="cpu", tp_group=mesh.group("tp"))
    shard.load_state_dict(params_from_jax(trees[("gpt2", 9, ())], model=shard))
    res["dp1_sampled"] = shard.generate_spmd(_gen_prompt(cfg.vocab_size, DP_PROMPT, 10), 5, mesh,
                                             temperature=0.8, seed=3, dp_shard=True)
    res["batcher"], res["cache_heads"] = {}, {}
    for name in SCENARIOS:
        toks, srv = _scenario_run(name, trees, mesh)
        store = srv._pool if srv.paged else srv._cache
        res["batcher"][name] = {"tokens": toks, "heads": store[0]["k"].shape[1],
                                "k_dtype": store[0]["k"].dtype,
                                "preemptions": getattr(srv, "n_preemptions", 0),
                                "ticks": (srv.n_plain_ticks, srv.n_turbo_ticks,
                                          srv.n_adaptive_ticks, srv.n_spec_ticks)}
    res["weight_quant"] = _raises(lambda: ContinuousBatcher(
        _whole("gpt2", {}, trees[("gpt2", 10, ())]), mesh=mesh, weight_quant="int8"))
    fd = ContinuousBatcher.for_devices(_whole("gpt2", {}, trees[("gpt2", 10, ())]), ["cpu", "cpu"],
                                       rank=rank, init_file=os.path.join(tmp, "for_devices"),
                                       n_slots=2, prompt_buckets=(8, 32))
    res["for_devices"] = {"tokens": _drain(fd, _prompts(512, [5, 17, 9, 26], 10), [6] * 4),
                          "tp": fd.model.tp, "mesh_tp": fd.mesh.shape["tp"]}
    ck = ContinuousBatcher.from_checkpoint(tgpt2.GPT2(cfg, device="meta"), ckpt_dir, mesh=mesh,
                                           n_slots=2)
    res["from_checkpoint"] = {"tokens": _drain(ck, _prompts(512, [5, 21, 12], 11), [6] * 3),
                              "tp": ck.model.tp}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    fd.mesh.close()
    mesh.close()
    dist.destroy_process_group()


def _tp4_worker(rank, tmp, trees):
    torch.set_num_threads(1)
    mesh = build_mesh(MeshSpec(tp=4), rank, 4, os.path.join(tmp, "rendezvous"), "cpu")
    res = {"gen": {"gpt2": _gen_side("gpt2", mesh, trees)}}
    odd = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), n_head=6, d_model=48),
                     device="cpu")
    res["n_head_raises"] = _raises(lambda: odd.generate_spmd(np.zeros((2, 4), np.int64), 2, mesh))
    res["cache_heads_raise"] = _raises(lambda: ContinuousBatcher(
        _whole("llama", {}, trees[("llama", SEED, ())]), mesh=mesh))
    res["pool_heads_raise"] = _raises(lambda: ContinuousBatcher(
        _whole("llama", {}, trees[("llama", SEED, ())]), mesh=mesh, paged_kv="int4", **PAGED))
    # dp = 2 x tp = 2 in the same processes (a rendezvous directory of its own)
    os.makedirs(os.path.join(tmp, "dp2tp2"), exist_ok=True)
    mesh2 = build_mesh(MeshSpec(dp=2, tp=2), rank, 4, os.path.join(tmp, "dp2tp2", "rendezvous"),
                       "cpu")
    shard = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu", tp_group=mesh2.group("tp"))
    shard.load_state_dict(params_from_jax(trees[("gpt2", 9, ())], model=shard))
    prompt = _gen_prompt(512, DP_PROMPT, 10)
    res["dp2"] = {"greedy": shard.generate_spmd(prompt, 5, mesh2, dp_shard=True),
                  "sampled": shard.generate_spmd(prompt, 5, mesh2, temperature=0.8, seed=3,
                                                 dp_shard=True),
                  "coords": mesh2.coords,
                  "ragged": _raises(lambda: shard.generate_spmd(prompt[:7], 2, mesh2,
                                                                dp_shard=True))}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh2.close()
    mesh.close()
    dist.destroy_process_group()


def _jax_trees():
    """The JAX init of every model the module serves, as numpy trees."""
    import jax

    keys = {("gpt2", SEED, ()), ("llama", SEED, ()), ("gpt2", 9, ())}
    keys |= {_tree_key(name) for name in SCENARIOS}
    return {k: jax.tree.map(np.asarray, _jax_model(k[0], dict(k[2])).init(k[1])) for k in keys}


def _jax_refs(trees, ckpt_dir, devices8):
    """The JAX package's tokens and logits for every held comparison."""
    import jax
    import jax.numpy as jnp

    from dsml_tpu.parallel.hybrid import shard_params
    from dsml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from dsml_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from dsml_tpu.serving import ContinuousBatcher as JaxBatcher

    meshes = {n: jax_build_mesh(JaxMeshSpec(tp=n), devices8[:n]) for n in (2, 4)}
    out = {"gen": {}, "batcher": {}}
    for family in ("gpt2", "llama"):
        model = _jax_model(family, {})
        params = jax.tree.map(jnp.asarray, trees[(family, SEED, ())])
        prompt = jnp.asarray(_gen_prompt(model.config.vocab_size), jnp.int32)
        logits, cache = jax.jit(model.prefill)(params, prompt)
        steps = [np.asarray(logits)]
        step = jax.jit(model.decode_step)
        for i in range(GEN_NEW - 1):
            logits, cache = step(params, cache, jnp.argmax(logits, -1),
                                 jnp.asarray(prompt.shape[1] + i, jnp.int32))
            steps.append(np.asarray(logits))
        out["gen"][family] = {"logits": np.stack(steps), "tp": {}}
        for n in ((2, 4) if family == "gpt2" else (2,)):
            placed = shard_params(params, meshes[n], model.param_specs())
            out["gen"][family]["tp"][n] = np.asarray(
                model.generate_spmd(placed, prompt, max_new_tokens=GEN_NEW, mesh=meshes[n]))
    for name in JAX_TP:
        family, seed, changes, lengths, pseed, budgets, kw, _ = SCENARIOS[name]
        model = _jax_model(family, changes)
        srv = JaxBatcher(model, jax.tree.map(jnp.asarray, trees[_tree_key(name)]),
                         mesh=meshes[2], **kw)
        prompts = [p.astype(np.int32) for p in _prompts(model.config.vocab_size, lengths, pseed)]
        out["batcher"][name] = _drain(srv, prompts, budgets)
    ck = JaxBatcher.from_checkpoint(_jax_model("gpt2", {}), ckpt_dir, n_slots=2)
    out["from_checkpoint"] = _drain(ck, [p.astype(np.int32) for p in _prompts(512, [5, 21, 12], 11)],
                                    [6] * 3)
    return out


def _join(ctx, tmp, n):
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def served(tmp_path_factory, devices8):
    """Both spawns, started first; the JAX references and the JAX-written
    checkpoint in this process meanwhile."""
    import optax

    from dsml_tpu.checkpoint import CheckpointManager as JaxManager

    trees = _jax_trees()
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt") / "ck")
    ck_params = _jax_model("gpt2", {}).init(11)
    with JaxManager(ckpt_dir) as m:
        m.save(10, {"params": ck_params, "opt_state": optax.adam(1e-3).init(ck_params),
                    "meta": {"epoch": 10}})
    tmp2, tmp4 = tmp_path_factory.mktemp("tp2"), tmp_path_factory.mktemp("tp4")
    ctx2 = mp.start_processes(_tp2_worker, args=(str(tmp2), trees, ckpt_dir), nprocs=2,
                              join=False, start_method="spawn")
    ctx4 = mp.start_processes(_tp4_worker, args=(str(tmp4), trees), nprocs=4, join=False,
                              start_method="spawn")
    try:
        jax_out = _jax_refs(trees, ckpt_dir, devices8)
    finally:
        ranks2, ranks4 = _join(ctx2, tmp2, 2), _join(ctx4, tmp4, 4)
    return trees, jax_out, ranks2, ranks4


def _single_generate(family, trees, **kw):
    model = _whole(family, {}, trees[(family, SEED, ())])
    prompt = _gen_prompt(model.config.vocab_size)
    return model.generate(prompt, kw.pop("n", GEN_NEW), **kw)


@pytest.mark.parametrize("family,tp", [("gpt2", 2), ("gpt2", 4), ("llama", 2)])
def test_generate_spmd_greedy_matches_jax_and_single_device(served, family, tp):
    """Greedy tokens equal the JAX ``generate_spmd``'s and the port's
    single-device ``generate``'s; every rank returns them."""
    trees, jax_out, ranks2, ranks4 = served
    ranks = ranks2 if tp == 2 else ranks4
    want = jax_out["gen"][family]["tp"][tp]
    single = _single_generate(family, trees).numpy()
    np.testing.assert_array_equal(single, want)
    for r in ranks:
        np.testing.assert_array_equal(r["gen"][family]["greedy"].numpy(), want)


@pytest.mark.parametrize("family,tp", [("gpt2", 2), ("gpt2", 4), ("llama", 2)])
def test_tp_prefill_and_decode_logits_match_jax_bit_identical_across_ranks(served, family, tp):
    """The full-vocab logits of the prefill and of every decode step are
    allclose to the JAX single-device model's (f32), bit-identical on every
    rank (else greedy ties would split the ranks), and the rank's cache
    holds n_kv_head / tp heads."""
    _, jax_out, ranks2, ranks4 = served
    ranks = ranks2 if tp == 2 else ranks4
    cfg = _port_cfg(family, {})
    want = jax_out["gen"][family]["logits"]
    for r in ranks:
        got = r["gen"][family]["logits"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
        assert torch.equal(got, ranks[0]["gen"][family]["logits"])
        assert r["gen"][family]["cache_heads"] == getattr(cfg, "n_kv_head", cfg.n_head) // tp


@pytest.mark.parametrize("family,tp", [("gpt2", 2), ("gpt2", 4), ("llama", 2)])
def test_tp_decode_step_collectives(served, family, tp):
    """One decode step issues the embedding's all-reduce, two a layer and
    one all-gather of the logits' vocab shards."""
    _, _, ranks2, ranks4 = served
    n_layer = _port_cfg(family, {}).n_layer
    for r in (ranks2 if tp == 2 else ranks4):
        stats = r["gen"][family]["decode_stats"]
        assert stats["all_reduce"] == 1 + 2 * n_layer and stats["all_gather"] == 1


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_generate_spmd_sampled_equals_single_device(served, family):
    """Without dp_shard every rank samples the whole row from the same
    ``torch.Generator`` draws: the sampled tokens equal ``generate``'s."""
    trees, _, ranks2, _ = served
    want = _single_generate(family, trees, n=8, temperature=0.8, top_k=20, seed=4)
    for r in ranks2:
        assert torch.equal(r["gen"][family]["sampled"], want)


def test_generate_spmd_dp_shard(served):
    """dp = 2 × tp = 2 with dp_shard: greedy tokens equal ``generate``'s,
    sampled tokens equal the dp = 1 (tp = 2) dp_shard run's (noise per
    global row), every rank returns all the rows, and a ragged batch
    raises (``tests/test_generate.py::test_generate_spmd_dp_sharded_
    matches_unsharded``)."""
    trees, _, ranks2, ranks4 = served
    model = _whole("gpt2", {}, trees[("gpt2", 9, ())])
    prompt = _gen_prompt(512, DP_PROMPT, 10)
    greedy = model.generate(prompt, 5)
    assert {r["dp2"]["coords"]["dp"] for r in ranks4} == {0, 1}
    for r in ranks4:
        assert torch.equal(r["dp2"]["greedy"], greedy)
        assert torch.equal(r["dp2"]["sampled"], ranks2[0]["dp1_sampled"])
        assert "not divisible by dp" in r["dp2"]["ragged"]
    assert torch.equal(ranks2[1]["dp1_sampled"], ranks2[0]["dp1_sampled"])
    assert not torch.equal(ranks2[0]["dp1_sampled"], greedy)  # it did sample


def test_generate_spmd_and_batcher_head_checks_raise(served):
    """n_head % tp, and the cache's or pool's head count % tp, raise as in
    the JAX package."""
    _, _, _, ranks4 = served
    for r in ranks4:
        assert "n_head=6 not divisible by tp=4" in r["n_head_raises"]
        assert "cache head count 2 not divisible by tp=4" in r["cache_heads_raise"]
        assert "pool head count 2 not divisible by tp=4" in r["pool_heads_raise"]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_batcher_matches_single_device(served, name):
    """Every tick kind on a tp = 2 mesh gives the single-device port
    batcher's tokens on both ranks, from a cache or pool of n_kv_head / 2
    heads in the scenario's codec."""
    trees, _, ranks2, _ = served
    want, single = _scenario_run(name, trees)
    family, _, changes = SCENARIOS[name][:3]
    cfg = _port_cfg(family, changes)
    heads = getattr(cfg, "n_kv_head", cfg.n_head) // 2
    store = single._pool if single.paged else single._cache
    for r in ranks2:
        got = r["batcher"][name]
        assert got["tokens"] == want
        assert got["heads"] == heads and got["k_dtype"] == store[0]["k"].dtype
        assert got["ticks"] == (single.n_plain_ticks, single.n_turbo_ticks,
                                single.n_adaptive_ticks, single.n_spec_ticks)
    if name == "paged_int4_preempt":
        assert ranks2[0]["batcher"][name]["preemptions"] > 0
    if name == "llama_kv_quant":
        assert ranks2[0]["batcher"][name]["k_dtype"] == torch.int8


@pytest.mark.parametrize("name", JAX_TP)
def test_tp_batcher_matches_jax_tp_batcher(served, name):
    """The JAX tp batcher (``mesh=`` on two virtual devices) serves the
    same tokens."""
    _, jax_out, ranks2, _ = served
    for r in ranks2:
        assert r["batcher"][name]["tokens"] == jax_out["batcher"][name]


def test_weight_quant_with_a_mesh_raises(served):
    _, _, ranks2, _ = served
    for r in ranks2:
        assert "single-device replicas" in r["weight_quant"]


def test_for_devices_one_and_two_devices(served):
    """One device is the plain batcher; two are a tp = 2 replica whose
    calling rank holds its shard, with the single-device tokens."""
    trees, _, ranks2, _ = served
    model = _whole("gpt2", {}, trees[("gpt2", 10, ())])
    one = ContinuousBatcher.for_devices(model, ["cpu"], n_slots=2, prompt_buckets=(8, 32))
    assert one.mesh is None and one.model is model
    want = _drain(one, _prompts(512, [5, 17, 9, 26], 10), [6] * 4)
    for r in ranks2:
        assert r["for_devices"] == {"tokens": want, "tp": 2, "mesh_tp": 2}


def test_from_checkpoint_on_a_mesh_serves_the_jax_tokens(served):
    """A checkpoint the JAX package wrote, restored weights-only into each
    rank's shard, serves the JAX batcher's ``from_checkpoint`` tokens."""
    _, jax_out, ranks2, _ = served
    for r in ranks2:
        assert r["from_checkpoint"] == {"tokens": jax_out["from_checkpoint"], "tp": 2}


def test_generate_text_tp2_prints_what_tp1_prints(capfd):
    """``generate_text --tp 2`` spawns two ranks; rank 0 prints the
    continuations ``--tp 1`` prints (sampled: both draw the same noise)."""
    flags = ["--device", "cpu", "--model", "tiny", "--max_new_tokens", "6", "--n_samples", "2"]
    one = generate_text.main(flags)
    first = [line for line in capfd.readouterr().out.splitlines() if " -> " in line]
    two = generate_text.main(flags + ["--tp", "2"])
    second = [line for line in capfd.readouterr().out.splitlines() if " -> " in line]
    assert two == one and second == first and len(first) == 2
