"""The port's Llama (``dsml_tpu_torch.models.llama``) against the JAX
package's on the same inputs, at ``LlamaConfig.tiny()`` (8 query heads over
2 kv heads, head_dim 8) in f32 on the CPU: the same seed builds the same
weights; RoPE and RMSNorm, the logits, the dense and the chunked loss (which
streams the untied ``lm_head``) and the gradients agree; every serving
surface (dense and paged) gives the JAX logits over kv-head caches; greedy
``generate`` gives the JAX tokens with every KV codec; AdamW steps follow
the JAX trajectory; a dp = 2 gloo step equals the single-device step; and
the entry points run with ``--family llama``. The JAX flash path runs the
Pallas kernel in interpret mode; the port's runs the kernel's plain version
(CPU tensors)."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu.models import llama as jllama
from dsml_tpu.utils.schedules import make_schedule as jax_make_schedule
from dsml_tpu_torch.cli import generate_text, train_gpt2
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models import model_by_family
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.parallel.bucketing import tree_order
from dsml_tpu_torch.parallel.dp import make_dp_train_step
from dsml_tpu_torch.parallel.mesh import data_mesh
from dsml_tpu_torch.utils.schedules import make_schedule

# f32 on both sides (tests/test_torch_gpt2.py, tests/test_torch_train.py):
# logits to 2e-5, losses to 1e-5, each gradient to 1e-4 of its largest entry
TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_TOL = 1e-4
# RoPE and RMSNorm alone: one f32 rounding of a sin/cos or rsqrt apart
OP_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def pair():
    jmodel = jllama.Llama(jllama.LlamaConfig.tiny())
    jparams = jmodel.init(7)
    tmodel = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(7)
    return jmodel, jparams, tmodel


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _jax_model(seed, **replace):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **replace)
    jmodel = jllama.Llama(jcfg)
    jparams = jmodel.init(seed)
    tmodel = tllama.Llama(dataclasses.replace(tllama.LlamaConfig.tiny(), **replace), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


# ---- weights and config -------------------------------------------------------


def test_init_builds_the_jax_weights(pair):
    _, jparams, tmodel = pair
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = tmodel.state_dict()
    assert sorted(got) == sorted(want)
    assert {"lm_head", "rms_f.scale", "layers.1.rms_1.scale", "layers.0.attn.wk",
            "layers.0.mlp.w_gate"} <= set(got)
    for name, t in want.items():
        assert got[name].shape == t.shape, name
        assert torch.equal(got[name], t), name


def test_tree_order_is_the_jax_leaf_order(pair):
    """The dp step buckets leaves in the JAX tree's flatten order."""
    _, jparams, tmodel = pair
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert tree_order(name for name, _ in tmodel.named_parameters()) == want


def test_config_presets_match_and_unported_options_raise():
    for name in ("tiny", "tinyllama_1b", "llama2_7b", "llama3_8b"):
        want = dataclasses.asdict(jllama.LlamaConfig.by_name(name))
        assert dataclasses.asdict(tllama.LlamaConfig.by_name(name)) == want, name
    tl = tllama.LlamaConfig.tinyllama_1b()
    assert (tl.n_layer, tl.d_model, tl.n_head, tl.n_kv_head, tl.d_ff, tl.vocab_size) == \
        (22, 2048, 32, 4, 5632, 32000)
    # Mixtral's experts are ported (tests/test_torch_moe.py): the JAX presets' fields
    assert dataclasses.asdict(tllama.LlamaConfig.by_name("mixtral_8x7b")) == \
        dataclasses.asdict(jllama.LlamaConfig.by_name("mixtral_8x7b"))
    assert dataclasses.asdict(tllama.LlamaConfig.tiny(n_experts=4)) == \
        dataclasses.asdict(jllama.LlamaConfig.tiny(n_experts=4))
    with pytest.raises(ValueError, match="unknown Llama preset"):
        tllama.LlamaConfig.by_name("huge")
    with pytest.raises(ValueError, match="unknown kv_quant mode"):
        tllama.Llama(dataclasses.replace(tllama.LlamaConfig.tiny(), kv_quant="int2"), device="cpu")
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(0)

    class OneRank:
        size, rank = 1, 0

    # Llama under a sequence group is ported (it raised before the
    # long-context slice; tests/test_torch_hybrid_sp.py trains it at cp = 2
    # and sp = 2): a group of one is no group, and the rotary tables of a
    # shard at offset 4 are rows 4.. of the whole sequence's (the global
    # positions a rank's shard rotates by)
    x = torch.arange(8, dtype=torch.long)[None] % 512
    with torch.no_grad():
        assert torch.equal(model.loss(x, x, attn_impl="ring2", sp_group=OneRank()),
                           model.loss(x, x, attn_impl="flash"))
    whole, shard = model._rotary(0, 8), model._rotary(4, 4)
    for w, t in zip(whole, shard):
        assert torch.equal(w[..., 4:8, :], t)


def test_model_by_family_builds_llama():
    model, cfg = model_by_family("llama", "tiny", device="cpu", vocab_size=256)
    assert isinstance(model, tllama.Llama) and isinstance(model, tgpt2.GPT2)
    assert cfg.vocab_size == 256 and model.device == torch.device("cpu")
    assert model.lm_head.shape == (256, 64) and model.layers[0]["attn"]["wk"].shape == (64, 16)


# ---- layers -------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 9, 16)).astype(np.float32)
    pos = (rng.integers(0, 2000, (3, 9)) if per_row else np.arange(9) + 1000).astype(np.int32)
    want = jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jllama._rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = tllama._rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---- forward, loss and gradients ------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_apply_logits_match(pair, attn_impl):
    jmodel, jparams, tmodel = pair
    toks = _tokens((2, 96), 512, seed=2)
    want = jmodel.apply_spmd(jparams, jnp.asarray(toks), attn_impl=attn_impl)
    with torch.no_grad():
        got = tmodel.apply(_t(toks), attn_impl=attn_impl)
    assert got.shape == (2, 96, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _grads(model):
    return {name: p.grad.detach().numpy() for name, p in model.named_parameters()}


@pytest.mark.parametrize("xent_chunk", [0, 128], ids=["dense", "chunked"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_grads_match_jax(attn_impl, xent_chunk):
    """``Llama.loss`` and every gradient against ``jax.value_and_grad``: the
    chunked loss (vocab 512 > chunk 128) streams ``lm_head``, not ``wte``
    (``wte``'s gradient then comes from the embedding alone)."""
    jmodel, jparams, tmodel = _jax_model(5, xent_chunk=xent_chunk)
    x, y = _tokens((2, 64), 512, 1), _tokens((2, 64), 512, 2)

    def jloss(p):
        return jmodel.loss_spmd(p, jnp.asarray(x), jnp.asarray(y), attn_impl=attn_impl)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss = tmodel.loss(_t(x), _t(y), attn_impl=attn_impl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, want_grads)).items()}
    got = _grads(tmodel)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_REL_TOL * scale, f"{name}: max abs err {err} vs max |g| {scale}"


@pytest.mark.parametrize("remat", [True, "mlp"])
def test_remat_gives_the_same_grads(remat):
    base = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(3)
    other = tllama.Llama(dataclasses.replace(tllama.LlamaConfig.tiny(), remat=remat), device="cpu")
    other.load_state_dict(base.state_dict())
    x, y = (_t(_tokens((2, 32), 512, s)) for s in (4, 5))
    for model in (base, other):
        model.loss(x, y, attn_impl="flash").backward()
    got, want = _grads(other), _grads(base)
    for name in want:  # recomputation repeats the same CPU arithmetic
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7)


def test_adamw_steps_track_optax():
    """Five steps of the entry point's ``train_step`` (clip by global norm,
    then AdamW at the warmup-cosine lr, the chunked loss through
    ``lm_head``) against ``optax.chain(clip_by_global_norm, adamw)``, as
    tests/test_torch_train.py holds GPT-2: losses to 1e-5, every weight to
    2e-5. Both optimizers take eps = 1e-6: Llama's ``wte`` is untied, so its
    gradient is the embedding's alone, and some of its entries are cancelled
    sums near the default eps (1e-8), where ``g / (|g| + eps)`` would turn
    the f32 summation-order difference of the two packages into a share of
    a step."""
    steps, clip, eps = 5, 0.05, 1e-6
    jmodel, jparams, tmodel = _jax_model(9, xent_chunk=128)
    sched = make_schedule("cosine", 1e-2, steps, 2)
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(jax_make_schedule("cosine", 1e-2, steps, 2), eps=eps))
    state = opt.init(jparams)
    topt = torch.optim.AdamW(tmodel.parameters(), lr=0.0, eps=eps, weight_decay=1e-4)

    @jax.jit
    def jstep(params, state, x, y):
        loss, g = jax.value_and_grad(jmodel.loss)(params, x, y)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss, optax.global_norm(g)

    for i in range(steps):
        x, y = _tokens((4, 32), 512, 10 + i), _tokens((4, 32), 512, 20 + i)
        jparams, state, jl, gnorm = jstep(jparams, state, jnp.asarray(x), jnp.asarray(y))
        assert float(gnorm) > clip
        tl = train_gpt2.train_step(tmodel, topt, sched(i), _t(x), _t(y), grad_accum=2,
                                   clip_norm=clip)
        np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.state_dict().items():
        diff = (p - want[name]).abs()
        assert bool((diff <= 2e-5).all()), (name, float(diff.max()))


def _dp2_worker(rank, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"), "cpu")
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    x, y = (_t(a) for a in _dp_batch())
    step = make_dp_train_step(model, opt, mesh, algorithm="ring", bucket_size_mb=1e-3)
    loss = float(step(x, y))
    torch.save({"loss": loss, "state": model.state_dict()}, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _dp_batch():
    x = _tokens((4, 64), 512, 6)
    return x, np.roll(x, -1, 1)


def test_dp2_step_equals_the_single_device_step(tmp_path):
    """One ``make_dp_train_step`` step over a dp = 2 gloo ring (two rows a
    rank, ring sync in ~1 KiB buckets) against one single-device step on
    the four rows: the same loss and the same weights, identical replicas.
    Tolerances: tests/test_torch_dp.py's ``DP_STEP_RTOL``."""
    mp.spawn(_dp2_worker, args=(str(tmp_path),), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    x, y = (_t(a) for a in _dp_batch())
    loss = train_gpt2.train_step(model, opt, 1e-3, x, y)
    np.testing.assert_allclose(ranks[0]["loss"], loss.item(), rtol=1e-4)
    for name, p in model.state_dict().items():
        assert torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]), name
        np.testing.assert_allclose(ranks[0]["state"][name].numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# ---- serving surfaces -------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, "int8"], ids=["fp", "int8"])
def test_dense_serving_surfaces_match_jax(kv_quant):
    """prefill, prefill_chunk (chained), decode_step_slots (per-slot RoPE
    positions), verify_step (per-slot windows) and decode_step against the
    JAX logits, over a cache of n_kv_head heads."""
    jmodel, jparams, tmodel = _jax_model(8, kv_quant=kv_quant)
    toks = _tokens((2, 16), 512, 3)
    logits = {}
    for side in ("jax", "port"):
        jx = side == "jax"

        def arr(a):
            return jnp.asarray(a, jnp.int32) if jx else _t(a)

        def call(name, *args, **kw):
            return getattr(jmodel, name)(jparams, *args, **kw) if jx \
                else getattr(tmodel, name)(*args, **kw)

        out = {}
        out["prefill"], pcache = call("prefill", arr(toks), last_index=11)
        cache = jmodel.init_cache(2) if jx else tmodel.init_cache(2)
        assert cache[0]["k"].shape[1] == 2  # kv heads only
        assert pcache[0]["v"].shape[1] == 2
        out["chunk0"], cache = call("prefill_chunk", cache, arr(toks[:, :8]), 0)
        out["chunk1"], cache = call("prefill_chunk", cache, arr(toks[:, 8:]), 8, last_index=5)
        out["slots"], cache = call("decode_step_slots", cache, arr([7, 9]), arr([16, 14]))
        out["verify"], cache = call("verify_step", cache, arr([[3, 4, 5], [6, 7, 8]]),
                                    arr([17, 15]))
        out["decode"], cache = call("decode_step", cache, arr([1, 2]), 20)
        logits[side] = {k: np.asarray(v) if jx else v.numpy() for k, v in out.items()}
    for name, want in logits["jax"].items():
        np.testing.assert_allclose(logits["port"][name], want, **TOL, err_msg=name)


@pytest.mark.parametrize("quant", ["fp", "int4"])
def test_paged_serving_surfaces_match_jax(quant):
    """prefill_chunk_paged, decode_step_slots_paged and verify_step_paged
    through shuffled page tables over a pool of n_kv_head heads (the gather
    path, the CPU default) against the JAX logits."""
    jmodel, jparams, tmodel = _jax_model(8)
    q = None if quant == "fp" else quant
    toks = _tokens((2, 16), 512, 4)
    table = np.array([[3, 5, 0, 0, 0, 0, 0, 0], [6, 1, 4, 0, 0, 0, 0, 0]], np.int32)  # page 16
    logits = {}
    for side in ("jax", "port"):
        jx = side == "jax"

        def arr(a):
            return jnp.asarray(a, jnp.int32) if jx else _t(a)

        def call(name, *args, **kw):
            return getattr(jmodel, name)(jparams, *args, quant=q, **kw) if jx \
                else getattr(tmodel, name)(*args, quant=q, **kw)

        pool = (jmodel if jx else tmodel).init_page_pool(8, 16, quant=q)
        assert pool[0]["k"].shape[1] == 2
        out = {}
        for row in range(2):
            out[f"chunk{row}"], pool = call("prefill_chunk_paged", pool, arr(table[row:row + 1]),
                                            arr(toks[row:row + 1]), 0)
        out["slots"], pool = call("decode_step_slots_paged", pool, arr(table), arr([7, 9]),
                                  arr([16, 16]))
        out["verify"], pool = call("verify_step_paged", pool, arr(table), arr([[3, 4], [6, 7]]),
                                   arr([17, 17]))
        logits[side] = {k: np.asarray(v) if jx else v.numpy() for k, v in out.items()}
    for name, want in logits["jax"].items():
        np.testing.assert_allclose(logits["port"][name], want, **TOL, err_msg=name)


def test_prefill_flash_branch_matches(monkeypatch):
    """The flash prefill (taken on the card for t >= 512) forced on both
    sides at max_seq=512, over K/V repeated to the query heads: the JAX
    kernel under the interpreter, the port's plain version on CPU tensors.
    Tolerance as tests/test_torch_gpt2.py's flash prefill."""
    jmodel, jparams, tmodel = _jax_model(11, max_seq=512)
    toks = _tokens((1, 512), 512, seed=12)
    monkeypatch.setattr(jllama.Llama, "_prefill_use_flash", lambda self, t: t >= 512)
    monkeypatch.setattr(tgpt2.GPT2, "_prefill_use_flash", lambda self, t: t >= 512)
    calls = []
    real = tgpt2.flash_attention
    monkeypatch.setattr(tgpt2, "flash_attention",
                        lambda q, k, v, **kw: calls.append(k.shape[1]) or real(q, k, v, **kw))
    want, want_cache = jmodel.prefill(jparams, jnp.asarray(toks))
    got, got_cache = tmodel.prefill(_t(toks))
    assert calls == [8, 8]  # both layers, K/V repeated to the 8 query heads
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert got_cache[-1]["v"].shape[1] == 2
    np.testing.assert_allclose(got_cache[-1]["v"].numpy(), np.asarray(want_cache[-1]["v"]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_generate_greedy_tokens_equal_jax(kv_quant):
    jmodel, jparams, tmodel = _jax_model(13, kv_quant=kv_quant)
    prompt = _tokens((2, 9), 512, 14)
    want = np.asarray(jmodel.generate(jparams, jnp.asarray(prompt), 12))
    got = tmodel.generate(prompt, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_quant_twin_serves_llama():
    """The batcher's serving twin (``quantize_weights_blocked``) keeps the
    Llama class and quantizes its seven projections (the plain qmm on CPU
    tensors); embeddings, lm_head and norms stay shared."""
    from dsml_tpu_torch.models.common import quantize_weights_blocked
    from dsml_tpu_torch.ops.quantization import QuantizedWeight

    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu").init(2)
    twin = quantize_weights_blocked(model, "int8")
    assert isinstance(twin, tllama.Llama) and twin.lm_head is model.lm_head
    assert sum(isinstance(m, QuantizedWeight) for m in twin.modules()) == 7 * 2
    prompt = _tokens((1, 6), 512, 3)
    assert twin.generate(prompt, 4).shape == (1, 4)


# ---- entry points -------------------------------------------------------------------


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_gpt2_cli_runs_llama():
    handler = _Lines()
    logger = logging.getLogger("dsml.gpt2")
    logger.addHandler(handler)
    try:
        out = train_gpt2.main(["--device", "cpu", "--family", "llama", "--model", "tiny",
                               "--steps", "2", "--log_every", "1", "--attn", "flash",
                               "--warmup_steps", "1"])
    finally:
        logger.removeHandler(handler)
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert any(line.startswith("Llama tiny on cpu") for line in handler.lines), handler.lines
    assert sum(line.startswith("step ") for line in handler.lines) == 2


def test_generate_text_cli_runs_llama(capsys):
    texts = generate_text.main(["--device", "cpu", "--family", "llama", "--model", "tiny",
                                "--max_new_tokens", "3", "--n_samples", "2"])
    assert len(texts) == 2 and "->" in capsys.readouterr().out
