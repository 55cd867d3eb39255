"""The port's GPT-2 (``dsml_tpu_torch.models.gpt2``) against the JAX
package's on the same inputs: the same seed builds the same weights, and
the layers, the forward, prefill and its cache agree at ``GPT2Config.tiny()``
in f32 on the CPU. The JAX flash path runs the Pallas kernel in interpret
mode; the port's runs the kernel's plain version (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu_torch.models import common as tcommon
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import model_by_family
from dsml_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dsml_tpu_torch.utils import platform as tplatform

# f32 on both sides; the matmuls and softmaxes sum in another order
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair():
    cfg_j = jgpt2.GPT2Config.tiny()
    jmodel = jgpt2.GPT2(cfg_j)
    jparams = jmodel.init(7)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(7)
    return jmodel, jparams, tmodel


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_init_builds_the_jax_weights(pair):
    _, jparams, tmodel = pair
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = tmodel.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].shape == t.shape, name
        assert torch.equal(got[name], t), name


def test_params_to_numpy_restores_the_jax_tree(pair):
    _, jparams, tmodel = pair
    back = params_to_numpy(tmodel.state_dict())
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_load_state_dict_from_jax_bf16_tree():
    cfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="bfloat16")
    jparams = jgpt2.GPT2(cfg).init(3)
    tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype="bfloat16"),
                        device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    np.testing.assert_array_equal(
        tmodel.wte.detach().float().numpy(), np.asarray(jparams["wte"], np.float32)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 64), 64, 64))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jgpt2._layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), jnp.asarray(bias, jdt))
    got = tgpt2._layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, scale, bias)))
    assert got.dtype == tdt
    # bf16: the normalised value is rounded to bf16 before scale and bias on
    # both sides, so they agree to one bf16 rounding of the result
    tol = TOL if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6,
    )
    # the exact form would not pass the model-level tolerance
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


def test_mlp_block_matches(pair):
    jmodel, jparams, tmodel = pair
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    want = jmodel._mlp_block(jparams["layers"][0]["mlp"], jnp.asarray(x), None)
    got = tmodel._mlp_block(tmodel.layers[0]["mlp"], torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_apply_logits_match(pair, attn_impl):
    jmodel, jparams, tmodel = pair
    toks = _tokens((2, 96), 512, seed=2)
    want = jmodel.apply_spmd(jparams, jnp.asarray(toks), attn_impl=attn_impl)
    with torch.no_grad():
        got = tmodel.apply(torch.from_numpy(toks).long(), attn_impl=attn_impl)
    assert got.shape == (2, 96, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rejects_unported_attention(pair):
    *_, tmodel = pair
    with pytest.raises(NotImplementedError, match="long-context"):
        tmodel.apply(torch.zeros(1, 4, dtype=torch.long), attn_impl="ring")


def test_prefill_logits_and_cache_match(pair):
    jmodel, jparams, tmodel = pair
    toks = _tokens((2, 17), 512, seed=3)
    want_logits, want_cache = jmodel.prefill(jparams, jnp.asarray(toks))
    got_logits, got_cache = tmodel.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)
    assert len(got_cache) == len(want_cache) == 2
    for g, w in zip(got_cache, want_cache):
        for name in ("k", "v"):
            assert g[name].shape == w[name].shape
            np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]), **TOL)
    # last_index reads an earlier position, as the bucketed prefill does
    want_mid, _ = jmodel.prefill(jparams, jnp.asarray(toks), last_index=9)
    got_mid, _ = tmodel.prefill(torch.from_numpy(toks).long(), last_index=9)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(want_mid), **TOL)


def test_prefill_flash_branch_matches(monkeypatch):
    """The flash prefill (taken on the card for t >= 512) forced on both
    sides at max_seq=512: the JAX kernel under the interpreter, the port's
    plain version on CPU tensors. Tolerance as tests/test_generate.py's."""
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), max_seq=512)
    jmodel = jgpt2.GPT2(jcfg)
    jparams = jmodel.init(11)
    tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), max_seq=512),
                        device="cpu").init(11)
    toks = _tokens((1, 512), jcfg.vocab_size, seed=12)
    assert not tmodel._prefill_use_flash(512)  # CPU weights: the plain path
    monkeypatch.setattr(jgpt2.GPT2, "_prefill_use_flash", lambda self, t: t >= 512)
    monkeypatch.setattr(tgpt2.GPT2, "_prefill_use_flash", lambda self, t: t >= 512)
    calls = []
    real = tgpt2.flash_attention
    monkeypatch.setattr(tgpt2, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    want, want_cache = jmodel.prefill(jparams, jnp.asarray(toks))
    got, got_cache = tmodel.prefill(torch.from_numpy(toks).long())
    assert len(calls) == jcfg.n_layer
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_cache[-1]["v"].numpy(), np.asarray(want_cache[-1]["v"]),
                               rtol=2e-4, atol=2e-4)


def test_config_presets_match_and_unported_options_raise():
    for name in ("tiny", "small", "medium", "large", "xl"):
        j = dataclasses.asdict(jgpt2.GPT2Config.by_name(name))
        t = dataclasses.asdict(tgpt2.GPT2Config.by_name(name))
        assert {k: j[k] for k in t} == t, name
    with pytest.raises(ValueError, match="unknown GPT-2 preset"):
        tgpt2.GPT2Config.by_name("huge")
    with pytest.raises(NotImplementedError, match="paged-KV"):
        tgpt2.GPT2Config(kv_quant="int8")
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt2.GPT2Config.tiny(n_experts=4)


def test_model_by_family():
    model, cfg = model_by_family("gpt2", "tiny", device="cpu", vocab_size=256)
    assert isinstance(model, tgpt2.GPT2) and cfg.vocab_size == 256
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model_by_family("llama", "tiny", device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        model_by_family("bert", "tiny", device="cpu")


def test_qmatmul_plain_layouts_and_quantized_leaf_raises():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    w3 = rng.standard_normal((8, 3, 8)).astype(np.float32)
    w2 = rng.standard_normal((8, 5)).astype(np.float32)
    np.testing.assert_allclose(tcommon.qmatmul(torch.from_numpy(x), torch.from_numpy(w3)).numpy(),
                               np.einsum("bsd,dke->bske", x, w3), **TOL)
    np.testing.assert_allclose(tcommon.qmatmul(torch.from_numpy(x), torch.from_numpy(w2)).numpy(),
                               x @ w2, **TOL)
    with pytest.raises(NotImplementedError, match="weight_quant"):
        tcommon.qmatmul(torch.from_numpy(x), {"qw": w2, "qs": w2})


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    assert tplatform.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tplatform.resolve_device(device)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt2.GPT2(tgpt2.GPT2Config.tiny())
