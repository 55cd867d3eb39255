"""The port's stochastic int8 activation codec and compressed
rematerialisation (``dsml_tpu_torch.ops.quantization``: ``quantize_int8``,
``compressed_checkpoint``; ``GPT2Config(remat="int8")``) against the JAX
package's, on the CPU.

The rounding noise cannot match bit for bit: JAX draws it from
``jax.random`` (or the TPU's on-core generator), the port from a counter
hash of (seed, element index). So the scales, which are deterministic, are
held bit for bit, and the rounding to its statistics: every code is
``floor(y)`` or ``floor(y) + 1``, the round trip is within one scale, and
200 seeds average to the input (unbiased). The compressed checkpoint's
forward is exact; its gradients are held to the JAX suite's bounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.ops import quantization as jq
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.ops import quantization as tq
from dsml_tpu_torch.utils.hash32 import mix32


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"), ((4, 512), "float32"),
                                         ((777,), "float32"), ((3, 7, 64), "bfloat16")],
                         ids=["1000", "4x512", "777_padded", "bf16"])
def test_quantize_int8_scales_bitwise_and_codes_round_y(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    x = xt.float().numpy()  # the values as quantized (bf16 holds them exactly in f32)
    qt = tq.quantize_int8(xt, seed=5)
    jt = jq.quantize_int8(jnp.asarray(x), seed=5)
    assert qt.values.dtype == torch.int8 and qt.values.shape == jt.values.shape
    assert qt.scales.shape == jt.scales.shape and qt.size == x.size
    np.testing.assert_array_equal(_bits(qt.scales.numpy()), _bits(jt.scales))
    blocks, _ = tq._blocked(torch.from_numpy(x))
    y = (blocks / qt.scales).numpy()
    v = qt.values.numpy().astype(np.float64)
    assert ((v == np.floor(y)) | (v == np.floor(y) + 1)).all()
    assert v.min() >= -127 and v.max() <= 127
    back = tq.dequantize_int8(qt)
    assert back.shape == xt.shape and back.dtype == xt.dtype
    scale = np.repeat(qt.scales.numpy()[:, 0], 512)[:x.size].reshape(x.shape)
    # within one scale, plus half a bf16 ulp where the result is rounded to bf16
    ulp = np.abs(x) * 2.0 ** -8 if dtype == "bfloat16" else 0.0
    assert (np.abs(back.float().numpy() - x) <= scale + ulp + 1e-6).all()
    if x.size % 512:  # the padding path: pad elements quantize to 0
        assert (qt.values.reshape(-1)[x.size:] == 0).all()


def test_quantize_int8_values_in_range_on_large_inputs():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(2048).astype(np.float32) * 100)
    v = tq.quantize_int8(x, seed=2).values
    assert v.dtype == torch.int8 and int(v.min()) >= -127 and int(v.max()) <= 127
    assert int(v.abs().max()) == 127  # the absmax element of a block lands on the end of the range


@pytest.mark.parametrize("row", ["constant", "between_quanta"])
def test_quantize_int8_stochastic_rounding_unbiased(row):
    """Averaged over 200 seeds the round trip converges to x (the JAX
    suite's bound: deterministic rounding would sit up to 0.5 of a scale
    off). The suite's constant 0.303 row has absmax 0.303, so every y is
    exactly 127; one entry of 1.0 puts the 0.303 entries between quanta
    (y = 38.48), where the rounding is random."""
    x = torch.full((512,), 0.303)
    if row == "between_quanta":
        x[0] = 1.0
    acc = torch.zeros(512, dtype=torch.float64)
    for s in range(200):
        acc += tq.dequantize_int8(tq.quantize_int8(x, seed=s)).double()
    scale = float(tq.quantize_int8(x, seed=0).scales.max())
    assert (acc / 200 - x.double()).abs().max().item() < 0.2 * scale


def test_quantize_int8_noise_is_a_counter_hash():
    """u = (bits >> 8)·2^-24 with bits a hash of (seed, global index):
    the same seed gives the same codes, another seed other ones, and a
    tensor seed equals the int seed."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(1500).astype(np.float32))
    a, b = tq.quantize_int8(x, 7), tq.quantize_int8(x, torch.tensor(7, dtype=torch.int32))
    assert torch.equal(a.values, b.values) and torch.equal(a.scales, b.scales)
    assert not torch.equal(a.values, tq.quantize_int8(x, 8).values)
    idx = torch.tensor([0, 1, 511, 512, 2 ** 32 - 1, 2 ** 32 + 5])
    got = tq._noise_bits(torch.tensor([-3], dtype=torch.int32), idx).tolist()
    key = mix32((-3) & 0xFFFFFFFF)
    want = [mix32(mix32(key ^ (((i & 0xFFFFFFFF) + 1) * 0x9E3779B9 & 0xFFFFFFFF)) ^ (i >> 32))
            for i in idx.tolist()]
    assert got == want


def test_quantize_int8_refuses_devices_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantize_int8(torch.ones(8, device="meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_seed_is_jax_int32_sum_of_bitcasts(dtype):
    """Large values make the int32 sum wrap: the port's explicit wrap of
    torch's int64 sum gives JAX's int32 sum."""
    x = (np.random.default_rng(3).standard_normal((4, 300)) * 1e6).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jnp.sum(lax.bitcast_convert_type(jnp.asarray(xt.float().numpy()), jnp.int32))
    got = tq._leaf_seed(xt)
    assert got.dtype == torch.int32 and int(got) == int(want)
    assert abs(int(xt.float().view(torch.int32).sum())) >= 2 ** 31  # the wrap was exercised


# ---------------------------------------------------------------------------
# compressed_checkpoint on the JAX suite's two-layer function
# ---------------------------------------------------------------------------


def _two_layer(params, x):
    return torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def _tiny_params(rng):
    return {"w1": (rng.standard_normal((32, 64)) * 0.1).astype(np.float32),
            "b1": np.zeros(64, np.float32),
            "w2": (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)}


def _torch_params(p):
    return {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}


def test_compressed_checkpoint_forward_exact():
    rng = np.random.default_rng(5)
    params = _torch_params(_tiny_params(rng))
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    got = tq.compressed_checkpoint(_two_layer)(params, x)
    assert torch.equal(got, _two_layer(params, x))


def test_compressed_checkpoint_grads_close_and_int8_stash():
    """Gradients with respect to the parameters and the input within 0.05
    of exact (``jax.grad`` of the JAX function), and what the forward
    saves for the backward is the int8 stash, never x itself."""
    rng = np.random.default_rng(6)
    p_np = _tiny_params(rng)
    x_np = rng.standard_normal((8, 32)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum((jnp.tanh(xx @ p["w1"] + p["b1"]) @ p["w2"]) ** 2)

    g_p, g_x = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p_np.items()},
                                               jnp.asarray(x_np))
    params = _torch_params(p_np)
    x = torch.from_numpy(x_np).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = tq.compressed_checkpoint(_two_layer, seed=3)(params, x)
    (out ** 2).sum().backward()
    for got, want in [(params[k].grad, g_p[k]) for k in p_np] + [(x.grad, g_x)]:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-6) < 0.05
    assert any(t.dtype == torch.int8 for t in saved)
    assert not any(t.shape == x.shape and t.is_floating_point() for t in saved)


def test_compressed_checkpoint_int_inputs_pass_through():
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal((16, 8)).astype(np.float32))
    emb.requires_grad_()

    def fn(params, ids, scale):
        return params[0][ids] * scale

    ids = torch.arange(4)
    scale = torch.ones(4, 1)
    tq.compressed_checkpoint(fn)([emb], ids, scale).sum().backward()
    g = emb.grad.clone()
    emb.grad = None
    fn([emb], ids, scale).sum().backward()
    torch.testing.assert_close(g, emb.grad, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# GPT-2 with remat="int8"
# ---------------------------------------------------------------------------


def test_gpt2_remat_int8_loss_exact_and_grads_near_jax():
    """``remat="int8"``: the loss equals ``remat=False``'s (rtol 1e-6, the
    forward is untouched) and every gradient tensor lies within 0.1 of the
    largest |g| of JAX's ``remat=False`` gradients from the same seed
    weights and batch (the JAX suite's bound for its own int8 remat)."""
    jcfg = jgpt2.GPT2Config.tiny()
    jmodel = jgpt2.GPT2(jcfg)
    jparams = jmodel.init(32)
    rng = np.random.default_rng(33)
    x = rng.integers(0, 512, (2, 32)).astype(np.int32)
    y = rng.integers(0, 512, (2, 32)).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jnp.asarray(x),
                                                                    jnp.asarray(y))
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    base = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    q8 = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), remat="int8"), device="cpu")
    base.load_state_dict(state)
    q8.load_state_dict(state)
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    before = tq.quantize_int8_launches
    loss = q8.loss(xt, yt)
    assert tq.quantize_int8_launches == before  # CPU tensors take the plain version
    assert loss.item() == pytest.approx(base.loss(xt, yt).item(), rel=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in q8.named_parameters():
        w = want[name].numpy()
        assert np.abs(p.grad.numpy() - w).max() / (np.abs(w).max() + 1e-6) < 0.1, name


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_gpt2_remat_int8_stashes_int8_block_inputs(attn_impl):
    """What the int8-remat forward saves: an int8 stash per block, and no
    float tensor of a block input's shape other than the final norm's."""
    cfg = dataclasses.replace(tgpt2.GPT2Config.tiny(), remat="int8")
    model = tgpt2.GPT2(cfg, device="cpu").init(0)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (2, 32)))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        loss = model.loss(tokens, tokens, attn_impl=attn_impl)
    stash = [t for t in saved if t.dtype == torch.int8]
    assert len(stash) == cfg.n_layer and all(t.shape == (8, 512) for t in stash)  # 2·32·64 / 512
    assert sum(t.shape == (2, 32, 64) for t in saved) <= 3  # the final norm's input and stats
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())


def test_gpt2_remat_int8_off_under_no_grad():
    """Without grad (serving, evaluation) the blocks run plainly: no stash,
    the same logits."""
    cfg = dataclasses.replace(tgpt2.GPT2Config.tiny(), remat="int8")
    model = tgpt2.GPT2(cfg, device="cpu").init(0)
    plain = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(0)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (1, 16)))
    with torch.no_grad():
        assert torch.equal(model.apply(tokens), plain.apply(tokens))
