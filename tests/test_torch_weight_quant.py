"""The port's block-quantized serving weights (``dsml_tpu_torch.ops.quantization``
weight codec, ``models.common`` twins and ``qmatmul``, the batcher's
``weight_quant``) against the JAX package's on the same arrays, on the CPU.

The codes and scales are equal bit for bit (both round half to even and
divide in f32). The port's plain ``_qmm_reference`` is held to the JAX
Pallas kernel (interpret mode) within 1e-5 of the largest output — both sum
in f32, in another order — and exactly on integer weights whose scales are
1. At model level the tiny GPT-2 runs with ``DSML_QBLOCK=32`` so that every
projection has two or more k-blocks and the per-block scale fold is
exercised (at width 64 the default block would give one k-block)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.models import common as jcommon
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.ops import quantization as jq
from dsml_tpu.serving import ContinuousBatcher as JaxBatcher
from dsml_tpu_torch.models import common as tcommon
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dsml_tpu_torch.ops import quantization as tq
from dsml_tpu_torch.serving import ContinuousBatcher

# the JAX suite's tolerance for the fused matmul against its oracle
# (tests/test_quantization.py): relative to the largest |output|
QMM_REL_TOL = 1e-5
# model logits at f32: the two packages sum the projections and softmaxes
# in another order (the unquantized model parity tests' tolerance)
TOL = dict(atol=2e-5, rtol=2e-5)

CODEC_CASES = [((3, 64, 48), 512), ((7, 200, 130), 64), ((16, 512, 256), 128),
               ((5, 64, 3, 32), 64)]  # (m, *weight shape), block; the last is the 3-D wqkv form
CASE_IDS = ["64x48", "200x130", "512x256", "wqkv3d"]


def _case(case, seed=0):
    (m, *shape), block = case
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((m, shape[0])).astype(np.float32)
    return x, w, block


def _both(w, scheme, block):
    return (jq.quantize_weight_blocks(jnp.asarray(w), scheme, block),
            tq.quantize_weight_blocks(torch.from_numpy(w), scheme, block))


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("case", CODEC_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantize_weight_blocks_bitwise_equal_to_jax(scheme, case):
    _, w, block = _case(case)
    jw, tw = _both(w, scheme, block)
    assert tw.qw.dtype == (torch.uint8 if scheme == "int4" else torch.int8)
    np.testing.assert_array_equal(tw.qw.numpy(), np.asarray(jw.qw))
    np.testing.assert_array_equal(_bits(tw.qs.numpy()), _bits(jw.qs))
    assert (tw.scheme, tw.block, tw.shape) == (jw.scheme, jw.block, tuple(jw.shape))
    assert (tw.hbm_bytes, tw.dense_bytes) == (jw.hbm_bytes, jw.dense_bytes)


@pytest.mark.parametrize("case", CODEC_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_dequantize_weight_blocks_equal_to_jax(scheme, case):
    _, w, block = _case(case)
    jw, tw = _both(w, scheme, block)
    got = tq.dequantize_weight_blocks(tw)
    assert got.shape == w.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.dequantize_weight_blocks(jw)))


@pytest.mark.parametrize("case", CODEC_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_qmm_reference_matches_jax_kernel(scheme, case):
    """``quantized_matmul`` on CPU tensors (the plain version) against the
    JAX Pallas kernel in interpret mode, on the same codes."""
    x, w, block = _case(case)
    jw, tw = _both(w, scheme, block)
    before = tq.qmm_launches
    got = tq.quantized_matmul(torch.from_numpy(x), tw)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), jw))
    assert tq.qmm_launches == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-9)
    assert err <= QMM_REL_TOL, err


@pytest.mark.parametrize("scheme,qmax,block", [("int8", 127, 32), ("int4", 7, 32), ("int4", 7, 48)])
def test_qmm_integer_exact(scheme, qmax, block):
    """Integer weights whose (block, column) absmax is qmax have scale 1;
    with small-integer x every partial sum is exact in f32, so the plain
    version, the JAX kernel and the dense product agree exactly (the fold
    after each block's dot loses nothing)."""
    rng = np.random.default_rng(1)
    x = rng.integers(-8, 9, (5, 96)).astype(np.float32)
    w = rng.integers(-qmax, qmax + 1, (96, 160)).astype(np.float32)
    w[0::block] = qmax
    jw, tw = _both(w, scheme, block)
    assert tw.qs.shape[0] == 96 // block and bool((tw.qs == 1).all())
    got = tq.quantized_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_array_equal(got, x @ w)
    np.testing.assert_array_equal(got, np.asarray(jq.quantized_matmul(jnp.asarray(x), jw)))


@pytest.mark.parametrize("scheme,floor", [("int8", 3.9), ("int4", 7.8)])
def test_compression_floors_at_d768(scheme, floor):
    w = np.random.default_rng(2).standard_normal((768, 768)).astype(np.float32)
    tw = tq.quantize_weight_blocks(torch.from_numpy(w), scheme)
    assert tw.block == 384 and tw.dense_bytes / tw.hbm_bytes >= floor
    assert tw.hbm_bytes == jq.quantize_weight_blocks(jnp.asarray(w), scheme).hbm_bytes
    qmax = 127 if scheme == "int8" else 7
    err = (tq.dequantize_weight_blocks(tw) - torch.from_numpy(w)).abs().max().item()
    assert err <= float(np.abs(w).max()) / qmax * 0.51  # half a step of the coarsest scale


@pytest.mark.parametrize("raw", [None, "int8", "8", "int4", "4", " INT4 ", "fp8", "", "off"])
def test_weight_quant_mode_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DSML_WEIGHT_QUANT", raising=False)
    else:
        monkeypatch.setenv("DSML_WEIGHT_QUANT", raw)
    assert tq.weight_quant_mode() == jq.weight_quant_mode()


@pytest.mark.parametrize("raw", [None, "32", "0", "-4", "7", "abc", "1024"])
def test_default_qblock_and_get_scheme_match_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DSML_QBLOCK", raising=False)
    else:
        monkeypatch.setenv("DSML_QBLOCK", raw)
    assert tq.default_qblock() == jq.default_qblock()
    for name in ("int8", "int4"):
        t, j = tq.get_scheme(name), jq.get_scheme(name)
        assert (t.name, t.bits, t.qmax, t.block) == (j.name, j.bits, j.qmax, j.block)
    for bad in (("fp8", None), ("int8", 7), ("int4", 0)):
        with pytest.raises(ValueError) as jerr:
            jq.get_scheme(*bad)
        with pytest.raises(ValueError) as terr:
            tq.get_scheme(*bad)
        assert str(terr.value) == str(jerr.value)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers take the plain version only for CPU tensors."""
    tw = tq.quantize_weight_blocks(torch.ones(16, 8), "int8", 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        tq.quantized_matmul(torch.ones(2, 16, device="meta"), tw)
    with pytest.raises(ValueError, match="x must be"):
        tq.quantized_matmul(torch.ones(2, 15), tw)


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic (csrc/qmm.cu), emulated on the CPU
# ---------------------------------------------------------------------------


def _bf16_halves(words: np.ndarray) -> torch.Tensor:
    """uint32 words → their two bf16 halves [..., 2] (low half first)."""
    halves = np.stack([words & 0xFFFF, words >> 16], axis=-1).astype(np.uint16)
    return torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_kernel_code_to_bf16_matches_block_codes(scheme):
    """The kernel's code → bf16 conversions, emulated on bit patterns, give
    ``_block_codes`` for every byte value. int4: a prmt puts byte e of the
    lower row's word in byte 0 and of the upper row's in byte 2; a mask and
    an or make bf16(128 + v) of the high (``t >> 4``) and the low nibbles;
    one bf16 subtract of 136 gives v − 8. int8: ``c + 128`` in the mantissa
    of 2^23 minus 2^23 + 128, in f32, then to bf16."""
    rng = np.random.default_rng(4)
    vals = np.arange(256, dtype=np.uint32)
    lo, hi = vals.reshape(16, 16), rng.permutation(vals).reshape(16, 16)  # two code rows, every byte
    if scheme == "int4":
        qw = np.concatenate([lo, hi]).astype(np.uint8)  # byte rows 0..15 and 16..31 of one block
        tw = tq.QuantizedWeight(torch.from_numpy(qw), torch.ones(1, 16), "int4", 64, (64, 16), torch.float32)
        garbage = rng.integers(0, 256, lo.shape).astype(np.uint32)
        t = lo | garbage << 8 | hi << 16 | garbage << 24  # __byte_perm(lo, hi, e | (4 + e) << 8)
        off = torch.tensor(136.0, dtype=torch.bfloat16)
        high = _bf16_halves(((t >> 4) & 0x000F000F) | 0x43004300) - off
        low = _bf16_halves((t & 0x000F000F) | 0x43004300) - off
        codes = tq._block_codes(tw, 0)  # rows 0..31 high nibbles, 32..63 low nibbles
        for got, rows in ((high, slice(0, 32)), (low, slice(32, 64))):
            want = codes[rows].reshape(2, 16, 16).permute(1, 2, 0)  # (row r, row 16 + r) pairs
            assert torch.equal(got.float(), want)
    else:
        qw = np.concatenate([lo, hi]).astype(np.uint8).view(np.int8)
        tw = tq.QuantizedWeight(torch.from_numpy(qw), torch.ones(1, 16), "int8", 32, (32, 16), torch.float32)
        bits = (0x4B000000 | (np.concatenate([lo, hi]) ^ 0x80)).astype(np.uint32)
        f = bits.view(np.float32) - np.float32(8388736.0)
        got = torch.from_numpy(f).to(torch.bfloat16).float()
        assert torch.equal(got, tq._block_codes(tw, 0))


H100_SMS = 132  # the H100 SXM's SMs


def _kernel_sum_order(x: np.ndarray, tw) -> np.ndarray:
    """The tensor-core kernel's summation order in f32 numpy: K in units of
    32 k, two mma steps of 16 k (int4: 16 code rows, a high-nibble and a
    low-nibble step, the x runs at b·kb + r0 and b·kb + kb/2 + r0; int8: 32
    code rows, 16 a step), every mma a dot of 16 exact products; each split
    (``_qmm_plan``'s, contiguous units) folds a k-block's scales into its
    accumulator after the block's last unit and at its own end; the
    splits' sums add up in split order."""
    m, d = x.shape
    kb, (nb, n_p) = tw.block, tw.qs.shape
    n = int(np.prod(tw.shape[1:]))
    int4 = tw.scheme == "int4"
    rows_pb, ur = (kb // 2, 16) if int4 else (kb, 32)
    upb = -(-rows_pb // ur)
    units = nb * upb
    _, splits = tq._qmm_plan(m, n, kb, nb, tw.scheme, torch.bfloat16, H100_SMS)
    qw, qs = tw.qw.numpy().astype(np.int32), tw.qs.numpy()
    xp = np.zeros((m, nb * kb + 32), np.float32)
    xp[:, :d] = x
    out = None
    for s in range(splits):
        lo, hi = s * units // splits, (s + 1) * units // splits
        acc = np.zeros((m, n_p), np.float32)
        part = np.zeros((m, n_p), np.float32)
        for u in range(lo, hi):
            b, r0 = u // upb, u % upb * ur
            rows = np.arange(r0, r0 + ur)
            live = rows < rows_pb
            raw = np.zeros((ur, n_p), np.int32)
            raw[live] = qw[b * rows_pb + rows[live]]
            if int4:
                steps = [(b * kb + rows, (raw >> 4) - 8, live), (b * kb + rows_pb + rows, (raw & 0xF) - 8, live)]
            else:
                steps = [(b * kb + rows[h:h + 16], raw[h:h + 16], live[h:h + 16]) for h in (0, 16)]
            for cols, codes, ok in steps:
                xs = np.where(ok, xp[:, cols], np.float32(0))
                part = part + xs @ codes.astype(np.float32)
            if r0 + ur >= rows_pb or u + 1 == hi:
                acc = acc + part * qs[b]
                part[:] = 0
        out = acc if out is None else out + acc
    return out[:, :n]


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("d,n,block", [(768, 768, None), (3072, 768, None), (200, 130, 40)],
                         ids=["d768", "d3072", "kb40"])
def test_kernel_sum_order_matches_jax_kernel(d, n, block, scheme, m):
    """The tensor-core kernel's order of summation (K units, splits, the
    ordered merge), emulated in f32 on bf16-exact x, against the JAX Pallas
    kernel in interpret mode at GPT-2-small's widths and at kb = 40 (kb % 16
    == 8: a unit reads nothing of the next block), within the suite's
    1e-5 of the largest output."""
    rng = np.random.default_rng(d + m)
    w = (rng.standard_normal((d, n)) * 0.02).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    jw, tw = _both(w, scheme, block)
    got = _kernel_sum_order(x, tw)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), jw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert got.shape == want.shape and err <= QMM_REL_TOL, err


GPT2_PROJECTIONS = {"wqkv": (768, 2304), "wo": (768, 768), "w_in": (768, 3072), "w_out": (3072, 768)}


@pytest.mark.parametrize("m", [1, 7, 16, 17, 256, 300])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("proj", sorted(GPT2_PROJECTIONS))
def test_qmm_plan_fits_the_kernel(proj, scheme, m):
    """The launch plan: 16-row tiles (the decode regime) up to 16 rows, 64
    above; 1 to 8 K splits (a portable cluster), each at least 2 units,
    and no more than two blocks per SM of the card (the H100 SXM's 132, and
    a card of 114)."""
    d, n = GPT2_PROJECTIONS[proj]
    tw = tq.quantize_weight_blocks(torch.zeros(d, n), scheme)
    nb = tw.qs.shape[0]
    units = nb * -(-tw.block // 32)  # units of 32 k
    for sms in (H100_SMS, 114):
        rows, splits = tq._qmm_plan(m, n, tw.block, nb, scheme, torch.bfloat16, sms)
        assert rows == (16 if m <= 16 else 64)
        tiles = -(-n // 128) * -(-m // rows)
        assert 1 <= splits <= 8 and units // splits >= 2
        assert tiles * splits <= 2 * sms or splits == 1
        assert tq._qmm_plan(m, n, tw.block, nb, scheme, torch.float32, sms) == (16, 1)


def test_qmm_row_limit_follows_the_tiling():
    """The wrapper's row limit is the grid's 65535 row tiles of the regime's
    rows: 64 for bf16 x (the chunk regime), 16 for f32 x."""
    assert tq._qmm_max_rows(torch.bfloat16) == 65535 * 64
    assert tq._qmm_max_rows(torch.float32) == 65535 * 16


# ---------------------------------------------------------------------------
# twins, qmatmul and the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config.tiny())
    jparams = jmodel.init(11)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def test_qmatmul_routes_every_weight_form():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((64, 3, 32)).astype(np.float32))
    qw3 = tq.quantize_weight_blocks(w3, "int4", 32)
    got = tcommon.qmatmul(x, qw3)
    assert got.shape == (2, 3, 3, 32) and got.dtype == torch.float32
    want = torch.einsum("bsd,dke->bske", x, tq.dequantize_weight_blocks(qw3))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    got_bf16 = tcommon.qmatmul(x.bfloat16(), qw3)
    assert got_bf16.dtype == torch.bfloat16  # cast back to the activation's type
    ch = tcommon._quant_channels(w3)
    torch.testing.assert_close(tcommon.qmatmul(x, ch),
                               torch.einsum("bsd,dke->bske", x, ch.qw.float() * ch.qs))


def test_twin_shares_everything_but_the_projections(pair):
    _, _, tmodel = pair
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    twin = tcommon.quantize_weights_blocked(tmodel, "int4", 32)
    assert twin.wte is tmodel.wte and twin.layers[0]["ln_1"]["scale"] is tmodel.layers[0]["ln_1"]["scale"]
    assert twin.layers[1]["attn"]["bqkv"] is tmodel.layers[1]["attn"]["bqkv"]
    assert isinstance(twin.layers[0]["attn"]["wqkv"], tq.QuantizedWeight)
    assert isinstance(tmodel.layers[0]["attn"]["wqkv"], torch.nn.Parameter)  # the caller's model untouched
    for key in ("layers.0.attn.wqkv.qw", "layers.0.attn.wqkv.qs", "layers.1.mlp.w_out.qs"):
        assert key in twin.state_dict()
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    assert twin.device == tmodel.device and twin.n_params() < tmodel.n_params()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_twin_logits_match_jax_on_the_same_codes(pair, monkeypatch, scheme):
    """The JAX ``quantize_weights_blocked(params)`` codes carried across by
    ``convert.params_from_jax`` into the port's twin: prefill logits and the
    whole-sequence forward equal JAX's ``apply`` at f32."""
    monkeypatch.setenv("DSML_QBLOCK", "32")
    jmodel, jparams, tmodel = pair
    jq_params = jcommon.quantize_weights_blocked(jparams, scheme)
    twin = tcommon.quantize_weights_blocked(tmodel, scheme)
    assert twin.layers[0]["mlp"]["w_out"].qs.shape[0] == 4  # d_ff 128 in blocks of 32
    twin.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jq_params)))
    tokens = np.random.default_rng(4).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(jmodel.apply(jq_params, jnp.asarray(tokens)))
    got = twin.apply(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    logits, _ = twin.prefill(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.numpy(), want[:, -1], **TOL)


def test_convert_carries_quantized_weights_round_trip(pair, monkeypatch):
    monkeypatch.setenv("DSML_QBLOCK", "32")
    _, jparams, tmodel = pair
    jq_params = jcommon.quantize_weights_blocked(jparams, "int4")
    flat = params_from_jax(jax.tree.map(np.asarray, jq_params))
    jw = jq_params["layers"][1]["attn"]["wqkv"]
    assert flat["layers.1.attn.wqkv.qw"].dtype == torch.uint8
    np.testing.assert_array_equal(flat["layers.1.attn.wqkv.qw"].numpy(), np.asarray(jw.qw))
    twin = tcommon.quantize_weights_blocked(tmodel, "int4")
    twin.load_state_dict(flat)
    back = params_to_numpy(twin.state_dict())
    for i, layer in enumerate(jq_params["layers"]):
        for group in ("attn", "mlp"):
            for key, leaf in layer[group].items():
                got = back["layers"][i][group][key]
                if isinstance(leaf, jq.QuantizedWeight):
                    np.testing.assert_array_equal(got["qw"], np.asarray(leaf.qw))
                    np.testing.assert_array_equal(_bits(got["qs"]), _bits(leaf.qs))
                else:
                    np.testing.assert_array_equal(got, np.asarray(leaf))


def test_per_channel_int8_matches_jax(pair):
    jmodel, jparams, tmodel = pair
    jp = jcommon.quantize_weights_int8(jparams)
    twin = tcommon.quantize_weights_int8(tmodel)
    for key in ("wqkv", "wo"):
        leaf, mod = jp["layers"][0]["attn"][key], twin.layers[0]["attn"][key]
        np.testing.assert_array_equal(mod.qw.numpy(), np.asarray(leaf["qw"]))
        np.testing.assert_array_equal(_bits(mod.qs.numpy()), _bits(leaf["qs"]))
        np.testing.assert_array_equal(tcommon.maybe_dequant(mod).numpy(),
                                      np.asarray(jcommon.maybe_dequant(leaf)))
    plain = tmodel.layers[0]["mlp"]["b_in"]
    assert tcommon.maybe_dequant(plain) is plain
    tokens = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(np.int32)
    want, _ = jmodel.prefill(jp, jnp.asarray(tokens), last_index=11)
    got, _ = twin.prefill(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, (n,)).astype(np.int64) for n in lengths]


@pytest.mark.parametrize("paged_kv", [False, "int4"], ids=["dense", "paged_int4"])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_batcher_weight_quant_tokens_match_generate_and_jax(pair, monkeypatch, scheme, paged_kv):
    """Greedy tokens of ``ContinuousBatcher(weight_quant=scheme)`` equal the
    twin's own ``generate`` and the JAX batcher's from the same weights
    (JAX's fused matmul in interpret mode)."""
    monkeypatch.setenv("DSML_QBLOCK", "32")
    jmodel, jparams, tmodel = pair
    prompts, budgets = _prompts([5, 13, 9], seed=12), [5, 4, 6]
    kw = dict(n_slots=2, weight_quant=scheme)
    if paged_kv:
        kw.update(prefill_chunk=8, paged_kv=paged_kv, page_size=8, n_pages=40)
    else:
        kw.update(prompt_buckets=(16,))
    tsrv, jsrv = ContinuousBatcher(tmodel, **kw), JaxBatcher(jmodel, jparams, **kw)
    assert tsrv.weight_quant == jsrv.weight_quant == scheme
    assert tsrv._wq_bytes == jsrv._wq_bytes
    assert isinstance(tsrv.model.layers[0]["attn"]["wo"], tq.QuantizedWeight)
    results = []
    for srv, cast in ((tsrv, lambda p: p), (jsrv, lambda p: p.astype(np.int32))):
        rids = [srv.submit(cast(p), n) for p, n in zip(prompts, budgets)]
        done = srv.run()
        results.append([list(map(int, done[r])) for r in rids])
    got, want = results
    assert got == want
    if not paged_kv:  # the twin's generate runs the dense cache
        for p, n, toks in zip(prompts, budgets, got):
            assert tsrv.model.generate(torch.from_numpy(p[None]), n)[0].tolist() == toks


def test_batcher_weight_quant_knob(pair, monkeypatch):
    _, _, tmodel = pair
    with pytest.raises(ValueError, match="weight_quant must be"):
        ContinuousBatcher(tmodel, weight_quant="fp8")
    for off in (None, "off", False):
        srv = ContinuousBatcher(tmodel, weight_quant=off)
        assert srv.weight_quant is None and srv.model is tmodel and srv._wq_bytes == {}
    monkeypatch.setenv("DSML_WEIGHT_QUANT", "fp8")  # a malformed knob serves unquantized
    assert ContinuousBatcher(tmodel).model is tmodel
    monkeypatch.setenv("DSML_WEIGHT_QUANT", "4")
    srv = ContinuousBatcher(tmodel)
    assert srv.weight_quant == "int4" and srv.model is not tmodel
    packed = sum(m.qw.nbytes for m in srv.model.modules() if isinstance(m, tq.QuantizedWeight))
    assert srv._wq_bytes["packed"] == packed > 0


def test_quantized_twin_runs_every_serving_surface(pair, monkeypatch):
    """The per-slot surfaces on the twin equal the dense model's surfaces
    on the dequantized weights (the same function, the fold order aside)."""
    monkeypatch.setenv("DSML_QBLOCK", "32")
    _, _, tmodel = pair
    twin = tcommon.quantize_weights_blocked(tmodel, "int4")
    dense = tgpt2.GPT2(tmodel.config, device="cpu")
    state = {k: v for k, v in tmodel.state_dict().items()}
    for name, mod in twin.named_modules():
        if isinstance(mod, tq.QuantizedWeight):
            state[name] = tq.dequantize_weight_blocks(mod)
    dense.load_state_dict(state)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 512, (2, 8)))
    for model in (twin, dense):
        cache = model.init_cache(2)
        model.prefill_chunk(cache, tokens, 0)
        out = model.decode_step_slots(cache, tokens[:, 0], torch.tensor([8, 8]))[0]
        out2 = model.verify_step(cache, tokens[:, :3], torch.tensor([9, 9]))[0]
        pool = model.init_page_pool(9, 16)
        table = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]], dtype=torch.int32)
        out3 = model.prefill_chunk_paged(pool, table, tokens[:1], 0)[0]
        if model is twin:
            got = (out, out2, out3)
    for g, w in zip(got, (out, out2, out3)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)
