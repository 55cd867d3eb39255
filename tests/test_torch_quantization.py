"""The port's KV-row codec (``dsml_tpu_torch.ops.quantization``) against the
JAX package's on the same arrays: the bytes and scales are equal bit for
bit (both round half to even), exact .5 ties and zero rows included, and
the errors carry the same messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.ops import quantization as jq
from dsml_tpu_torch.ops import quantization as tq


def _rows(seed, shape=(3, 5, 16)):
    """Random rows with exact ties: row 0 of every block has absmax 7 (int4
    scale 1) and holds halves that round to even; row 1 is all zeros."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    x[..., 0, :] = np.resize(np.array([7.0, 2.5, -3.5, 0.5, -0.5, 1.5, -6.5, 4.5], np.float32),
                             shape[-1])
    x[..., 1, :] = 0.0
    return x


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_kv_rows_bytes_match_jax(mode):
    x = _rows(0)
    if mode == "int8":
        x[..., 0, :] *= 127.0 / 7.0  # absmax 127: scale 1, the same .5 ties
        x[..., 0, 1] = 2.5
    jv, js = jq.quantize_kv_rows(jnp.asarray(x), mode)
    tv, ts = tq.quantize_kv_rows(torch.from_numpy(x), mode)
    assert tv.dtype == (torch.uint8 if mode == "int4" else torch.int8)
    assert ts.dtype == torch.float32 and ts.shape == (3, 5, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert (ts[..., 1, :] == 1.0).all()  # a zero row gets scale 1
    if mode == "int4":
        # ties round half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, -0.5 -> 0
        assert tq.unpack_int4(tv)[0, 0, 1:5].tolist() == [2, -4, 0, 0]


def test_pack_and_unpack_int4_match_jax():
    q = np.random.default_rng(1).integers(-7, 8, (4, 6, 10)).astype(np.int8)
    jp = jq.pack_int4(jnp.asarray(q))
    tp = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), np.asarray(jq.unpack_int4(jp)))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), q)
    # byte j: channel j in the high nibble, channel j + 5 in the low one, +8 each
    assert int(tp[0, 0, 0]) == (int(q[0, 0, 0]) + 8) << 4 | (int(q[0, 0, 5]) + 8)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dequantize_kv_rows_matches_jax(mode):
    x = _rows(2)
    jv, js = jq.quantize_kv_rows(jnp.asarray(x), mode)
    tv, ts = tq.quantize_kv_rows(torch.from_numpy(x), mode)
    got = tq.dequantize_kv_rows(tv, ts, mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.dequantize_kv_rows(jv, js, mode)))
    qmax = 7 if mode == "int4" else 127
    # round trip within half a step of each row's scale
    assert (np.abs(got - x) <= ts.numpy() / 2 + 1e-6).all()
    assert qmax * ts.numpy().max() >= np.abs(x).max() - 1e-5


@pytest.mark.parametrize("head_dim", [8, 64, 128])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_kv_row_bytes_matches_jax(head_dim, mode):
    assert tq.kv_row_bytes(head_dim, mode) == jq.kv_row_bytes(head_dim, mode)


@pytest.mark.parametrize(
    "call",
    [lambda m, x: m.quantize_kv_rows(x(np.zeros((2, 7), np.float32)), "int4"),
     lambda m, x: m.quantize_kv_rows(x(np.zeros((2, 8), np.float32)), "int2"),
     lambda m, x: m.dequantize_kv_rows(x(np.zeros((2, 8), np.int8)), x(np.ones((2, 1), np.float32)),
                                       "fp8"),
     lambda m, x: m.pack_int4(x(np.zeros((2, 3), np.int8))),
     lambda m, x: m.kv_row_bytes(7, "int4"),
     lambda m, x: m.kv_row_bytes(8, "int2")],
    ids=["odd_int4_rows", "unknown_mode", "unknown_dequant_mode", "odd_pack", "odd_row_bytes",
         "unknown_row_bytes"],
)
def test_codec_errors_match_jax(call):
    with pytest.raises(ValueError) as jerr:
        call(jq, jnp.asarray)
    with pytest.raises(ValueError) as terr:
        call(tq, torch.from_numpy)
    assert str(terr.value) == str(jerr.value)
