"""The port's flash attention (``dsml_tpu_torch.ops.flash``), forward and
backward, against the JAX package's Pallas kernels, run as the JAX suite
runs them on the CPU (interpret mode). On CPU tensors the port's wrappers
run the kernels' plain versions, so this pins the arithmetic the CUDA
kernels are held to on the card (``chip_smoke.py``); the wrappers' routing
and the package's import rules are pinned here too."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.ops.flash import flash_attention_lse as jax_flash_attention_lse
from dsml_tpu.ops.flash import flash_block_grads as jax_flash_block_grads
from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.ops import flash as tflash
from dsml_tpu_torch.ops.attention import attention as torch_attention

PKG = pathlib.Path(__file__).resolve().parents[1] / "dsml_tpu_torch"

# both sides accumulate in f32 but in another order (online softmax over
# 64-wide tiles against the dense masked softmax)
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(s_q, s_kv, b=1, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, s_kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "s_q,s_kv,q_start",
    [(128, 128, 0), (200, 200, 0), (64, 192, 128)],
    ids=["s128", "ragged200", "offset"],
)
def test_flash_lse_matches_jax_kernel(causal, s_q, s_kv, q_start):
    q, k, v = _qkv(s_q, s_kv, seed=s_q + q_start)
    out_j, lse_j = jax_flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, q_start, 0,
        block_q=64, block_k=64, interpret=True,
    )
    out_t, lse_t = tflash.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal, q_start, 0
    )
    assert out_t.shape == (1, 2, s_q, 64) and lse_t.shape == (1, 2, s_q)
    assert lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_fully_masked_rows_are_zero_not_nan():
    """k_start past every query position: each row is masked out; the
    -1e20 max floor and the 1e-30 denominator floor make it (0, -1e20 + log
    1e-30), as in the TPU kernel."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 16, seed=3))
    out, lse = tflash.flash_attention_lse(q, k, v, True, 0, 100)
    assert torch.all(out == 0)
    np.testing.assert_allclose(lse.numpy(), -1e20 + np.log(1e-30), rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_plain_attention(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(96, 96, seed=4))
    np.testing.assert_allclose(
        tflash.flash_attention(q, k, v, causal).numpy(),
        torch_attention(q, k, v, causal).numpy(), **TOL,
    )


def test_reference_keeps_bf16_and_f32_lse():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(64, 64, seed=5))
    out, lse = tflash.flash_attention_lse(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32


def _launch_counts():
    return tuple(getattr(tflash, f"flash_{name}_launches")
                 for name in ("fwd", "bwd_dq", "bwd_dkv", "bwd_dq_tc", "bwd_dkv_tc"))


def test_cpu_tensors_never_launch_and_backward_raises():
    """CPU tensors take the plain versions, forward and backward: no kernel
    launches. (Before the training slice the backward raised; it now runs
    and gives gradients of the inputs' shapes.)"""
    before = _launch_counts()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(64, 64, seed=6))
    out, lse = tflash.flash_attention_lse(q, k, v)
    (out.sum() + lse.sum()).backward()
    assert _launch_counts() == before
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (q, k, v))
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    q = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_fwd(q, q, q)


def test_flash_bwd_on_meta_tensors_raises():
    q = torch.empty(2, 64, 64, device="meta")
    lse = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="flash_bwd needs q, k, v on one CUDA device"):
        tflash.flash_bwd(q, q, q, q, lse, q)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "flash_bwd_tc"), (torch.bfloat16, 128, "flash_bwd_tc"),
    (torch.float32, 64, "flash_bwd"), (torch.float32, 128, "flash_bwd"),
])
def test_backward_route_by_dtype(dtype, d, route):
    """bf16 takes the tensor-core kernels, f32 the FMA kernels (a
    tensor-core product would round f32 to TF32)."""
    assert tflash._bwd_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d", [
    (torch.float16, 64), (torch.float64, 64), (torch.int32, 64), (torch.bfloat16, 96),
    (torch.float32, 32),
])
def test_backward_route_raises_on_other_types_and_widths(dtype, d):
    with pytest.raises(ValueError, match="flash_bwd"):
        tflash._bwd_route(dtype, d)


def test_flash_bwd_bf16_meta_tensors_raise_without_a_kernel():
    before = _launch_counts()
    q = torch.empty(2, 64, 64, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="flash_bwd needs q, k, v on one CUDA device"):
        tflash.flash_bwd(q, q, q, q, lse, q)
    assert _launch_counts() == before
    assert tflash._bwd_lib.cache_info().currsize == 0


def test_misaligned_view_raises_without_a_kernel():
    """cp.async copies 16-byte rows: a view one bf16 element into its
    storage is refused by the wrapper's check, before any launch."""
    base = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0  # PyTorch's CPU allocations are 64-byte aligned
    misaligned = base[1:2 * 64 * 64 + 1].view(2, 64, 64)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="flash_bwd needs do 16-byte aligned"):
        tflash._check_aligned("flash_bwd", q=base[:2 * 64 * 64].view(2, 64, 64), do=misaligned)
    tflash._check_aligned("flash_bwd", do=base[8:].view(2, 64, 64))  # 16 bytes in: aligned
    assert tflash._bwd_lib.cache_info().currsize == 0


def _tc_rounding_emulation(q, k, v, out, lse, do, g_lse, causal):
    """The tensor-core kernels' rounding points in plain f32 torch: bf16
    q, k, v and do; products summed in f32; p = exp2(s·d^-½·log2 e -
    lse·log2 e) with masked scores at -1e30; p and ds rounded to bf16
    before the second products (dv = pᵀ do, dq = ds k, dk = dsᵀ q); the
    gradients rounded to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    log2e = 1.4426950408889634
    x = (qf @ kf.transpose(-1, -2)) * (scale * log2e) - lse[..., None] * log2e
    if causal:
        x = x.masked_fill(tflash._causal_mask(q.shape[1], k.shape[1], 0, 0, q.device), -1e30)
    p = torch.exp2(x)
    delta = (dof * out.float()).sum(-1) - (0.0 if g_lse is None else g_lse)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = (ds16 @ kf) * scale
    dk = (ds16.transpose(-1, -2) @ qf) * scale
    dv = p16.transpose(-1, -2) @ dof
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


# chip_smoke.py's bf16 tolerance for the backward kernels against
# _flash_bwd_reference, as a share of each tensor's largest |gradient|
TOL_BWD_BF16 = 1e-2


@pytest.mark.parametrize("s,causal,with_glse", [(1024, True, True), (700, True, True),
                                                 (700, False, False)],
                         ids=["s1024-causal-glse", "ragged700-causal-glse", "ragged700"])
def test_tensor_core_rounding_fits_the_bf16_tolerance(s, causal, with_glse):
    """The design's rounding (bf16 p and ds between the two products of
    each gradient) stays within the chip's bf16 tolerance of the f32 plain
    version, at [4, s, 64] from numpy-seeded bf16 inputs."""
    rng = np.random.default_rng(s + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, s, 64)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal((4, s)).astype(np.float32)) if with_glse else None
    out, lse = tflash._flash_fwd_reference(q, k, v, causal)
    want = tflash._flash_bwd_reference(q, k, v, out, lse, do, g_lse, causal)
    got = _tc_rounding_emulation(q, k, v, out, lse, do, g_lse, causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL_BWD_BF16 * w.float().abs().max().item(), err


def _tc_fwd_rounding_emulation(q, k, v, causal, q_start=0, k_start=0):
    """The tensor-core forward body's rounding points in plain f32 torch:
    bf16 q, k and v; q·kᵀ summed in f32; per 64-key tile, the running max
    m of the scaled scores (masked scores -1e30, m from -1e20), p =
    exp2(s·d^-½·log2 e - m·log2 e), the rescale exp2((m_old - m)·log2 e)
    of l and of the accumulator, p rounded to bf16 before p·v (summed in
    f32); out = acc / max(l, 1e-30) rounded to bf16, lse = m + log(l) in
    natural-log units."""
    f32 = torch.float32
    qf, kf, vf = (t.float() for t in (q, k, v))
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=f32)
    sl2 = scale * log2e
    s = qf @ kf.transpose(-1, -2)
    if causal:
        s = s.masked_fill(tflash._causal_mask(q.shape[1], k.shape[1], q_start, k_start, q.device),
                          -1e30)
    m = torch.full(q.shape[:2], -1e20, dtype=f32)
    l = torch.zeros(q.shape[:2], dtype=f32)
    acc = torch.zeros(qf.shape, dtype=f32)
    for kv0 in range(0, k.shape[1], 64):
        st = s[..., kv0:kv0 + 64]
        m_new = torch.maximum(m, st.amax(-1) * scale)
        corr = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(st * sl2 - (m_new * log2e)[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ vf[:, kv0:kv0 + 64]
        m = m_new
    l_fin = l.clamp_min(1e-30)
    return (acc / l_fin[..., None]).to(torch.bfloat16), m + torch.log(l_fin)


# chip_smoke.py's bf16 tolerance for the forward kernel against
# _flash_fwd_reference: out is bf16 (one ulp at |out| < 4 is <= 1/64), lse f32
TOL_FWD_BF16 = {"out": 2e-2, "lse": 1e-3}


@pytest.mark.parametrize("s,q_start,k_start", [(1024, 0, 0), (700, 0, 0), (700, 300, 0),
                                               (700, 0, 1)],
                         ids=["s1024-causal", "ragged700-causal", "ragged700-offsets",
                              "ragged700-masked-row"])
def test_tensor_core_forward_rounding_fits_the_bf16_tolerance(s, q_start, k_start):
    """The tensor-core forward's rounding (bf16 p between the products, the
    exp2 with the folded scale, the per-tile rescale) stays within the
    chip's bf16 tolerance of the f32 plain version and of the JAX kernel
    (interpret mode), at [4, s, 64] causal from numpy-seeded bf16 inputs.
    With k_start = 1 the first row sees no key: out 0, lse -1e20."""
    rng = np.random.default_rng(s + q_start + k_start)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, s, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got_out, got_lse = _tc_fwd_rounding_emulation(q, k, v, True, q_start, k_start)
    want_out, want_lse = tflash._flash_fwd_reference(q, k, v, True, q_start, k_start)
    out_j, lse_j = jax_flash_attention_lse(
        *(jnp.asarray(t.float().numpy()[None]) for t in (q, k, v)), True, q_start, k_start,
        block_q=128, block_k=128, interpret=True)
    assert got_out.dtype == want_out.dtype == torch.bfloat16 and got_out.shape == q.shape
    for name, got, want in (("out", got_out.float(), want_out.float()), ("lse", got_lse, want_lse),
                            ("out", got_out.float(), torch.from_numpy(np.array(out_j)[0])),
                            ("lse", got_lse, torch.from_numpy(np.array(lse_j)[0]))):
        assert bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= TOL_FWD_BF16[name], (name, err)
    if k_start > q_start:
        assert torch.all(got_out[:, 0] == 0)
        np.testing.assert_allclose(got_lse[:, 0].numpy(), -1e20, rtol=1e-6)


def test_flash_fwd_misaligned_view_raises_without_a_kernel(monkeypatch):
    """cp.async copies 16-byte rows: the forward's operands (kernel 1 and
    kernel 4) refuse a bf16 view one element into its storage, before any
    build or launch; f32 (the FMA body) and padded widths (a fresh copy)
    pass."""
    monkeypatch.setattr(tflash, "_check_kernel_inputs", lambda *args: None)
    before = _launch_counts() + (tflash.flash_stream_launches,)
    base = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:2 * 64 * 64].view(2, 64, 64)
    misaligned = base[1:2 * 64 * 64 + 1].view(2, 64, 64)
    for name in ("flash_fwd", "flash_stream"):
        with pytest.raises(ValueError, match=f"{name} needs k 16-byte aligned"):
            tflash._fwd_operands(aligned, misaligned, aligned, name)
    tflash._fwd_operands(aligned, aligned, aligned, "flash_fwd")
    tflash._fwd_operands(misaligned.float(), aligned.float(), aligned.float(), "flash_fwd")
    narrow = base[1:2 * 64 * 48 + 1].view(2, 64, 48)  # padded to 64: a fresh, aligned copy
    qp, _, _, width = tflash._fwd_operands(narrow, narrow, narrow, "flash_fwd")
    assert width == 64 and qp.data_ptr() % 16 == 0
    assert _launch_counts() + (tflash.flash_stream_launches,) == before
    assert tflash._lib.cache_info().currsize == 0
    assert tflash._stream_lib.cache_info().currsize == 0


def _jax_grads(q, k, v, go, gl, causal, q_start):
    """jax.grad of sum(out·go) + sum(lse·gl) through the Pallas kernels in
    interpret mode (64 × 64 blocks)."""

    def f(q, k, v):
        out, lse = jax_flash_attention_lse(q, k, v, causal, q_start, 0, block_q=64,
                                           block_k=64, interpret=True)
        return jnp.sum(out * go) + jnp.sum(lse * gl)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


# the JAX suite's tolerance for the flash backward against the XLA one
# (tests/test_flash.py): f32 on both sides, sums in another order
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "s_q,s_kv,q_start,with_glse",
    [(128, 128, 0, False), (200, 200, 0, True), (64, 192, 128, True)],
    ids=["s128", "ragged200-glse", "offset-glse"],
)
def test_flash_backward_matches_jax_grad(causal, s_q, s_kv, q_start, with_glse):
    """Autograd through the port's flash_attention_lse (its backward calls
    flash_bwd, the plain version on CPU tensors) and _flash_bwd_reference
    called directly, against jax.grad through the JAX kernels."""
    q, k, v = _qkv(s_q, s_kv, seed=7 + s_q + q_start)
    rng = np.random.default_rng(s_kv)
    go = rng.standard_normal(q.shape).astype(np.float32)
    gl = (rng.standard_normal(q.shape[:3]) if with_glse else np.zeros(q.shape[:3])).astype(np.float32)
    want = _jax_grads(q, k, v, go, gl, causal, q_start)

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tflash.flash_attention_lse(qt, kt, vt, causal, q_start, 0)
    (out * torch.from_numpy(go)).sum().add((lse * torch.from_numpy(gl)).sum()).backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **BWD_TOL)

    flat = [torch.from_numpy(a.reshape(2, -1, 64)) for a in (q, k, v)]
    out_f, lse_f = tflash._flash_fwd_reference(*flat, causal, q_start, 0)
    direct = tflash._flash_bwd_reference(
        *flat, out_f, lse_f, torch.from_numpy(go.reshape(2, -1, 64)),
        torch.from_numpy(gl.reshape(2, -1)) if with_glse else None, causal, q_start, 0)
    for got, w in zip(direct, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w).reshape(got.shape), **BWD_TOL)


def test_flash_block_grads_matches_jax():
    """One (q shard, kv block) pair with merged statistics from a longer
    kv, as ring attention calls it: the offset causal case, non-zero
    g_lse, float32 outputs."""
    q, k, v = _qkv(64, 128, seed=21)
    rng = np.random.default_rng(22)
    out = rng.standard_normal(q.shape).astype(np.float32)
    lse = (rng.standard_normal(q.shape[:3]) + 5.0).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    gl = rng.standard_normal(q.shape[:3]).astype(np.float32)
    want = jax_flash_block_grads(*(jnp.asarray(a) for a in (q, k, v, out, lse, do, gl)),
                                 causal=True, q_start=128, k_start=64, block_q=64,
                                 block_k=64, interpret=True)
    got = tflash.flash_block_grads(*(torch.from_numpy(a) for a in (q, k, v, out, lse, do, gl)),
                                   causal=True, q_start=128, k_start=64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


def test_build_is_lazy_and_a_failed_build_raises(monkeypatch, tmp_path):
    assert {"flash_fwd", "flash_bwd", "flash_stream", "peer_ipc"} <= set(_build.sources())
    # importing the ops built nothing
    assert tflash._lib.cache_info().currsize == tflash._bwd_lib.cache_info().currsize == 0
    assert tflash._stream_lib.cache_info().currsize == 0
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["flash_fwd"])


@pytest.mark.parametrize("d", [8, 32, 96])
def test_head_dim_padding_math(d):
    """What the CUDA wrappers do for a head_dim other than 64 or 128: zero
    columns up to the kernels' width, the true d^-½ as scale, the result
    sliced back. The padded forward and backward equal the unpadded ones,
    and the padded columns come out zero."""
    width = tflash._kernel_head_dim(d, "flash_fwd")
    assert width == (64 if d <= 64 else 128)
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 40, d)).astype(np.float32))
                   for _ in range(4))
    out, lse = tflash._flash_fwd_reference(q, k, v, True, 8, 0)
    qp, kp, vp, dop = (tflash._pad_head_dim(t, width) for t in (q, k, v, do))
    assert qp.shape == (3, 40, width) and qp.is_contiguous()
    out_p, lse_p = tflash._flash_fwd_reference(qp, kp, vp, True, 8, 0, scale=d**-0.5)
    np.testing.assert_allclose(out_p[..., :d].numpy(), out.numpy(), **TOL)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), **TOL)
    assert not out_p[..., d:].any()
    grads = tflash._flash_bwd_reference(q, k, v, out, lse, do, None, True, 8, 0)
    grads_p = tflash._flash_bwd_reference(qp, kp, vp, tflash._pad_head_dim(out, width), lse, dop,
                                          None, True, 8, 0, scale=d**-0.5)
    for g, gp in zip(grads, grads_p):
        np.testing.assert_allclose(gp[..., :d].numpy(), g.numpy(), **TOL)
        assert not gp[..., d:].any()


def test_kernel_head_dim_limits():
    assert [tflash._kernel_head_dim(d, "f") for d in (1, 63, 64, 65, 127, 128)] == \
        [64, 64, 64, 128, 128, 128]
    for d in (0, 129, 256):
        with pytest.raises(ValueError, match="head_dim up to 128"):
            tflash._kernel_head_dim(d, "flash_fwd")
    assert tflash._pad_head_dim(torch.zeros(2, 3, 64), 64).shape == (2, 3, 64)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    names = {str(p.relative_to(PKG)) for p in files if PKG in p.parents}
    # every slice's modules are among those scanned, the observability package's too
    assert {"ops/xent.py", "models/mlp.py", "trainer.py", "cli/train_gpt2.py", "utils/data.py",
            "utils/schedules.py", "utils/metrics.py", "ops/quantization.py",
            "ops/paged_attention.py", "serving/paging.py", "serving/batcher.py",
            "cli/serve_continuous.py", "ops/ring_attention.py", "ops/collectives.py",
            "parallel/mesh.py", "parallel/peer.py", "parallel/hybrid.py",
            "parallel/bucketing.py", "parallel/dp.py", "models/llama.py",
            "models/speculative.py", "cli/decode_speculative.py", "obs/__init__.py",
            "obs/registry.py", "obs/flight_recorder.py", "obs/spans.py", "obs/step_stats.py",
            "obs/export.py", "obs/sentinels.py", "obs/hangwatch.py", "obs/memory.py",
            "checkpoint/__init__.py", "checkpoint/native.py", "checkpoint/async_writer.py",
            "checkpoint/manager.py", "checkpoint/iterator.py", "checkpoint/optim_state.py",
            "utils/checkpoint.py", "parallel/tp.py", "parallel/pp.py",
            "parallel/fsdp.py", "serving/prefill.py", "serving/handoff.py",
            "serving/router.py", "obs/slo.py", "obs/cluster.py", "utils/crc32c.py",
            "runtime/__init__.py", "runtime/native.py", "runtime/chaos.py", "comm/__init__.py",
            "comm/rpc.py", "comm/device_server.py", "comm/coordinator.py", "comm/client.py",
            "comm/migration.py", "comm/proto/__init__.py", "comm/proto/gpu_sim_pb2.py",
            "cli/launch_devices.py", "cli/launch_coordinator.py",
            "cli/train_mnist_wire.py", "models/convert.py", "parallel/elastic.py",
            "parallel/world.py", "runtime/controller.py"} <= names
    bad = []
    for path in files:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            root = mod.split(".")[0]
            # exact: dsml_tpu_torch is fine; ml_dtypes (JAX's bfloat16) is not
            # on the card's machine
            if root in ("jax", "jaxlib", "dsml_tpu", "ml_dtypes"):
                bad.append(f"{path.relative_to(PKG.parent)}: {mod}")
    assert not bad, bad
    # the native runtime's C++ includes only the standard library, and the
    # proto imports no other proto
    cc = (PKG / "runtime" / "native" / "dsml_runtime.cc").read_text()
    assert {ln.split()[1] for ln in cc.splitlines() if ln.startswith("#include")} <= \
        {"<atomic>", "<condition_variable>", "<cstdint>", "<cstring>", "<map>", "<mutex>",
         "<thread>", "<vector>"}
    assert "dsml_tpu/" not in cc.replace("dsml_tpu_torch/", "")
    proto = (PKG / "comm" / "proto" / "gpu_sim.proto").read_text()
    assert not [ln for ln in proto.splitlines() if ln.startswith("import")]
