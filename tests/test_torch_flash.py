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


def test_cpu_tensors_never_launch_and_backward_raises():
    """CPU tensors take the plain versions, forward and backward: no kernel
    launches. (Before the training slice the backward raised; it now runs
    and gives gradients of the inputs' shapes.)"""
    before = (tflash.flash_fwd_launches, tflash.flash_bwd_dq_launches,
              tflash.flash_bwd_dkv_launches)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(64, 64, seed=6))
    out, lse = tflash.flash_attention_lse(q, k, v)
    (out.sum() + lse.sum()).backward()
    assert (tflash.flash_fwd_launches, tflash.flash_bwd_dq_launches,
            tflash.flash_bwd_dkv_launches) == before
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
    assert {"flash_fwd", "flash_bwd"} <= set(_build.sources())
    # importing the ops built nothing
    assert tflash._lib.cache_info().currsize == tflash._bwd_lib.cache_info().currsize == 0
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["flash_fwd"])


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
    # the training slice's modules are among those scanned
    assert {"ops/xent.py", "models/mlp.py", "trainer.py", "cli/train_gpt2.py", "utils/data.py",
            "utils/schedules.py", "utils/metrics.py"} <= names
    bad = []
    for path in files:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "dsml_tpu"):  # exact: dsml_tpu_torch is fine
                bad.append(f"{path.relative_to(PKG.parent)}: {mod}")
    assert not bad, bad
