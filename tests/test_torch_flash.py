"""The port's flash attention (``dsml_tpu_torch.ops.flash``) against the JAX
package's Pallas kernel, run as the JAX suite runs it on the CPU (interpret
mode). On CPU tensors the port's wrapper runs the kernel's plain version, so
this pins the arithmetic the CUDA kernel is held to on the card
(``chip_smoke.py``); the wrapper's routing and the package's import rules
are pinned here too."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.ops.flash import flash_attention_lse as jax_flash_attention_lse
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
    before = tflash.flash_fwd_launches
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(64, 64, seed=6))
    out, _ = tflash.flash_attention_lse(q, k, v)
    assert tflash.flash_fwd_launches == before
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    q = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_fwd(q, q, q)


def test_build_is_lazy_and_a_failed_build_raises(monkeypatch, tmp_path):
    assert "flash_fwd" in _build.sources()
    assert tflash._lib.cache_info().currsize == 0  # importing the ops built nothing
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
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "dsml_tpu"):  # exact: dsml_tpu_torch is fine
                bad.append(f"{path.relative_to(PKG.parent)}: {mod}")
    assert not bad, bad
