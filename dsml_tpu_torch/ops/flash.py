"""Flash attention (forward): the hand-written CUDA kernel
``csrc/flash_fwd.cu`` behind the counterpart of ``dsml_tpu/ops/flash.py``'s
``flash_attention`` / ``flash_attention_lse``.

The kernel never materialises the [seq, seq] score matrix: one thread block
walks the kv tiles of one (batch·head, q tile) with an online softmax and
emits the per-row logsumexp beside the output. Masks compare GLOBAL
positions (``q_start``/``k_start``), so a caller can run any (q block,
kv block) pair, and any length runs without padding.

On a CUDA tensor :func:`flash_fwd` launches the kernel or raises; on a CPU
tensor it runs :func:`_flash_fwd_reference`, the plain PyTorch version of
the same function, which the tests compare with the JAX kernel and
``chip_smoke.py`` compares with the CUDA kernel. There is no fallback from
one to the other. The backward (ports of ``_dq_kernel`` and ``_dkv_kernel``)
comes with the training slice; until then a backward through
:func:`flash_attention_lse` raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.ops.attention import _NEG_INF

__all__ = ["flash_attention", "flash_attention_lse", "flash_fwd"]

_MAX_FLOOR = -1e20  # running-max floor: a fully masked row gives exp(-1e30 + 1e20) = 0
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # batch·heads is the kernel's grid y dimension

# Launches of the CUDA kernel, counted where it launches. chip_smoke.py
# zeroes it before driving the main path and reads it after.
flash_fwd_launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    lib.flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _flash_fwd_reference(q, k, v, causal=True, q_start=0, k_start=0):
    """Plain PyTorch version of the kernel: the dense masked softmax in f32
    with the kernel's numeric edges (masked scores -1e30, row max floored
    at -1e20, denominator floored at 1e-30), so it returns the same
    ``(out in q's dtype, lse f32)`` as the online softmax."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if causal:
        q_pos = q_start + torch.arange(q.shape[1], device=q.device)
        k_pos = k_start + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(_MAX_FLOOR)
    p = torch.exp(s - m)
    l_fin = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (p @ vf) / l_fin
    return out.to(q.dtype), (m + torch.log(l_fin)).squeeze(-1)


def _check_kernel_inputs(q, k, v) -> None:
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"flash_fwd needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_fwd takes float32 or bfloat16 (one type for q, k, v), "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"flash_fwd expects q [bh, s_q, d], k/v [bh, s_kv, d], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd supports head_dim in {_HEAD_DIMS}, got {q.shape[2]}")
    if q.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"flash_fwd supports batch*heads <= {_MAX_GRID_Y}, got {q.shape[0]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k, v")


def flash_fwd(q, k, v, causal=True, q_start=0, k_start=0):
    """q [bh, s_q, d], k/v [bh, s_kv, d] → (out [bh, s_q, d] in q's dtype,
    lse [bh, s_q] f32). ``q_start``/``k_start`` are the global positions of
    the first q/k row. CUDA tensors launch the kernel on the current stream
    (no synchronisation); CPU tensors run the plain version."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, causal, q_start, k_start)
    _check_kernel_inputs(q, k, v)
    bh, s_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bh, s_q, k.shape[1], d, int(q_start), int(k_start), int(bool(causal)),
        int(q.dtype == torch.bfloat16), d**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    global flash_fwd_launches
    flash_fwd_launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_start, k_start):
        return flash_fwd(q, k, v, causal, q_start, k_start)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "the flash-attention backward (ports of dsml_tpu/ops/flash.py _dq_kernel "
            "and _dkv_kernel) comes with the single-device training slice"
        )


def flash_attention_lse(q, k, v, causal: bool = True, q_start: int = 0, k_start: int = 0):
    """Flash attention returning ``(out, lse)``. Shapes: q/k/v
    [batch, heads, seq, head_dim] → out same as q, lse [batch, heads, seq_q]
    (f32 logsumexp over the kv positions this call saw). ``q_start``/
    ``k_start`` are the GLOBAL positions of the first q/k row; the causal
    mask compares global positions."""
    b, h, s_q, d = q.shape
    out, lse = _FlashAttention.apply(
        q.reshape(b * h, s_q, d).contiguous(),
        k.reshape(b * h, -1, d).contiguous(),
        v.reshape(b * h, -1, d).contiguous(),
        causal, int(q_start), int(k_start),
    )
    return out.view(b, h, s_q, d), lse.view(b, h, s_q)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention. Shapes: [batch, heads, seq, head_dim]. Agrees with
    ``ops.attention.attention`` but never materialises the [seq, seq]
    scores."""
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    out, _ = flash_attention_lse(q, k, v, causal)
    return out
