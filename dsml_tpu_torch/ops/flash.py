"""Flash attention, forward and backward: the hand-written CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` behind the counterpart of
``dsml_tpu/ops/flash.py``'s ``flash_attention`` / ``flash_attention_lse``
and ``flash_block_grads``.

The kernel never materialises the [seq, seq] score matrix: one thread block
walks the kv tiles of one (batch·head, q tile) with an online softmax and
emits the per-row logsumexp beside the output. Masks compare GLOBAL
positions (``q_start``/``k_start``), so a caller can run any (q block,
kv block) pair, and any length runs without padding.

The backward is the TPU's two kernels: one block per (batch·head, q tile)
accumulates dq over the kv tiles, one per (batch·head, kv tile) accumulates
dk and dv over the q tiles, each recomputing p = exp(s - lse) from the lse
the forward saved. Both ``out`` and ``lse`` of :func:`flash_attention_lse`
are differentiable: the lse cotangent folds into ds.

On CUDA tensors :func:`flash_fwd` and :func:`flash_bwd` launch their kernels
or raise; on CPU tensors they run :func:`_flash_fwd_reference` and
:func:`_flash_bwd_reference`, the plain PyTorch versions of the same
functions, which the tests compare with the JAX kernels and
``chip_smoke.py`` compares with the CUDA kernels. There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.ops.attention import _NEG_INF

__all__ = ["flash_attention", "flash_attention_lse", "flash_block_grads", "flash_bwd", "flash_fwd"]

_MAX_FLOOR = -1e20  # running-max floor: a fully masked row gives exp(-1e30 + 1e20) = 0
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # batch·heads is the kernel's grid y dimension

# Launches of each CUDA kernel, counted where it launches. chip_smoke.py
# zeroes them before driving the main path and reads them after.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    lib.flash_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _causal_mask(s_q, s_kv, q_start, k_start, device):
    """[s_q, s_kv] True where query (global position q_start + i) must not
    see key k_start + j."""
    q_pos = q_start + torch.arange(s_q, device=device)
    k_pos = k_start + torch.arange(s_kv, device=device)
    return q_pos[:, None] < k_pos[None, :]


def _flash_fwd_reference(q, k, v, causal=True, q_start=0, k_start=0):
    """Plain PyTorch version of the kernel: the dense masked softmax in f32
    with the kernel's numeric edges (masked scores -1e30, row max floored
    at -1e20, denominator floored at 1e-30), so it returns the same
    ``(out in q's dtype, lse f32)`` as the online softmax."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q_start, k_start, q.device), _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(_MAX_FLOOR)
    p = torch.exp(s - m)
    l_fin = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (p @ vf) / l_fin
    return out.to(q.dtype), (m + torch.log(l_fin)).squeeze(-1)


def _flash_bwd_reference(q, k, v, out, lse, do, g_lse=None, causal=True, q_start=0, k_start=0):
    """Plain PyTorch version of the backward kernels: the dense recompute
    of p = exp(s - lse) from the saved lse (masked scores -1e30), dp =
    do·vᵀ, ds = p·(dp - delta + g_lse) with delta = rowsum(do·out), then
    dq = scale·ds·k, dk = scale·dsᵀ·q, dv = pᵀ·do, in f32. Returns ``(dq in
    q's dtype, dk and dv in k's dtype)``; ``g_lse=None`` is a zero
    cotangent."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, do))
    scale = q.shape[-1] ** -0.5
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q_start, k_start, q.device), _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(-1, keepdim=True)
    glse = 0.0 if g_lse is None else g_lse.float()[..., None]
    ds = p * (dp - delta + glse)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, name="flash_fwd") -> None:
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"{name} needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"{name} takes float32 or bfloat16 (one type for q, k, v), "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"{name} expects q [bh, s_q, d], k/v [bh, s_kv, d], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim in {_HEAD_DIMS}, got {q.shape[2]}")
    if q.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"{name} supports batch*heads <= {_MAX_GRID_Y}, got {q.shape[0]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")


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


def flash_bwd(q, k, v, out, lse, do, g_lse=None, causal=True, q_start=0, k_start=0):
    """Gradients of one flash call: q/out/do [bh, s_q, d], k/v [bh, s_kv,
    d], lse and ``g_lse`` (the lse cotangent; ``None`` = zero) [bh, s_q] →
    ``(dq, dk, dv)`` in the inputs' types. CUDA tensors launch the dq and
    the dk/dv kernels on the current stream (no synchronisation); CPU
    tensors run the plain version."""
    tensors = (q, k, v, out, lse, do) + (() if g_lse is None else (g_lse,))
    if all(t.device.type == "cpu" for t in tensors):
        return _flash_bwd_reference(q, k, v, out, lse, do, g_lse, causal, q_start, k_start)
    _check_kernel_inputs(q, k, v, "flash_bwd")
    bh, s_q, d = q.shape
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype \
            or do.dtype != q.dtype or any(t.device != q.device for t in tensors):
        raise ValueError(
            f"flash_bwd expects out and do like q {tuple(q.shape)} {q.dtype} on {q.device}, "
            f"got {tuple(out.shape)} {out.dtype}, {tuple(do.shape)} {do.dtype}"
        )
    # delta = rowsum(do·out) stays outside the kernels, as in the JAX package
    delta = (do.float() * out.float()).sum(-1)
    lse = lse.float().contiguous()
    glse = None if g_lse is None else g_lse.float().contiguous()
    if lse.shape != (bh, s_q) or (glse is not None and glse.shape != (bh, s_q)):
        raise ValueError(f"flash_bwd expects lse and g_lse [{bh}, {s_q}], got {tuple(lse.shape)}")
    out, do = out.contiguous(), do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib()
    common = (bh, s_q, k.shape[1], d, int(q_start), int(k_start), int(bool(causal)),
              int(q.dtype == torch.bfloat16), d**-0.5,
              torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if glse is None else glse.data_ptr())
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    err = lib.flash_bwd_dq(*ptrs, dq.data_ptr(), *common)
    if err:
        raise RuntimeError(f"flash_bwd_dq launch failed: {lib.flash_bwd_error_string(err).decode()}")
    flash_bwd_dq_launches += 1
    err = lib.flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *common)
    if err:
        raise RuntimeError(f"flash_bwd_dkv launch failed: {lib.flash_bwd_error_string(err).decode()}")
    flash_bwd_dkv_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_start, k_start):
        out, lse = flash_fwd(q, k, v, causal, q_start, k_start)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_start, k_start)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g_out, g_lse, *ctx.args)
        return dq, dk, dv, None, None, None


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


def flash_block_grads(q, k, v, out, lse, do, g_lse=None, causal: bool = True,
                      q_start: int = 0, k_start: int = 0):
    """Raw flash backward of one (q shard, kv block) pair given MERGED
    statistics: ``out``/``lse`` are the total attention output and
    logsumexp over every kv block, so the recomputed ``p = exp(s - lse)``
    are the global softmax rows and the returned ``(dq, dk, dv)`` are this
    block pair's exact contributions to the full gradients (the primitive
    a ring attention's backward streams KV through). Shapes: q/out/do [b, h,
    s_q, hd], k/v [b, h, s_kv, hd], lse/g_lse [b, h, s_q] (``g_lse=None`` =
    zero). Returns float32 gradients."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]

    def flat(t, s):
        return t.reshape(b * h, s, d).contiguous()

    dq, dk, dv = flash_bwd(
        flat(q, s_q), flat(k, s_kv), flat(v, s_kv), flat(out, s_q),
        lse.reshape(b * h, s_q), flat(do, s_q),
        None if g_lse is None else g_lse.reshape(b * h, s_q), causal, q_start, k_start,
    )
    return (dq.float().view(b, h, s_q, d), dk.float().view(b, h, s_kv, d),
            dv.float().view(b, h, s_kv, d))
