"""Flash attention, forward and backward: the hand-written CUDA kernels
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_tc.cu`` and ``csrc/flash_bwd.cu``
behind the counterpart of
``dsml_tpu/ops/flash.py``'s ``flash_attention`` / ``flash_attention_lse``
and ``flash_block_grads``, and :func:`ring_flash_attention`, the flash ring of
the JAX package (one kernel-1 call a hop, merged with logsumexp weights).

The kernel never materialises the [seq, seq] score matrix: one thread block
walks the kv tiles of one (batch·head, q tile) with an online softmax and
emits the per-row logsumexp beside the output. Masks compare GLOBAL
positions (``q_start``/``k_start``), so a caller can run any (q block,
kv block) pair, and any length runs without padding. The forward's block
body is routed by dtype inside the kernel: bf16 runs on the tensor cores
(``csrc/flash_fwd_tc.cuh``, whose ``cp.async`` copies need 16-byte aligned
q, k and v), f32 on FMAs (``csrc/flash_fwd_tile.cuh``).

The backward is the TPU's two kernels: one block per (batch·head, q tile)
accumulates dq over the kv tiles, one per (batch·head, kv tile) accumulates
dk and dv over the q tiles, each recomputing p = exp(s - lse) from the lse
the forward saved. Both ``out`` and ``lse`` of :func:`flash_attention_lse`
are differentiable: the lse cotangent folds into ds. The route is chosen by
dtype (:func:`_bwd_route`): bf16 launches the tensor-core kernels of
``flash_bwd_tc.cu``, f32 the FMA kernels of ``flash_bwd.cu`` (a
tensor-core product rounds f32 to TF32), anything else raises.

The kernels are built for head_dim 64 and 128. Other widths up to 128 are
zero-padded up to the next of the two before the launch, with the true
``d ** -0.5`` as the kernels' scale, and the results sliced back: the padded
columns add nothing to q·kᵀ and give zero outputs and zero gradients.

:func:`flash_stream_hop` is one hop of the context-parallel ring under
``DSML_RING_FUSED=dma`` (the counterpart of ``dsml_tpu/ops/flash.py``'s
``flash_stream_hop``): ``csrc/flash_stream.cu`` computes kernel 1's block
and, in the same kernel, copies the resident K/V into the ring neighbour's
receive slot (``parallel/peer.py``).

On CUDA tensors :func:`flash_fwd`, :func:`flash_bwd` and
:func:`flash_stream` launch their kernels or raise; on CPU tensors they run
:func:`_flash_fwd_reference`, :func:`_flash_bwd_reference` and
:func:`_flash_stream_reference`, the plain PyTorch versions of the same
functions, which the tests compare with the JAX kernels and
``chip_smoke.py`` compares with the CUDA kernels. There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.ops.attention import _NEG_INF
from dsml_tpu_torch.ops.collectives import ring_pass

__all__ = ["flash_attention", "flash_attention_lse", "flash_block_grads", "flash_bwd", "flash_fwd",
           "flash_stream", "flash_stream_hop", "ring_flash_attention"]

_MAX_FLOOR = -1e20  # running-max floor: a fully masked row gives exp(-1e30 + 1e20) = 0
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535  # batch·heads is the kernel's grid y dimension

# Launches of each CUDA kernel, counted where it launches. chip_smoke.py
# zeroes them before driving the main path and reads them after.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0  # f32: flash_bwd.cu
flash_bwd_dkv_launches = 0
flash_bwd_dq_tc_launches = 0  # bf16: flash_bwd_tc.cu
flash_bwd_dkv_tc_launches = 0
flash_stream_launches = 0  # kernel 4: flash_stream.cu


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
def _stream_lib() -> ctypes.CDLL:
    lib = _build.load("flash_stream")
    lib.flash_stream_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    lib.flash_stream_fwd.restype = ctypes.c_int
    lib.flash_stream_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_stream_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib(source: str) -> ctypes.CDLL:
    """``csrc/flash_bwd.cu`` (f32) or ``csrc/flash_bwd_tc.cu`` (bf16): one
    C interface, ``<source>_dq``, ``<source>_dkv`` and
    ``<source>_error_string``."""
    lib = _build.load(source)
    dq, dkv = getattr(lib, f"{source}_dq"), getattr(lib, f"{source}_dkv")
    dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    dq.restype = dkv.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _causal_mask(s_q, s_kv, q_start, k_start, device):
    """[s_q, s_kv] True where query (global position q_start + i) must not
    see key k_start + j."""
    q_pos = q_start + torch.arange(s_q, device=device)
    k_pos = k_start + torch.arange(s_kv, device=device)
    return q_pos[:, None] < k_pos[None, :]


def _flash_fwd_reference(q, k, v, causal=True, q_start=0, k_start=0, scale=None):
    """Plain PyTorch version of the kernel: the dense masked softmax in f32
    with the kernel's numeric edges (masked scores -1e30, row max floored
    at -1e20, denominator floored at 1e-30), so it returns the same
    ``(out in q's dtype, lse f32)`` as the online softmax. ``scale``
    defaults to head_dim^-½ (the kernels take it as an argument)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q_start, k_start, q.device), _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(_MAX_FLOOR)
    p = torch.exp(s - m)
    l_fin = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (p @ vf) / l_fin
    return out.to(q.dtype), (m + torch.log(l_fin)).squeeze(-1)


def _flash_bwd_reference(q, k, v, out, lse, do, g_lse=None, causal=True, q_start=0, k_start=0,
                         scale=None):
    """Plain PyTorch version of the backward kernels: the dense recompute
    of p = exp(s - lse) from the saved lse (masked scores -1e30), dp =
    do·vᵀ, ds = p·(dp - delta + g_lse) with delta = rowsum(do·out), then
    dq = scale·ds·k, dk = scale·dsᵀ·q, dv = pᵀ·do, in f32. Returns ``(dq in
    q's dtype, dk and dv in k's dtype)``; ``g_lse=None`` is a zero
    cotangent; ``scale`` defaults to head_dim^-½."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, do))
    scale = q.shape[-1] ** -0.5 if scale is None else scale
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


def _bwd_route(dtype, head_dim: int) -> str:
    """The backward kernels a CUDA call of :func:`flash_bwd` launches:
    ``"flash_bwd_tc"`` (tensor cores) for bf16, ``"flash_bwd"`` (f32 FMAs)
    for f32; any other type or head_dim raises."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash_bwd supports head_dim in {_HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16:
        return "flash_bwd_tc"
    if dtype == torch.float32:
        return "flash_bwd"
    raise ValueError(f"flash_bwd takes float32 or bfloat16, got {dtype}")


def _check_aligned(name, **tensors) -> None:
    """cp.async copies 16-byte rows: each tensor must start 16-byte aligned."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs {key} 16-byte aligned, got data_ptr() % 16 = "
                             f"{t.data_ptr() % 16}")


def _kernel_head_dim(d: int, name: str) -> int:
    """The kernels' width for head_dim ``d``: 64 or 128, the next at or
    above ``d``; above 128 raises."""
    if not 0 < d <= _HEAD_DIMS[-1]:
        raise ValueError(f"{name} supports head_dim up to {_HEAD_DIMS[-1]}, got {d}")
    return next(w for w in _HEAD_DIMS if d <= w)


def _pad_head_dim(t, width: int):
    """``t`` [..., d] zero-padded to [..., width] (``t`` itself when d is
    ``width``)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1])).contiguous()


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
    _kernel_head_dim(q.shape[2], name)
    if q.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"{name} supports batch*heads <= {_MAX_GRID_Y}, got {q.shape[0]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")


def _fwd_operands(q, k, v, name):
    """The forward kernels' operands: q, k and v checked, zero-padded to
    the kernels' head_dim ``width`` and, for the bf16 tensor-core body,
    checked 16-byte aligned. Returns ``(qp, kp, vp, width)``."""
    _check_kernel_inputs(q, k, v, name)
    width = _kernel_head_dim(q.shape[2], name)
    qp, kp, vp = (_pad_head_dim(t, width) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        _check_aligned(name, q=qp, k=kp, v=vp)
    return qp, kp, vp, width


def flash_fwd(q, k, v, causal=True, q_start=0, k_start=0):
    """q [bh, s_q, d], k/v [bh, s_kv, d] → (out [bh, s_q, d] in q's dtype,
    lse [bh, s_q] f32). ``q_start``/``k_start`` are the global positions of
    the first q/k row. CUDA tensors launch the kernel on the current stream
    (no synchronisation), head_dim zero-padded to 64 or 128, or raise; bf16
    tensors must start 16-byte aligned. CPU tensors run the plain version."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, causal, q_start, k_start)
    qp, kp, vp, width = _fwd_operands(q, k, v, "flash_fwd")
    bh, s_q, d = q.shape
    out = torch.empty_like(qp)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bh, s_q, k.shape[1], width, int(q_start), int(k_start), int(bool(causal)),
        int(q.dtype == torch.bfloat16), d**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    global flash_fwd_launches
    flash_fwd_launches += 1
    return (out if width == d else out[..., :d].contiguous()), lse


def flash_bwd(q, k, v, out, lse, do, g_lse=None, causal=True, q_start=0, k_start=0):
    """Gradients of one flash call: q/out/do [bh, s_q, d], k/v [bh, s_kv,
    d], lse and ``g_lse`` (the lse cotangent; ``None`` = zero) [bh, s_q] →
    ``(dq, dk, dv)`` in the inputs' types. CUDA tensors launch the dq and
    the dk/dv kernels of the dtype's route (:func:`_bwd_route`) on the
    current stream (no synchronisation), or raise; bf16 tensors must start
    16-byte aligned. head_dim is zero-padded to 64 or 128 for the kernels
    and the gradients sliced back. CPU tensors run the plain version."""
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
    width = _kernel_head_dim(d, "flash_bwd")
    route = _bwd_route(q.dtype, width)
    # delta = rowsum(do·out) stays outside the kernels, as in the JAX package
    delta = (do.float() * out.float()).sum(-1)
    # zero columns: q·kᵀ, do·vᵀ and delta unchanged, zero gradient columns
    q, k, v, do = (_pad_head_dim(t, width) for t in (q, k, v, do.contiguous()))
    lse = lse.float().contiguous()
    glse = None if g_lse is None else g_lse.float().contiguous()
    if lse.shape != (bh, s_q) or (glse is not None and glse.shape != (bh, s_q)):
        raise ValueError(f"flash_bwd expects lse and g_lse [{bh}, {s_q}], got {tuple(lse.shape)}")
    if route == "flash_bwd_tc":
        _check_aligned("flash_bwd", q=q, k=k, v=v, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_lib(route)
    common = (bh, s_q, k.shape[1], width, int(q_start), int(k_start), int(bool(causal)), d**-0.5,
              torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if glse is None else glse.data_ptr())
    errors = getattr(lib, f"{route}_error_string")
    err = getattr(lib, f"{route}_dq")(*ptrs, dq.data_ptr(), *common)
    if err:
        raise RuntimeError(f"{route}_dq launch failed: {errors(err).decode()}")
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    global flash_bwd_dq_tc_launches, flash_bwd_dkv_tc_launches
    if route == "flash_bwd_tc":
        flash_bwd_dq_tc_launches += 1
    else:
        flash_bwd_dq_launches += 1
    err = getattr(lib, f"{route}_dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *common)
    if err:
        raise RuntimeError(f"{route}_dkv launch failed: {errors(err).decode()}")
    if route == "flash_bwd_tc":
        flash_bwd_dkv_tc_launches += 1
    else:
        flash_bwd_dkv_launches += 1
    if width != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
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


def ring_flash_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """Ring attention with one flash call a hop (the counterpart of the JAX
    ``ring_flash_attention``): each rank holds a sequence shard [batch,
    heads, seq/n, head_dim] of ``group`` (rank r holds block r), K/V rotate
    ``n − 1`` hops through the differentiable ``ops.collectives.ring_pass``,
    and every hop is ONE :func:`flash_attention_lse` call (kernel 1 on CUDA
    tensors) whose global ``q_start = rank·s`` and ``k_start = k_off·s``
    make the causal mask exact for that pair. The hops' (out, lse) merge
    online with logsumexp weights, each hop's out rounded to q's dtype and
    merged in f32, the result cast back to q's dtype, as the JAX code does.
    A causal hop whose keys all lie in the future (rank 0's second hop at
    n = 2) returns lse ≈ −1e20 (the kernel's row-max floor), so its weight
    is exp(−1e20 − lse) = 0, and its backward recomputes p = exp(s − lse) =
    0 on every row: no NaN. Gradients flow through kernels 2 and 3 with the
    lse cotangent. The JAX function falls back to its XLA ring where a
    shard does not tile for Pallas; the CUDA kernels mask ragged tails, so
    every hop here runs kernel 1 on CUDA tensors and there is no fallback.
    A group of one (or ``None``) is :func:`flash_attention`."""
    n = 1 if group is None else group.size
    if n == 1:
        return flash_attention(q, k, v, causal)
    rank = group.rank
    seq_block = q.shape[-2]
    # one running (out, lse) pair alive, as the JAX merge
    run_out = run_lse = None
    kv = (k, v)
    for hop in range(n):
        k_off = (rank - hop) % n  # whose K/V block is resident this hop
        o, lse = flash_attention_lse(q, kv[0], kv[1], causal, q_start=rank * seq_block,
                                     k_start=k_off * seq_block)
        o = o.float()
        if run_out is None:
            run_out, run_lse = o, lse
        else:
            new_lse = torch.logaddexp(run_lse, lse)
            w_prev = torch.exp(run_lse - new_lse)[..., None]
            w_new = torch.exp(lse - new_lse)[..., None]
            run_out = w_prev * run_out + w_new * o
            run_lse = new_lse
        if hop != n - 1:
            kv = ring_pass(kv, group, +1)
    return run_out.to(q.dtype)


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


# ---- kernel 4: the fused ring hop --------------------------------------------


def _flash_stream_reference(q, k, v, k_dst, v_dst, pred=True, causal=True, q_start=0, k_start=0):
    """Plain PyTorch version of kernel 4: :func:`_flash_fwd_reference`, or
    with ``pred`` false the hop-skip identity (out = 0, lse = -1e30), and,
    with every ``pred``, ``k``/``v`` copied into ``k_dst``/``v_dst``.
    Returns ``(out, lse)``."""
    k_dst.copy_(k)
    v_dst.copy_(v)
    if pred:
        return _flash_fwd_reference(q, k, v, causal, q_start, k_start)
    return (torch.zeros_like(q),
            torch.full(q.shape[:2], _NEG_INF, dtype=torch.float32, device=q.device))


def _dst_pointer(dst, like, name: str) -> int:
    """A kernel-4 destination: a tensor shaped like ``like`` on its device,
    or a raw device pointer (the ring's peer-mapped slot)."""
    if isinstance(dst, int):
        ptr = dst
    else:
        if dst.shape != like.shape or dst.dtype != like.dtype or dst.device != like.device \
                or not dst.is_contiguous():
            raise ValueError(f"flash_stream needs {name} contiguous like {tuple(like.shape)} "
                             f"{like.dtype} on {like.device}, got {tuple(dst.shape)} {dst.dtype} "
                             f"on {dst.device}")
        ptr = dst.data_ptr()
    if ptr % 16:
        raise ValueError(f"flash_stream needs {name} 16-byte aligned, got address % 16 = {ptr % 16}")
    return ptr


def flash_stream(q, k, v, k_dst, v_dst, pred=True, causal=True, q_start=0, k_start=0):
    """Kernel 4: q [bh, s_q, d], k/v [bh, s_kv, d] → (out, lse) as
    :func:`flash_fwd` (or the skip identity when ``pred`` is false), while
    the same launch copies ``k``/``v`` into ``k_dst``/``v_dst`` (tensors
    like ``k``, or 16-byte aligned device pointers of ``k.nbytes`` each).
    CUDA tensors launch ``csrc/flash_stream.cu`` on the current stream (no
    synchronisation), head_dim zero-padded to 64 or 128 for the math while
    the UNPADDED k/v are what is copied, or raise; bf16 q, k and v, and in
    either type k, v and the destinations, must start 16-byte aligned. CPU
    tensors run :func:`_flash_stream_reference`."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _flash_stream_reference(q, k, v, k_dst, v_dst, pred, causal, q_start, k_start)
    qp, kp, vp, width = _fwd_operands(q, k, v, "flash_stream")
    _check_aligned("flash_stream", k=k, v=v)
    k_ptr, v_ptr = _dst_pointer(k_dst, k, "k_dst"), _dst_pointer(v_dst, v, "v_dst")
    bh, s_q, d = q.shape
    out = torch.empty_like(qp)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    lib = _stream_lib()
    err = lib.flash_stream_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bh, s_q, k.shape[1], width, int(q_start), int(k_start), int(bool(causal)),
        int(q.dtype == torch.bfloat16), d**-0.5, int(bool(pred)),
        k.data_ptr(), v.data_ptr(), k_ptr, v_ptr, k.numel() * k.element_size(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"flash_stream launch failed: {lib.flash_stream_fwd_error_string(err).decode()}")
    global flash_stream_launches
    flash_stream_launches += 1
    return (out if width == d else out[..., :d].contiguous()), lse


def flash_stream_hop(q, k, v, pred, ring, sign, causal=True, q_start=0, k_start=0):
    """One FUSED ring-attention hop: flash attention of ``q`` [b, h, s_q, d]
    against the resident ``k``/``v`` [b, h, s_kv, d] while that same K/V
    streams to ``ring``'s neighbour in direction ``sign``. Returns ``(out,
    lse, k_next, v_next)``: the attention pair for the merge and the next
    hop's residents, received from the opposite neighbour. ``pred`` (a
    bool: rank and hop are host ints) is the causal hop-skip predicate:
    false gives the (0, -1e30) identity, and the bytes still move.

    CUDA tensors: kernel 4 stores K/V straight into the neighbour's receive
    slot (``ring``'s CUDA IPC transport), then the transport records the
    event the neighbour waits on. CPU tensors: the plain version copies
    into a send buffer that hops over gloo."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    q3 = q.reshape(b * h, s_q, d).contiguous()
    k3 = k.reshape(b * h, s_kv, d).contiguous()
    v3 = v.reshape(b * h, s_kv, d).contiguous()
    if all(t.device.type == "cpu" for t in (q3, k3, v3)):
        k_send, v_send = torch.empty_like(k3), torch.empty_like(v3)
        out, lse = _flash_stream_reference(q3, k3, v3, k_send, v_send, pred, causal, q_start,
                                           k_start)
        k_next, v_next = ring_pass((k_send, v_send), ring, sign)
    else:
        ipc = ring.ipc()
        k_ptr, v_ptr = ipc.send_begin(sign, (k3, v3))
        out, lse = flash_stream(q3, k3, v3, k_ptr, v_ptr, pred, causal, q_start, k_start)
        ipc.send_end(sign)
        k_next, v_next = ipc.recv(sign, (k3, v3))
    return (out.view(b, h, s_q, d), lse.view(b, h, s_q), k_next.view(b, h, s_kv, d),
            v_next.view(b, h, s_kv, d))
