"""The KV-row codec of the paged and quantized KV caches — the counterpart
of ``dsml_tpu/ops/quantization.py``'s ``pack_int4`` … ``kv_row_bytes``.

A K or V row (one position, one head) quantizes on its own with a
symmetric absmax scale, so a cache or page write never touches another
row's bytes, and a row's bytes are the same in a dense cache and in a page
pool. int8 stores the values as they are; int4 packs two offset nibbles per
byte with the channel halves contiguous: byte j holds channel j in its high
nibble and channel j + hd/2 in its low nibble, each offset by +8. The
rounding is ``torch.round``, which rounds half to even like ``jnp.round``,
so both packages write the same bytes for the same rows.

The rest of the JAX module (blocked weight quantization and its matmul
kernel, the int8 collective codec) comes with later slices.
"""

from __future__ import annotations

import torch

__all__ = ["dequantize_kv_rows", "kv_row_bytes", "pack_int4", "quantize_kv_rows", "unpack_int4"]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack integer values in [-7, 7] two per byte along the last axis
    (which must be even): the first half of the axis goes to the high
    nibbles, the second half to the low ones, each offset to q + 8."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {tuple(q.shape)}")
    q = q.to(torch.int32) + 8
    half = q.shape[-1] // 2
    return (q[..., :half] << 4 | q[..., half:]).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., k]`` packed bytes → ``[..., 2k]``
    int8 in [-7, 7] (channel halves contiguous)."""
    hi = (p >> 4).to(torch.int8) - 8
    lo = (p & 0xF).to(torch.int8) - 8
    return torch.cat([hi, lo], dim=-1)


def quantize_kv_rows(x: torch.Tensor, mode: str = "int4"):
    """Symmetric absmax quantization of KV rows ``[..., rows, hd]`` →
    ``(values, f32 scales [..., rows, 1])``, one scale per row; a zero row
    gets scale 1. ``mode="int8"`` gives int8 values, ``"int4"`` packed
    uint8 (:func:`pack_int4`, even ``hd``)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown KV quant mode {mode!r}; choose 'int8' or 'int4'")
    x32 = x.float()
    a = x32.abs().amax(dim=-1, keepdim=True)
    if mode == "int4":
        if x.shape[-1] % 2:
            raise ValueError(f"int4 KV rows need an even trailing dim, got {tuple(x.shape)}")
        s = torch.where(a > 0, a / 7.0, 1.0)
        return pack_int4(torch.clamp(torch.round(x32 / s), -7, 7)), s
    s = torch.where(a > 0, a / 127.0, 1.0)
    return torch.round(x32 / s).to(torch.int8), s


def dequantize_kv_rows(values: torch.Tensor, scales: torch.Tensor, mode: str = "int4") -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` → f32 rows ``[..., rows, hd]``.
    The serving path never calls it (attention folds the scales in after
    its products); it is for round-trip tests and tools."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown KV quant mode {mode!r}; choose 'int8' or 'int4'")
    q = unpack_int4(values) if mode == "int4" else values
    return q.float() * scales


def kv_row_bytes(head_dim: int, mode: str | None) -> int:
    """Device bytes of one K or V row (one position, one head) under
    ``mode`` (None = f32), its scale included."""
    if mode is None:
        return 4 * head_dim
    if mode == "int8":
        return head_dim + 4  # int8 values + one f32 scale
    if mode == "int4":
        if head_dim % 2:
            raise ValueError(f"int4 KV rows need an even head_dim, got {head_dim}")
        return head_dim // 2 + 4  # two nibbles per byte + one f32 scale
    raise ValueError(f"unknown KV quant mode {mode!r}")
