"""Plain causal multi-head attention (counterpart of ``dsml_tpu/ops/attention.py``
``attention``). The ring, Ulysses and 2D variants come with the
long-context slice."""

from __future__ import annotations

import torch

__all__ = ["attention"]

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Scaled dot-product attention. Shapes: [batch, heads, seq, head_dim].
    The causal mask is aligned to the END of the keys, as in the JAX
    version: query i of s_q sees keys 0 .. s_k - s_q + i."""
    scale = q.shape[-1] ** -0.5
    scores = (q @ k.transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, _NEG_INF)
    return torch.softmax(scores, dim=-1) @ v
