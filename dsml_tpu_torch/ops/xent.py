"""Chunked softmax cross-entropy, the counterpart of ``dsml_tpu/ops/xent.py``:
the full [tokens, vocab] logits never exist.

For a tied-embedding LM the loss ``mean(logsumexp(h·Wᵀ) - h·W[target])``
would otherwise materialise [batch·seq, vocab] f32 logits (GPT-2-small at
batch 8 × seq 1024 × vocab 50257 is ~1.6 GB). This computes the same value
by walking the vocab in chunks:

- forward: a running (row max, sum-exp) across chunks plus the target
  logit (each target lives in exactly one chunk);
- backward: per chunk, recompute ``p = exp(h·Wcᵀ - lse)``, subtract the
  one-hot target, and accumulate ``dh += ds·Wc`` and ``dWc = dsᵀ·h``.

Peak memory is [tokens, chunk]. This module has no kernel: the chunks are
plain matrix products.
"""

from __future__ import annotations

import torch

__all__ = ["chunked_softmax_xent"]


def _chunks(wte: torch.Tensor, chunk: int):
    """(start, [chunk rows of wte] in f32) over the vocab; the last chunk
    may be short (the JAX version pads it and masks the padding to -inf,
    which adds nothing to either sum)."""
    for c0 in range(0, wte.shape[0], chunk):
        yield c0, wte[c0:c0 + chunk].float()


class _ChunkedXent(torch.autograd.Function):
    """Per-row loss ``lse - target logit``: h [N, d], wte [V, d], targets
    [N] → [N] f32."""

    @staticmethod
    def forward(ctx, h, wte, targets, chunk):
        h32 = h.float()
        n = h.shape[0]
        m = torch.full((n,), -torch.inf, device=h.device)
        s = torch.zeros(n, device=h.device)
        tgt = torch.zeros(n, device=h.device)
        for c0, w_c in _chunks(wte, chunk):
            logits = h32 @ w_c.T  # [N, chunk]
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            local = targets - c0
            in_c = (local >= 0) & (local < w_c.shape[0])
            picked = logits.gather(1, local.clamp(0, w_c.shape[0] - 1)[:, None])[:, 0]
            tgt = tgt + torch.where(in_c, picked, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, wte, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        h, wte, targets, lse = ctx.saved_tensors
        h32, g32 = h.float(), g.float()
        dh = torch.zeros_like(h32)
        dwte = torch.empty(wte.shape, dtype=torch.float32, device=wte.device)
        for c0, w_c in _chunks(wte, ctx.chunk):
            p = torch.exp(h32 @ w_c.T - lse[:, None])  # this chunk's softmax rows
            local = targets - c0
            in_c = (local >= 0) & (local < w_c.shape[0])
            rows = torch.nonzero(in_c, as_tuple=True)[0]
            p[rows, local[rows]] -= 1.0  # the one-hot target
            ds = p * g32[:, None]  # [N, chunk]
            dh += ds @ w_c
            dwte[c0:c0 + w_c.shape[0]] = ds.T @ h32
        return dh.to(h.dtype), dwte.to(wte.dtype), None, None


def chunked_softmax_xent(h: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
                         chunk: int = 8192) -> torch.Tensor:
    """Mean next-token cross-entropy of ``h @ wte.T`` against ``targets``
    without materialising the logits. h [..., d] (any float type; the sums
    run in f32), wte [V, d] (the tied unembedding), targets [...] integer.
    Differentiable in h and wte."""
    d = h.shape[-1]
    loss = _ChunkedXent.apply(h.reshape(-1, d), wte, targets.reshape(-1).long(), int(chunk))
    return loss.mean()
