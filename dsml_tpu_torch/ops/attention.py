"""Attention ops — the counterpart of ``dsml_tpu/ops/attention.py``: causal
multi-head attention and the sequence-parallel variants over a ring group
(a ``parallel.peer.RingGroup`` where the JAX code takes an ``axis_name``).

- :func:`attention` — plain softmax(QKᵀ)V with causal masking.
- :func:`ring_attention` — the XLA ring: each rank holds a sequence shard,
  K/V shards rotate ``n − 1`` hops through the differentiable
  ``ops.collectives.ring_pass``, and every visiting block folds into an
  online-softmax accumulator (numerator, denominator, row max) under the
  global causal mask. Its gradient is autograd's through the fold and the
  hops (the cotangent rides one hop back), as ``jax.grad`` transposes the
  JAX ``ppermute``.
- :func:`ulysses_attention` — an all-to-all re-shard (``ops.collectives.
  all_to_all``, the JAX ``lax.all_to_all(tiled=True)``) from sequence- to
  head-sharded, attention on the full sequence of ``heads/n`` heads
  (``flash=True``: the hand-written flash kernels, ``ops.flash``), and back.
- :func:`attention_2d` — LoongTrain's 2D grid: the head all-to-all over the
  inner group, the ring (or ``ops.flash.ring_flash_attention``) over the
  outer group.

None of these is a kernel of its own: ``ring`` and ``ulysses`` are plain
PyTorch, as their JAX counterparts are XLA with no Pallas; the flash
variants run kernels 1–3 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd_tc.cu``,
``csrc/flash_bwd.cu``) on CUDA tensors.
"""

from __future__ import annotations

import torch

from dsml_tpu_torch.ops.collectives import all_to_all, ring_pass

__all__ = ["attention", "ring_attention", "ulysses_attention", "attention_2d"]

_NEG_INF = -1e30
_MAX_FLOOR = -1e20  # the ring's running-max floor (see ring_attention)


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


def _size(group) -> int:
    return 1 if group is None else group.size


def _block_scores(q, k, scale, causal, q_offset, k_offset, seq_block):
    """Scores for one (query shard, key shard) pair with the global causal
    mask: query ``q_offset·seq_block + i`` sees key ``k_offset·seq_block +
    j`` when it is not later."""
    scores = (q @ k.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset * seq_block + torch.arange(q.shape[-2], device=q.device)
        k_pos = k_offset * seq_block + torch.arange(k.shape[-2], device=q.device)
        scores = scores.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    return scores


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True) -> torch.Tensor:
    """Exact attention over a sequence sharded across ``group``: q/k/v are
    this rank's shard [batch, heads, seq/n, head_dim] (rank r holds block
    r). K/V rotate around the ring while each rank folds every visiting
    block into a running online softmax, in q's dtype as the JAX fold
    (bf16 accumulates in bf16). The running max starts at the −1e20 floor:
    a fully masked block has a row max of −1e30, and an unfloored max would
    make exp(score − max) = 1 for its masked keys. Differentiable; a group
    of one (or ``None``) is :func:`attention`."""
    n = _size(group)
    if n == 1:
        return attention(q, k, v, causal)
    rank = group.rank
    seq_block = q.shape[-2]
    scale = q.shape[-1] ** -0.5
    num = torch.zeros_like(q)
    den = torch.zeros(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    row_max = torch.full(q.shape[:-1] + (1,), _MAX_FLOOR, dtype=q.dtype, device=q.device)
    kv = (k, v)
    # n hops: fold the resident block, then rotate K/V to the next rank
    for hop in range(n):
        k_offset = (rank - hop) % n  # whose K/V block is resident this hop
        scores = _block_scores(q, kv[0], scale, causal, rank, k_offset, seq_block)
        new_max = torch.maximum(row_max, scores.amax(-1, keepdim=True))
        # rescale the accumulators to the new max, then add this block
        correction = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max)
        num = num * correction + p @ kv[1]
        den = den * correction + p.sum(-1, keepdim=True)
        row_max = new_max
        if hop != n - 1:
            kv = ring_pass(kv, group, +1)
    return num / den.clamp_min(1e-30)


def _seq_to_heads(t, group):  # [b, h, s/n, d] -> [b, h/n, s, d]
    return all_to_all(t, group, split_axis=1, concat_axis=2)


def _heads_to_seq(t, group):  # [b, h/n, s, d] -> [b, h, s/n, d]
    return all_to_all(t, group, split_axis=2, concat_axis=1)


def _check_head_split(q, n):
    if q.shape[1] % n:
        raise ValueError(f"heads ({q.shape[1]}) not divisible by axis size {n}")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      causal: bool = True, flash: bool = False) -> torch.Tensor:
    """Exact attention via all-to-all head/sequence re-sharding: the
    sequence-sharded [batch, heads, seq/n, head_dim] blocks become
    head-sharded full sequences [batch, heads/n, seq, head_dim], attention
    runs locally, and a second all-to-all flips back. Requires heads % n ==
    0. ``flash=True`` runs the local attention through the flash kernels
    (``ops.flash.flash_attention``): after the re-shard each rank holds the
    FULL sequence of its heads, where the [seq, seq] scores would otherwise
    materialise."""
    if flash:
        from dsml_tpu_torch.ops.flash import flash_attention as attn_fn
    else:
        attn_fn = attention
    n = _size(group)
    if n == 1:
        return attn_fn(q, k, v, causal)
    _check_head_split(q, n)
    out = attn_fn(_seq_to_heads(q, group), _seq_to_heads(k, group), _seq_to_heads(v, group),
                  causal)
    return _heads_to_seq(out, group)


def attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, inner_group, outer_group,
                 causal: bool = True, flash: bool = False) -> torch.Tensor:
    """LoongTrain-style 2D attention: head-parallel inner × context-parallel
    outer grid. The sequence is sharded over BOTH groups, outer-major: rank
    (o, i) holds global sub-block ``o·n_inner + i``. One all-to-all over
    the inner group re-shards heads and leaves every inner rank holding its
    group's full contiguous outer block; the ring then walks K/V around the
    outer group only, n_inner× shorter than a flat ring; a second
    all-to-all restores the layout. Requires heads % n_inner == 0; exact for
    any mask. ``flash=True`` runs the outer ring with one flash call a hop
    (``ops.flash.ring_flash_attention``)."""
    if flash:
        from dsml_tpu_torch.ops.flash import ring_flash_attention as ring_fn
    else:
        ring_fn = ring_attention
    n_inner = _size(inner_group)
    if n_inner == 1:
        return ring_fn(q, k, v, outer_group, causal)
    _check_head_split(q, n_inner)
    out = ring_fn(_seq_to_heads(q, inner_group), _seq_to_heads(k, inner_group),
                  _seq_to_heads(v, inner_group), outer_group, causal)
    return _heads_to_seq(out, inner_group)
