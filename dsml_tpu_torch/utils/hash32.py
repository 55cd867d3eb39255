"""32-bit counter hashing in int64 tensor arithmetic.

The port draws its random numbers from counters where the JAX package
draws them from ``jax.random`` or the TPU's on-core generator, neither of
which has a twin here: the sampler's noise per (request, step, token)
(:func:`request_uniform`, which the continuous batcher draws per request and
``GPT2.generate_spmd`` per global batch row) and the stochastic rounding of
``ops/quantization.py::quantize_int8`` per (seed, element). Every value
stays below 2**32 in int64, so the same expressions give the same bits on
the CPU and the card, and a CUDA kernel reproduces them with ``uint32_t``
arithmetic.
"""

from __future__ import annotations

import torch

__all__ = ["M32", "mix32", "mul32", "request_key", "request_uniform"]

M32 = 0xFFFFFFFF


def mul32(x, c: int):
    """Low 32 bits of ``x * c`` for x, c < 2**32, without int64 overflow
    (x split in 16-bit halves). Works on Python ints and int64 tensors."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32


def mix32(x):
    """murmur3's 32-bit finaliser: a bijection of [0, 2**32) that spreads
    every input bit over the output."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def request_key(seed: int, rid: int) -> int:
    """A request's 32-bit sampler key from (seed, rid)."""
    k = 0
    for part in (seed & M32, (seed >> 32) & M32, rid & M32, (rid >> 32) & M32):
        k = mix32(k ^ part)
    return k


def request_uniform(keys: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """Uniform noise in (0, 1), [B, vocab] f32, for request keys [B] at
    sampler steps [B] (int64 tensors on one device): a counter-based hash
    of (key, step, token id), so each (request, step) draws its own noise
    whatever batch it rides in, and the CPU and the card draw the same."""
    h = mix32(keys ^ mul32(steps + 1, 0x9E3779B9))
    ids = torch.arange(vocab, device=keys.device)
    x = mix32(mix32(h[:, None] ^ mul32(ids + 1, 0x632BE5AB)))
    return ((x >> 8).float() + 0.5) * 2.0 ** -24
