"""32-bit counter hashing in int64 tensor arithmetic.

The port draws its random numbers from counters where the JAX package
draws them from ``jax.random`` or the TPU's on-core generator, neither of
which has a twin here: the sampler's noise per (request, step, token)
(``serving/batcher.py::request_uniform``) and the stochastic rounding of
``ops/quantization.py::quantize_int8`` per (seed, element). Every value
stays below 2**32 in int64, so the same expressions give the same bits on
the CPU and the card, and a CUDA kernel reproduces them with ``uint32_t``
arithmetic.
"""

from __future__ import annotations

__all__ = ["M32", "mix32", "mul32"]

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
