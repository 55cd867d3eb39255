"""MNIST MLP, the counterpart of ``dsml_tpu/models/mlp.py``: a configurable
fully-connected classifier (default 784-128-64-10, ReLU hidden layers).

The parameters are ``w0 [in, out], b0, w1, b1, …`` used as ``x @ w + b``,
the JAX package's names and layouts, so ``models.convert.params_from_jax``
loads a JAX tree unchanged. :meth:`MLP.init` draws He-normal weights from a
``torch.Generator``: ``jax.random`` has no torch twin, so the same seed does
not give the JAX weights (the parity tests load those). The flat-parameter
wire codecs come with the control-plane slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from dsml_tpu_torch.models.common import softmax_xent
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["MLP"]


class MLP(nn.Module):
    """Fully-connected classifier on one device (``None`` = the CUDA card).
    Fill its weights with :meth:`init` or ``load_state_dict``."""

    def __init__(self, sizes: Sequence[int] = (784, 128, 64, 10), dtype=torch.float32,
                 device=None):
        super().__init__()
        if len(sizes) < 2:
            raise ValueError("MLP needs at least input and output sizes")
        self.sizes = tuple(int(s) for s in sizes)
        self.device = resolve_device(device)
        self.n_layers = len(self.sizes) - 1
        for i, (fan_in, fan_out) in enumerate(zip(self.sizes[:-1], self.sizes[1:])):
            self.register_parameter(
                f"w{i}", nn.Parameter(torch.empty(fan_in, fan_out, dtype=dtype, device=self.device)))
            self.register_parameter(
                f"b{i}", nn.Parameter(torch.empty(fan_out, dtype=dtype, device=self.device)))
        self.n_params = sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init(self, seed: int = 0) -> "MLP":
        """He-normal weights (scale sqrt(2/fan_in)) from a ``torch.Generator``
        seeded with ``seed``, zero biases. Returns ``self``."""
        gen = torch.Generator().manual_seed(int(seed))
        for i, fan_in in enumerate(self.sizes[:-1]):
            w = getattr(self, f"w{i}")
            w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            getattr(self, f"b{i}").zero_()
        return self

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x`` [batch, in]; ReLU between layers."""
        h = x
        for i in range(self.n_layers):
            h = h @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h

    forward = apply

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy against integer labels ``y``."""
        return softmax_xent(self.apply(x), y)
