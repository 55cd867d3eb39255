"""MNIST MLP, the counterpart of ``dsml_tpu/models/mlp.py``: a configurable
fully-connected classifier (default 784-128-64-10, ReLU hidden layers).

The parameters are ``w0 [in, out], b0, w1, b1, …`` used as ``x @ w + b``,
the JAX package's names and layouts, so ``models.convert.params_from_jax``
loads a JAX tree unchanged. :meth:`MLP.init` draws He-normal weights from a
``torch.Generator``: ``jax.random`` has no torch twin, so the same seed does
not give the JAX weights (the parity tests load those).

The flat-parameter API is the wire protocol's surface (JAX ``mlp.py:62-124``):
one f32 vector ``[W0, b0, W1, b1, …]`` (the reference client's gradient
buffer order), :meth:`MLP.flatten` / :meth:`MLP.unflatten` between it and
the named tensors, and :meth:`MLP.forward_flat` / :meth:`MLP.backward_flat`,
which the device server's ``RunForward`` / ``RunBackward`` run on the
buffers it holds.
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
        self._shapes = [tuple(getattr(self, f"{k}{i}").shape)
                        for i in range(self.n_layers) for k in ("w", "b")]

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
        return self._apply_params(dict(self.named_parameters()), x)

    forward = apply

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy against integer labels ``y``."""
        return softmax_xent(self.apply(x), y)

    # ---- flat-buffer compute (the wire protocol's surface) -------------------

    def flatten(self, params: dict | None = None) -> torch.Tensor:
        """``[W0, b0, W1, b1, …]`` as one vector (this module's own
        parameters when ``params`` is None)."""
        params = params if params is not None else dict(self.named_parameters())
        return torch.cat([params[f"{k}{i}"].detach().reshape(-1)
                          for i in range(self.n_layers) for k in ("w", "b")])

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Named views into a flat parameter vector."""
        if flat.numel() != self.n_params:
            raise ValueError(f"flat vector has {flat.numel()} values; the MLP has {self.n_params}")
        out, off = {}, 0
        for j, shape in enumerate(self._shapes):
            n = math.prod(shape)
            out[f"{'wb'[j % 2]}{j // 2}"] = flat[off:off + n].view(shape)
            off += n
        return out

    def _apply_params(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x`` under the named tensors ``params``."""
        h = x
        for i in range(self.n_layers):
            h = h @ params[f"w{i}"] + params[f"b{i}"]
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h

    def forward_flat(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x`` under the flat parameters ``flat``."""
        with torch.no_grad():
            return self._apply_params(self.unflatten(flat), x)

    def backward_flat(self, flat: torch.Tensor, x: torch.Tensor,
                      dlogits: torch.Tensor) -> torch.Tensor:
        """The parameter gradient of ⟨logits, dlogits⟩ in the flat layout:
        backprop of an upstream logits gradient through the forward of
        ``x`` (recomputed here, as ``jax.grad`` does)."""
        with torch.enable_grad():
            fp = flat.detach().requires_grad_(True)
            logits = self._apply_params(self.unflatten(fp), x)
            (grad,) = torch.autograd.grad(logits, fp, grad_outputs=dlogits)
        return grad
