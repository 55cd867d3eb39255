"""Pieces shared across model families (counterpart of
``dsml_tpu/models/common.py``). This slice carries only the plain-weight
matmul site; block-quantized serving weights and their dequant-fused kernel
come with the ``weight_quant`` slice."""

from __future__ import annotations

import torch

__all__ = ["qmatmul"]


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """The matmul site of every projection: ``x``'s last axis against the
    weight's first. GPT-2's fused ``wqkv [d, 3, d]`` is the
    ``[b, s, d]·[d, slots, d]`` einsum and comes back ``[b, s, 3, d]``;
    a 2-D weight is ``x @ w``."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized weight leaves ({type(w).__name__}) come with the weight_quant "
            "serving slice (port of dsml_tpu/ops/quantization.py::_qmm_kernel)"
        )
    return torch.einsum("bsd,dke->bske", x, w) if w.ndim == 3 else x @ w
