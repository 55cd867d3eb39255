"""Pieces shared across model families (counterpart of
``dsml_tpu/models/common.py``): the plain-weight matmul site, the
classification losses, He init and the analytic training FLOP counts that
every MFU figure divides by. Block-quantized serving weights and their
dequant-fused kernel come with the ``weight_quant`` slice; the FSDP spec
transforms with the model-parallel slice."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "qmatmul", "he_init", "softmax_xent", "count_correct", "transformer_train_flops",
    "mlp_train_flops",
]


def transformer_train_flops(cfg, n_tokens: int, seq: int, gated_mlp: bool = False) -> int:
    """Analytic matmul FLOPs for ONE training step over ``n_tokens`` tokens
    at sequence length ``seq``: the PaLM-appendix accounting (forward
    matmuls plus the causal attention term; backward = 2 × forward; remat
    recompute not counted), as the JAX package counts it.

    ``cfg`` needs ``n_layer / n_head / d_model / d_ff / vocab_size``; GQA
    shrinks the k/v projections through ``n_kv_head`` when present.
    ``gated_mlp=True`` counts the 3-matmul SwiGLU form (Llama), else the
    2-matmul in/out form (GPT-2)."""
    T = int(n_tokens)
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.vocab_size
    kv_frac = getattr(cfg, "n_kv_head", cfg.n_head) / cfg.n_head
    mlp_mats = 3 if gated_mlp else 2
    fwd = L * (
        2 * T * d * d                       # q projection
        + int(2 * 2 * T * d * d * kv_frac)  # k and v projections (GQA-shrunk)
        + 2 * T * d * d                     # attention output projection
        + 2 * 2 * T * seq * d // 2          # q·kᵀ and p·v, causal halves the area
        + mlp_mats * 2 * T * d * ff         # MLP matmuls
    ) + 2 * T * d * V                       # unembedding
    return 3 * fwd


def mlp_train_flops(n_params: int, n_samples: int) -> int:
    """The dense-MLP rule: 6 FLOPs per parameter per sample (forward 2,
    backward 4)."""
    return 6 * int(n_params) * int(n_samples)


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


def he_init(rng: np.random.Generator, *shape: int, fan_in: int) -> torch.Tensor:
    """He-normal initialization (scale sqrt(2/fan_in)), float32, from the
    same ``rng`` draws as the JAX version."""
    return torch.from_numpy((rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))


def softmax_xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def count_correct(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == y).sum()
