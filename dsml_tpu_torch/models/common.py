"""Pieces shared across model families (counterpart of
``dsml_tpu/models/common.py``): the matmul site of every projection and its
three weight forms (plain, per-channel int8, block-quantized for the
dequant-fused kernel), the serving twins that carry quantized weights, the
classification losses, He init and the analytic training FLOP counts that
every MFU figure divides by. The FSDP spec transforms come with the
model-parallel slice."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dsml_tpu_torch.ops.quantization import QuantizedWeight, quantize_weight_blocks, quantized_matmul

__all__ = [
    "ChannelInt8Weight", "qmatmul", "maybe_dequant", "quantize_weights_int8",
    "quantize_weights_blocked", "he_init", "softmax_xent", "count_correct",
    "transformer_train_flops", "mlp_train_flops",
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


# the transformer-block matmul weights of every family, all contracting on
# axis 0 (GPT-2's fused wqkv [d, 3, d] keeps a scale per (slot, channel))
_WQ_KEYS = frozenset({
    "wqkv", "wo", "wq", "wk", "wv",               # attention projections
    "w_in", "w_out", "w_gate", "w_up", "w_down",  # dense MLP
})


class ChannelInt8Weight(nn.Module):
    """Weight-only int8 (w8a16) with one f32 scale per output channel: the
    JAX package's ``{"qw", "qs"}`` leaf as a module with buffers ``qw``
    (int8, the weight's shape) and ``qs`` (f32 ``[1, *shape[1:]]``)."""

    def __init__(self, qw: torch.Tensor, qs: torch.Tensor):
        super().__init__()
        self.register_buffer("qw", qw)
        self.register_buffer("qs", qs)


def _quant_channels(w: torch.Tensor) -> ChannelInt8Weight:
    wf = w.detach().float()
    a = wf.abs().amax(dim=0, keepdim=True)
    qs = torch.where(a > 0, a / 127.0, 1.0)
    return ChannelInt8Weight(torch.round(wf / qs).to(torch.int8), qs)


def _twin(model: nn.Module, convert) -> nn.Module:
    """A model of ``model``'s class that SHARES its parameters (the same
    ``Parameter`` objects, so nothing is copied) except the block matmul
    weights (``layers.<i>.{attn,mlp}.<key in _WQ_KEYS>``), which become
    ``convert(weight)`` modules. Built on the meta device, so no dense
    weight is allocated for it; the caller's model stays as it was."""
    twin = type(model)(model.config, device="meta")
    twin.device = model.device
    for name, p in model.named_parameters():
        *path, key = name.split(".")
        owner = twin.get_submodule(".".join(path))
        quantized = (key in _WQ_KEYS and len(path) == 3 and path[0] == "layers"
                     and path[2] in ("attn", "mlp"))
        if isinstance(owner, nn.ParameterDict):
            if quantized:
                del owner[key]  # a ParameterDict refuses a module where a Parameter is registered
            owner[key] = convert(p) if quantized else p
        else:
            setattr(owner, key, convert(p) if quantized else p)
    return twin


def quantize_weights_int8(model: nn.Module) -> nn.Module:
    """Weight-only int8 (w8a16) for serving: a twin of ``model``
    (:func:`_twin`) whose block matmul weights are :class:`ChannelInt8Weight`
    — per-output-channel absmax scales, round half to even. Embeddings, the
    tied unembedding, norms and biases stay as they are (shared). The
    matmul site dequantizes at the operand (:func:`maybe_dequant`)."""
    return _twin(model, _quant_channels)


def quantize_weights_blocked(model: nn.Module, scheme: str = "int8",
                             block: int | None = None) -> nn.Module:
    """Serving weights for the dequant-fused kernel: a twin of ``model``
    (:func:`_twin`: embeddings, norms and biases shared, not copied) whose
    block matmul weights are ``QuantizedWeight`` modules — int8 or
    nibble-packed int4 codes with one f32 scale per (k-block, output
    channel), converted from the weights as they are (``block`` as
    ``quantize_weight_blocks`` takes it). :func:`qmatmul` sends them to
    ``quantized_matmul``. The caller's dense model stays resident: the twin
    adds only codes and scales."""
    return _twin(model, lambda w: quantize_weight_blocks(w, scheme, block))


def maybe_dequant(w, dtype=None):
    """The per-channel int8 hook of the matmul site: a
    :class:`ChannelInt8Weight` dequantizes to ``dtype`` (default f32) at the
    operand; anything else passes through."""
    if isinstance(w, ChannelInt8Weight):
        dt = dtype or torch.float32
        return w.qw.to(dt) * w.qs.to(dt)
    return w


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """The matmul site of every projection: ``x``'s last axis against the
    weight's first, in ``x``'s type. A ``QuantizedWeight`` goes to the
    dequant-fused ``quantized_matmul`` (``x`` made a contiguous [rows, d]
    matrix, the weight's trailing axes restored: ``wqkv`` comes back
    ``[..., 3, d]``); a :class:`ChannelInt8Weight` dequantizes at the
    operand; a plain 3-D weight (GPT-2's fused ``wqkv [d, 3, d]``) is the
    ``[b, s, d]·[d, slots, d]`` einsum, a 2-D one ``x @ w``."""
    if isinstance(w, QuantizedWeight):
        lead = x.shape[:-1]
        out = quantized_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
        return out.reshape(*lead, *w.shape[1:]).to(x.dtype)
    w = maybe_dequant(w, x.dtype)
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"qmatmul takes a tensor, QuantizedWeight or ChannelInt8Weight, "
                        f"got {type(w).__name__}")
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
