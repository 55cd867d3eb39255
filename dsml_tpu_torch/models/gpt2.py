"""GPT-2 in PyTorch — the counterpart of ``dsml_tpu/models/gpt2.py``.

Two single-device paths are ported. Serving: ``GPT2.generate`` runs one
:meth:`GPT2.prefill` over the prompt (its attention through the
hand-written CUDA flash kernel once the prompt reaches 512 tokens on the
card), then a loop of :meth:`GPT2.decode_step` over the dense KV cache, with
:func:`sample_token_logits` picking each token. Training: :meth:`GPT2.loss`
is the mean next-token cross-entropy over the block stack, with attention
through the flash kernels (forward and backward) when asked, dense or
chunked logits (``xent_chunk``) and optional rematerialisation (``remat``:
whole blocks, the FFN only, or ``"int8"``, which stashes each block's input
as stochastically rounded int8 through the CUDA quantizer of
``ops/quantization.py``). The plain forward :meth:`GPT2.apply` is here too,
for the parity tests.

The continuous batcher (``dsml_tpu_torch.serving``) drives the per-slot
surfaces: over the dense cache (plain, or int8/int4 with ``kv_quant``)
:meth:`GPT2.decode_step_slots`, :meth:`GPT2.prefill_chunk` and
:meth:`GPT2.verify_step`; over a page pool (:meth:`GPT2.init_page_pool`)
their paged twins, whose attention reads the pool through the page table
with the hand-written CUDA paged-attention kernels on the card
(``ops/paged_attention.py``) or through the gather path
(``DSML_PAGED_ATTN=xla``, the default on the CPU). Caches and pools are
updated in place: the JAX package returns new ones and lets XLA donate the
old buffers, which here would be a copy per step.

Every serving surface also runs on a twin whose block projections are
quantized (``models.common.quantize_weights_blocked``, the batcher's
``weight_quant``): each projection goes through ``qmatmul``, which sends a
``QuantizedWeight`` to the hand-written dequant-fused matmul kernel.

Weights keep the JAX package's layouts (``wqkv [d, 3, d]``, ``w_in [d, d_ff]``
used as ``x @ W``, q/k/v ``[batch, heads, seq, head_dim]``) and names: the
module's ``state_dict()`` keys are the dotted paths of the JAX parameter
tree (``layers.0.attn.wqkv``), so ``models.convert.params_from_jax`` maps
one onto the other. :meth:`GPT2.init` draws the same
``np.random.default_rng(seed)`` sequence as the JAX init, so both packages
build identical weights from one seed.

Sequence and context parallelism: :meth:`GPT2.loss` and :meth:`GPT2.apply`
take an ``sp_group`` (a ``parallel.peer.RingGroup`` of the mesh's ``sp``
or ``cp`` axis) over which the sequence is sharded, as ``dsml_tpu``'s
``loss_spmd``/``apply_spmd`` take ``sp_axis``: each rank holds its
contiguous shard of the tokens, positions start at the shard's origin
(Llama's RoPE at the GLOBAL positions), attention is routed as the JAX
``_route_attention`` routes it (:meth:`GPT2._attend`: the flash ring
``"ring2"``, Ulysses, ``"ring_flash"`` or the XLA ring) and the loss is
this rank's mean over its own rows (``parallel/hybrid.py`` reduces it over
the group).

Experts: with ``n_experts > 0`` every block's MLP is the top-k gated
mixture of experts of the JAX ``_moe_block`` (:meth:`GPT2._moe_block`),
GELU experts with biases, capacity-bounded sort/segment routing (overflow
dropped), on every surface: training, ``generate`` and the batcher's dense
and paged ticks. Under tp the experts are sharded over the tp group
(expert parallelism, ep = tp): each rank routes its 1/ep slice of the
tokens and the payloads ride ``ops.collectives.all_to_all`` to the
experts' owners and back.

Tensor and pipeline parallelism: a model built with ``tp_group`` (a
``RingGroup`` of the mesh's ``tp`` axis) holds this rank's Megatron shard
of every weight, as :meth:`GPT2.param_specs` cuts the JAX tree
(vocab-sharded ``wte``, column-parallel ``wqkv [d, 3, d/tp]`` and ``w_in``,
row-parallel ``wo`` and ``w_out``, ``n_head/tp`` local heads), and runs the
JAX ``_block``'s psums as ``parallel.tp``'s conjugate pairs, the embedding
as the masked gather and the loss as the vocab-parallel cross-entropy. A
model built with ``layer_ids`` holds only those layers (a pipeline stage,
in the order ``parallel.pp`` runs them: the JAX stacked and
interleave-permuted layer axis, cut by rank); its blocks run through
``parallel.pp``'s schedules, not :meth:`GPT2.loss`. :meth:`GPT2.init` draws
the whole model's ``np.random.default_rng(seed)`` sequence and keeps this
rank's blocks, so every rank holds the shard of the same weights.

Serving on a tp shard (the JAX ``generate_spmd`` and the batcher's
``mesh``): every serving surface runs head-parallel, the cache and the page
pool holding this rank's ``n_head/tp`` heads (Llama: ``n_kv_head/tp``), one
all-reduce after each row-parallel projection, and the logits row rebuilt
whole on every rank (:meth:`GPT2._unembed_full`, an all-gather of the vocab
shards), so every rank samples the same token from bit-identical logits.
:meth:`GPT2.generate_spmd` is :meth:`GPT2.generate` on such a shard, with
the batch optionally split over the mesh's ``dp`` axis. A pipeline stage
does not serve: the JAX package has no pipeline-parallel serving either.

The model-family hooks (``models/llama.py`` overrides them, as the JAX
``Llama`` overrides ``GPT2``'s): every surface turns its token positions
into :meth:`GPT2._rotary` once (nothing here, GPT-2's positions live in
``wpe``; Llama's RoPE tables) and hands that to :meth:`GPT2._serving_qkv`
in every layer; :meth:`GPT2._attn_kv` widens the cache's K/V to what the
shared attention takes (Llama repeats its kv heads);
:meth:`GPT2._unembed_matrix` is the unembedding the dense and the chunked
loss both read (``wte`` here, Llama's untied ``lm_head``);
:attr:`GPT2._n_cache_heads` is the head count of the cache and the page
pool (Llama's kv heads); :meth:`GPT2._add_attn_out` adds the attention
output (and GPT-2's ``bo``) to the residual.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dsml_tpu_torch.models.common import fsdp_spec_fn, qmatmul, shard_leaf
from dsml_tpu_torch.ops.attention import _NEG_INF, attention, ulysses_attention
from dsml_tpu_torch.ops.attention import ring_attention as xla_ring_attention
from dsml_tpu_torch.ops.collectives import all_gather, all_to_all
from dsml_tpu_torch.ops.flash import flash_attention, ring_flash_attention
from dsml_tpu_torch.ops.paged_attention import paged_attention, paged_attn_impl
from dsml_tpu_torch.ops.quantization import compressed_checkpoint, quantize_kv_rows, unpack_int4
from dsml_tpu_torch.ops.ring_attention import ring_attention
from dsml_tpu_torch.ops.xent import chunked_softmax_xent
from dsml_tpu_torch.parallel.tp import (all_gather_tp, copy_to_tp, gather_from_tp,
                                        reduce_from_tp, split_to_tp, tp_rank, tp_size,
                                        vocab_parallel_embed, vocab_parallel_xent)
from dsml_tpu_torch.utils.hash32 import request_key, request_uniform
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["GPT2Config", "GPT2", "sample_token_logits"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: str = "float32"  # params/activations dtype: "float32" | "bfloat16"
    # rematerialisation in the backward: True recomputes each block
    # (torch.utils.checkpoint), "mlp" only its FFN sub-block, "int8" each
    # block from its input stashed as int8 (ops.quantization.compressed_checkpoint)
    remat: bool | str = False
    # loss: stream the unembedding in chunks of this many vocab rows
    # (ops/xent.py) when vocab_size > xent_chunk; 0 = dense logits
    xent_chunk: int = 8192
    # MoE: 0 experts = dense MLP; otherwise the top-k gated expert layer
    # (GPT2._moe_block), experts sharded over tp
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    # interleaved virtual pipeline stages (Megatron PTD-P): each pp rank
    # holds this many non-contiguous layer chunks (parallel/pp.py); gpipe only
    pp_interleave: int = 1
    # dense KV cache codec: False (model dtype) | True/"int8" | "int4"
    kv_quant: bool | str = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from {sorted(_DTYPES)}")
        if self.remat not in (False, True, "int8", "mlp"):
            raise ValueError(
                f"unknown remat mode {self.remat!r}; choose False, True, 'int8', or 'mlp'")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def small() -> "GPT2Config":
        """GPT-2-small, 124M params."""
        return GPT2Config()

    @staticmethod
    def medium() -> "GPT2Config":
        """GPT-2-medium, 350M params."""
        return GPT2Config(n_layer=24, n_head=16, d_model=1024, d_ff=4096)

    @staticmethod
    def large() -> "GPT2Config":
        """GPT-2-large, 774M params."""
        return GPT2Config(n_layer=36, n_head=20, d_model=1280, d_ff=5120)

    @staticmethod
    def xl() -> "GPT2Config":
        """GPT-2-XL, 1.5B params."""
        return GPT2Config(n_layer=48, n_head=25, d_model=1600, d_ff=6400)

    @staticmethod
    def tiny(vocab_size: int = 512, n_experts: int = 0) -> "GPT2Config":
        """Test-sized config."""
        return GPT2Config(
            vocab_size=vocab_size, max_seq=128, n_layer=2, n_head=8, d_model=64, d_ff=128,
            n_experts=n_experts,
        )

    @classmethod
    def by_name(cls, name: str, **tiny_kwargs) -> "GPT2Config":
        """Preset lookup over {tiny, small, medium, large, xl};
        ``tiny_kwargs`` reach only the ``tiny`` preset."""
        presets = {"tiny": cls.tiny, "small": cls.small, "medium": cls.medium,
                   "large": cls.large, "xl": cls.xl}
        if name not in presets:
            raise ValueError(f"unknown GPT-2 preset {name!r}; choose from {sorted(presets)}")
        return presets[name](**tiny_kwargs) if name == "tiny" else presets[name]()


def sample_token_logits(logits: torch.Tensor, generator: torch.Generator | None,
                        temperature: float, top_k: int = 0,
                        top_p: float = 0.0, uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token ids from ``logits`` [..., vocab]: greedy (first maximum)
    at ``temperature <= 0``, else softmax sampling, optionally truncated to
    the ``top_k`` most likely tokens (ties with the k-th value are kept)
    and/or the nucleus holding ``top_p`` mass (the argmax is always kept).
    Sampling is Gumbel-max over uniform noise in (0, 1) of the logits'
    shape: ``uniform`` when given (the continuous batcher's noise per
    request and step), else drawn from ``generator``. The same noise gives
    the same tokens, but not the JAX package's tokens."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p > 0.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(-1)
        keep = (cum - probs) < top_p  # mass BEFORE this token < p
        cutoff = torch.where(keep, sorted_logits, math.inf).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    u = uniform if uniform is not None else torch.rand(logits.shape, generator=generator,
                                                       device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (logits + gumbel).argmax(-1)


def _layer_norm(x, scale, bias, eps=1e-5):
    """Normalise in f32, cast back to ``x``'s type, THEN apply scale and
    bias in the parameter type — the JAX order, which bf16 runs depend on."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


class GPT2(nn.Module):
    """Decoder-only transformer. Build it, then fill its weights with
    :meth:`init` (or ``load_state_dict``): the constructor allocates them
    uninitialised on ``device`` (``None`` = the CUDA card). ``tp_group``
    makes it this rank's tensor-parallel shard, ``layer_ids`` (global layer
    indices, in the order the stage runs them) a pipeline stage's layers
    (see the module docstring)."""

    _ATTN_IMPLS = ("ring", "ring2", "ulysses", "ulysses_flash", "ring_flash", "flash", "xla")

    def __init__(self, config: GPT2Config | None = None, device=None, tp_group=None,
                 layer_ids=None):
        super().__init__()
        self.config = cfg = config or GPT2Config.small()
        self.device = resolve_device(device)
        self._set_parallel(tp_group, layer_ids)
        dt, d, tp = cfg.torch_dtype, cfg.d_model, self.tp

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=self.device))

        def norm():
            return nn.ParameterDict({"scale": param(d), "bias": param(d)})

        self.wte = param(cfg.vocab_size // tp, d)
        self.wpe = param(cfg.max_seq, d)
        self.ln_f = norm()
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ln_1": norm(),
                "ln_2": norm(),
                "attn": nn.ParameterDict({
                    "wqkv": param(d, 3, d // tp), "bqkv": param(3, d // tp),
                    "wo": param(d // tp, d), "bo": param(d),
                }),
                **({"moe": self._moe_params(param)} if cfg.n_experts else {
                    "mlp": nn.ParameterDict({
                        "w_in": param(d, cfg.d_ff // tp), "b_in": param(cfg.d_ff // tp),
                        "w_out": param(cfg.d_ff // tp, d), "b_out": param(d),
                    })}),
            })
            for _ in self.layer_ids
        )

    def _moe_params(self, param) -> nn.ParameterDict:
        """One expert layer's parameters, this rank's experts of them (the
        JAX ``_moe_param_init`` layout; the gate replicated): shared by
        every family that mounts :meth:`_moe_block`."""
        cfg = self.config
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts // self.tp
        return nn.ParameterDict({"gate": param(d, cfg.n_experts), "w_in": param(e, d, ff),
                                 "b_in": param(e, ff), "w_out": param(e, ff, d),
                                 "b_out": param(e, d)})

    def _set_parallel(self, tp_group, layer_ids) -> None:
        """The tensor-parallel group and the held layers, with the JAX
        package's divisibility checks (``_block_closure``; the vocab, which
        ``device_put`` refuses to split unevenly there)."""
        cfg = self.config
        self.tp_group = tp_group if tp_size(tp_group) > 1 else None
        self.tp = tp_size(tp_group)
        if cfg.n_head % self.tp:
            raise ValueError(f"n_head={cfg.n_head} not divisible by tp={self.tp}")
        if cfg.vocab_size % self.tp:
            raise ValueError(f"vocab_size={cfg.vocab_size} not divisible by tp={self.tp}")
        if cfg.n_experts % self.tp:
            raise ValueError(f"n_experts={cfg.n_experts} not divisible by tp={self.tp}")
        self.layer_ids = list(range(cfg.n_layer)) if layer_ids is None else list(layer_ids)

    @property
    def is_partial(self) -> bool:
        """True for a tensor-parallel shard or a pipeline stage."""
        return self.tp > 1 or self.layer_ids != list(range(self.config.n_layer))

    def param_specs(self, fsdp: int = 1) -> dict:
        """``{dotted name: spec}`` of the WHOLE model (layers ``0 ..
        n_layer-1``), the JAX ``param_specs``: Megatron tp sharding, and with
        ``fsdp > 1`` every leaf also ZeRO-sharded on its first free divisible
        dim (``models.common.with_fsdp``). Under pp the JAX tree stacks the
        layers and shards that axis over ``pp`` (``parallel.pp.pipeline_specs``)."""
        cfg = self.config
        d, ff, V, S = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq
        F = fsdp_spec_fn(fsdp)
        layer = {
            "ln_1.scale": F((), d), "ln_1.bias": F((), d),
            "ln_2.scale": F((), d), "ln_2.bias": F((), d),
            # column-parallel (heads split); fsdp takes the input dim
            "attn.wqkv": F((None, None, "tp"), d, 3, d),
            "attn.bqkv": F((None, "tp"), 3, d),
            "attn.wo": F(("tp", None), d, d),  # row-parallel
            "attn.bo": F((), d),
            **(self._moe_specs(fsdp) if cfg.n_experts else {
                "mlp.w_in": F((None, "tp"), d, ff),
                "mlp.b_in": F(("tp",), ff),
                "mlp.w_out": F(("tp", None), ff, d),
                "mlp.b_out": F((), d),
            }),
        }
        specs = {"wte": F(("tp", None), V, d), "wpe": F((), S, d),
                 "ln_f.scale": F((), d), "ln_f.bias": F((), d)}
        for i in range(cfg.n_layer):
            specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
        return specs

    def _moe_specs(self, fsdp: int = 1) -> dict:
        """The JAX ``_moe_specs``: experts sharded over tp (EP), the gate
        replicated; fsdp on each leaf's first free divisible dim."""
        cfg = self.config
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        F = fsdp_spec_fn(fsdp)
        return {"moe.gate": F((), d, E),
                "moe.w_in": F(("tp", None, None), E, d, ff),
                "moe.b_in": F(("tp", None), E, ff),
                "moe.w_out": F(("tp", None, None), E, ff, d),
                "moe.b_out": F(("tp", None), E, d)}

    def local_name(self, name: str) -> str | None:
        """This model's parameter name for the whole model's ``name``
        (``layers.<global id>.*`` → ``layers.<position>.*``), or None when
        the stage does not hold that layer."""
        if not name.startswith("layers."):
            return name
        _, lid, rest = name.split(".", 2)
        pos = {g: i for i, g in enumerate(self.layer_ids)}.get(int(lid))
        return None if pos is None else f"layers.{pos}.{rest}"

    def local_shards(self, full: dict) -> dict:
        """``{this model's name: this rank's block}`` of the WHOLE model's
        weights ``full`` (``{dotted name: array or tensor}``, the JAX tree's
        names and shapes; names this rank does not hold are left out)."""
        specs = self.param_specs()
        coords, sizes = {"tp": tp_rank(self.tp_group)}, {"tp": self.tp}
        return {self.local_name(name): shard_leaf(arr, specs[name], coords, sizes)
                for name, arr in full.items() if self.local_name(name) is not None}

    @torch.no_grad()
    def load_full(self, full: dict) -> "GPT2":
        """Copy :meth:`local_shards` of ``full`` into this model."""
        params = dict(self.named_parameters())
        for local, cut in self.local_shards(full).items():
            params[local].copy_(torch.as_tensor(np.ascontiguousarray(cut)
                                                if isinstance(cut, np.ndarray) else cut))
        return self

    def _check_servable(self, what: str) -> None:
        """Serving runs on the whole model or on a tp shard; a pipeline
        stage raises (the JAX package has no pipeline-parallel serving)."""
        if self.layer_ids != list(range(self.config.n_layer)):
            raise NotImplementedError(
                f"{what} on a pipeline stage: serving runs on the whole model or on a "
                "tensor-parallel shard, and there is no pipeline-parallel serving")

    def shard(self, tp_group, device=None) -> "GPT2":
        """A new model of this class and config holding this rank's tp shard
        of this WHOLE model's weights (the JAX ``shard_params`` placement),
        on ``device`` (default: this model's device)."""
        if self.is_partial:
            raise ValueError("shard() cuts a whole model; this one is already a shard or a stage")
        model = type(self)(self.config, device=self.device if device is None else device,
                           tp_group=tp_group)
        return model.load_full(self.state_dict())

    # ---- params ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "GPT2":
        """Fill the weights from ``np.random.default_rng(seed)`` in the JAX
        init's order and scales (``dsml_tpu/models/gpt2.py::GPT2.init``):
        the same seed gives the same f32 weights in both packages (a bf16
        model rounds them from f32). Returns ``self``."""
        cfg = self.config
        d, ff = cfg.d_model, cfg.d_ff
        normal = self._drawer(seed)

        def unit_norm(ln):
            ln["scale"].fill_(1.0)
            ln["bias"].zero_()

        # GPT-2 scales residual-path projections by 1/sqrt(2*n_layer)
        res_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        normal("wte", (cfg.vocab_size, d))
        normal("wpe", (cfg.max_seq, d), std=0.01)
        unit_norm(self.ln_f)
        for i in range(cfg.n_layer):
            normal(f"layers.{i}.attn.wqkv", (d, 3, d))
            normal(f"layers.{i}.attn.wo", (d, d), std=res_std)
            if cfg.n_experts:
                self._moe_draw(normal, i, res_std)
            else:
                normal(f"layers.{i}.mlp.w_in", (d, ff))
                normal(f"layers.{i}.mlp.w_out", (ff, d), std=res_std)
        for layer in self.layers:
            unit_norm(layer["ln_1"])
            unit_norm(layer["ln_2"])
            for key in ("bqkv", "bo"):
                layer["attn"][key].zero_()
            for key in ("b_in", "b_out"):
                layer["moe" if cfg.n_experts else "mlp"][key].zero_()
        return self

    def _moe_draw(self, normal, i: int, res_std: float) -> None:
        """Layer ``i``'s expert draws in the JAX ``_moe_param_init`` order:
        ``gate``, ``w_in``, then ``w_out`` at ``res_std`` (the biases are
        zeros, not draws)."""
        cfg = self.config
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        normal(f"layers.{i}.moe.gate", (d, E))
        normal(f"layers.{i}.moe.w_in", (E, d, ff))
        normal(f"layers.{i}.moe.w_out", (E, ff, d), std=res_std)

    def _drawer(self, seed: int):
        """``normal(name, full_shape, std)``: the next ``standard_normal``
        draw of ``np.random.default_rng(seed)`` at the WHOLE model's shape
        (the JAX init's sequence), this rank's shard of it copied in when it
        holds ``name``."""
        rng = np.random.default_rng(seed)

        def normal(name, shape, std=0.02):
            arr = rng.standard_normal(shape)
            arr *= std  # in place: the same f64 products, without a second f64 array
            self.load_full({name: arr.astype(np.float32)})

        return normal

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---- forward --------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor, offset: int | torch.Tensor = 0) -> torch.Tensor:
        """Token + position embedding → [b, s, d]; positions start at
        ``offset``: an int, or a tensor [b, 1] of per-row starts."""
        pos = torch.arange(tokens.shape[1], device=tokens.device) + offset
        return vocab_parallel_embed(self.wte, tokens, self.tp_group) + self.wpe[pos]

    def _qkv_heads(self, layer, x):
        """Fused QKV projection (``wqkv [d, 3, d]``) and head split →
        q, k, v [b, n_head, s, head_dim]."""
        attn = layer["attn"]
        qkv = qmatmul(x, attn["wqkv"]) + attn["bqkv"]  # [b, s, 3, d]
        b, s = x.shape[:2]

        def heads(t):  # [b, s, d/tp] -> [b, h/tp, s, hd]
            return t.reshape(b, s, self.config.n_head // self.tp, -1).transpose(1, 2)

        return heads(qkv[:, :, 0]), heads(qkv[:, :, 1]), heads(qkv[:, :, 2])

    @staticmethod
    def _merge_heads(t):  # [b, H, s, hd] -> [b, s, d]
        b, _, s, _ = t.shape
        return t.transpose(1, 2).reshape(b, s, -1)

    def _tp_in(self, x):
        """In front of a column-parallel projection (``parallel.tp.copy_to_tp``)."""
        return copy_to_tp(x, self.tp_group)

    def _tp_out(self, x):
        """After a row-parallel projection: the JAX psum (``reduce_from_tp``)."""
        return reduce_from_tp(x, self.tp_group)

    def _mlp_block(self, mlp, x):
        # jax.nn.gelu defaults to the tanh approximation; the erf form
        # differs by up to ~5e-4 per activation
        hmid = F.gelu(qmatmul(self._tp_in(x), mlp["w_in"]) + mlp["b_in"], approximate="tanh")
        return self._tp_out(qmatmul(hmid, mlp["w_out"])) + mlp["b_out"]

    def _ffn(self, layer, h):
        x = _layer_norm(h, layer["ln_2"]["scale"], layer["ln_2"]["bias"])
        if self.config.n_experts:
            return h + self._moe_block(layer["moe"], x)
        return h + self._mlp_block(layer["mlp"], x)

    def _moe_route(self, gate, toks, dtype):
        """(top_p [t', k] in ``dtype``, flat_e [t'·k], pos [t'·k], counts
        [E]) of the tokens ``toks`` [t', d] under the gate weight ``gate``:
        softmax in f32, the top k renormalised in f32, ``pos`` each
        assignment's position in its expert's segment among THESE
        assignments. The stable sorts keep the lower expert first on a tie
        (``lax.top_k``) and the flattened token-major order within each
        expert (``jnp.argsort(stable=True)``)."""
        n_exp, k = self.config.n_experts, self.config.expert_top_k
        probs = torch.softmax((toks @ gate.to(toks.dtype)).float(), dim=-1)
        top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
        top_p = probs.gather(-1, top_e)
        top_p = (top_p / top_p.sum(-1, keepdim=True)).to(dtype)
        flat_e = top_e.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        counts = torch.zeros(n_exp, dtype=flat_e.dtype, device=toks.device).index_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = counts.cumsum(0) - counts  # exclusive prefix
        pos = torch.empty_like(flat_e)
        pos[order] = torch.arange(flat_e.shape[0], device=toks.device) - starts[flat_e[order]]
        return top_p, flat_e, pos, counts

    def _moe_block(self, moe, x):
        """The top-k gated mixture of experts of ``x`` [b, s, d] (the JAX
        ``_moe_block``), experts sharded over the tp group (ep = tp).

        Routing is capacity-bounded over the block's T = b·s tokens, each
        expert taking ``capacity = int(capacity_factor·T·k/E) + 1``
        assignments and the overflow dropped, in the sort/segment form: the
        T·k assignments stable-sorted by expert id, each one's position in
        its expert's buffer its sorted index minus the expert's segment
        start (an exclusive prefix of the counts), so the flattened
        token-major order sets the priority; dispatch is a scatter-add of
        token rows into the flat [E·C, d] buffer (dropped assignments land
        in a dummy row), combine a gather of each assignment's expert
        output weighted by its renormalised gate probability. Nothing of the
        dense [T, E, C] one-hot is ever built.

        Three branches, as in the JAX block: one device routes all T; under
        ep > 1 with T % ep == 0 each rank routes its 1/ep token slice
        (positions made global from an all-gather of the per-rank expert
        counts), ``all_to_all`` ships the [E, C, d] slot payloads to the
        experts' owners (the slots are disjoint, so summing what arrives is
        exact), the resident experts run, a second ``all_to_all`` returns
        each token slice's partial outputs to its rank and an all-gather
        restores replication; otherwise every rank routes all T, runs its
        own experts on their slots and the outputs are summed over the
        group (with the JAX warning). Gradients follow the port's tp rule
        (``parallel/tp.py``): the gate and the block input carry every
        rank's share, the expert shards their own."""
        cfg = self.config
        b, s, d = x.shape
        n_exp, k = cfg.n_experts, cfg.expert_top_k
        group, ep = self.tp_group, self.tp
        exp_local = n_exp // ep
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        capacity = int(cfg.capacity_factor * t * k / n_exp) + 1
        n_slots = n_exp * capacity
        gate = copy_to_tp(moe["gate"], group)  # used on per-rank tokens: its grads summed

        def arange(n):
            return torch.arange(n, device=x.device)

        def route(toks):
            return self._moe_route(gate, toks, x.dtype)

        def scatter_tokens(slot, tok_idx, toks, n_rows):
            """Flat [n_rows, d] buffer with ``toks[tok_idx]`` added at
            ``slot``; slot ``n_rows`` is the dummy row of dropped
            assignments."""
            buf = toks.new_zeros((n_rows + 1, d))
            return buf.index_add(0, slot, toks[tok_idx])[:-1]

        use_a2a = ep > 1 and t % ep == 0
        if ep > 1 and not use_a2a:
            warnings.warn(
                f"MoE a2a dispatch disabled: {t} tokens per rank do not split "
                f"over ep={ep}; falling back to replicated dispatch + psum "
                "(correct, but pays replicated expert FLOPs and a psum instead "
                "of the all_to_all payload exchange)",
                stacklevel=2,
            )
        r = tp_rank(group)
        if use_a2a:
            t_local = t // ep
            n_loc = t_local * k
            tok_r = split_to_tp(tokens, group)
            top_p_r, flat_e_r, pos_loc, counts_r = route(tok_r)
            counts_all = all_gather(counts_r, group, tiled=False)  # [ep, E]
            rank_base = counts_all.cumsum(0) - counts_all  # exclusive over ranks
            pos_r = pos_loc + rank_base[r][flat_e_r]  # the global capacity position
            kept_r = pos_r < capacity
            partial = scatter_tokens(torch.where(kept_r, flat_e_r * capacity + pos_r, n_slots),
                                     arange(n_loc) // k, tok_r, n_slots).reshape(n_exp, capacity, d)
            # our experts' slots from every rank, concatenated on the capacity
            # axis: disjoint slots, so the sum is the exact buffer
            recv = all_to_all(partial, group, 0, 1)
            expert_in = recv.reshape(exp_local, ep, capacity, d).sum(1)
            flat_e = all_gather(flat_e_r, group)
            pos_flat = all_gather(pos_r, group)
            top_p = all_gather_tp(top_p_r, group)  # [T, k]
            kept = pos_flat < capacity
            local_slot = torch.where(kept & (flat_e // exp_local == r),
                                     (flat_e - r * exp_local) * capacity + pos_flat,
                                     exp_local * capacity)
        else:
            tokens = copy_to_tp(tokens, group)  # the fallback's uses differ by rank
            top_p, flat_e, pos_flat, _ = route(tokens)
            flat_tok = arange(t * k) // k
            kept = pos_flat < capacity
            slot_flat = torch.where(kept, flat_e * capacity + pos_flat, n_slots)
            if ep > 1:
                local_slot = torch.where(kept & (flat_e // exp_local == r),
                                         (flat_e - r * exp_local) * capacity + pos_flat,
                                         exp_local * capacity)
                expert_in = scatter_tokens(local_slot, flat_tok, tokens,
                                           exp_local * capacity).reshape(exp_local, capacity, d)
            else:
                expert_in = scatter_tokens(slot_flat, flat_tok, tokens,
                                           n_slots).reshape(n_exp, capacity, d)

        hmid = F.gelu(torch.bmm(expert_in, moe["w_in"]) + moe["b_in"][:, None, :],
                      approximate="tanh")
        expert_out = torch.bmm(hmid, moe["w_out"]) + moe["b_out"][:, None, :]

        def combine_from(buf_flat, slot):
            """[T, d]: each token's k assignment outputs from the flat buffer
            (+ a dummy zero row), weighted by ``top_p``."""
            buf = torch.cat([buf_flat, buf_flat.new_zeros(1, d)])
            return torch.einsum("tkd,tk->td", buf[slot].reshape(t, k, d), top_p)

        if use_a2a:
            partial_out = combine_from(expert_out.reshape(exp_local * capacity, d), local_slot)
            # each token slice's partials to the rank that routed it
            recv = all_to_all(partial_out.reshape(ep, t_local, d), group, 0, 0)
            out = gather_from_tp(recv.sum(0), group)
        elif ep > 1:
            out = reduce_from_tp(
                combine_from(expert_out.reshape(exp_local * capacity, d), local_slot), group)
        else:
            out = combine_from(expert_out.reshape(n_slots, d), slot_flat)
        return out.reshape(b, s, d)

    def _norm1(self, layer, h):
        return _layer_norm(h, layer["ln_1"]["scale"], layer["ln_1"]["bias"])

    def _final_norm(self, h):
        return _layer_norm(h, self.ln_f["scale"], self.ln_f["bias"])

    def _unembed_matrix(self) -> torch.Tensor:
        """[vocab, d] unembedding: tied to ``wte`` here (Llama: ``lm_head``)."""
        return self.wte

    def _unembed(self, h):
        """Logits of ``h``: the rank's vocab shard under tp."""
        return self._tp_in(h) @ self._unembed_matrix().T

    def _unembed_full(self, h):
        """FULL-vocab logits of ``h`` [..., d], the serving read: under tp
        the rank's [..., vocab/tp] shard all-gathered along the vocabulary
        (``parallel.tp.all_gather_tp``), so every rank holds the same row
        to sample from."""
        return all_gather_tp(self._unembed(h), self.tp_group, dim=-1)

    def _rotary(self, positions, length):
        """What :meth:`_serving_qkv` needs of the token positions, computed
        once for every layer: ``positions`` is an int start (the positions
        are start .. start+length-1) or a tensor of them ([s] shared or
        [b, s] per row). Nothing here (GPT-2's positions live in ``wpe``);
        Llama builds its RoPE tables."""
        return None

    def _serving_qkv(self, layer, x, rot):
        """(q, k, v) of ``x``, [b, H, s, hd]; K/V as the cache stores them.
        ``rot`` is :meth:`_rotary`'s (unused here)."""
        return self._qkv_heads(layer, x)

    def _attn_kv(self, k, v):
        """The cache's K/V as the shared attention takes them (Llama
        repeats its kv heads to the query heads)."""
        return k, v

    def _add_attn_out(self, layer, h, attn_out):
        """The attention residual of the serving surfaces: ``h + out + bo``."""
        return h + attn_out + layer["attn"]["bo"]

    def _attend(self, attn_impl: str, sp_group=None):
        """The attention function ``attend(q, k, v, causal=True)`` for
        ``attn_impl``, routed as the JAX ``_route_attention`` routes it. A
        sequence group of one counts as none. On a sharded sequence
        (``sp_group`` of more than one rank: the ``sp`` or the ``cp`` axis)
        only a ring or Ulysses sees the whole context: ``"ring2"`` is the
        bidirectional flash ring (``ops/ring_attention.py``), ``"ulysses"``
        and ``"ulysses_flash"`` the all-to-all re-shard (plain or flash
        attention inside), ``"ring_flash"`` the flash ring of
        ``ops.flash.ring_flash_attention``, and every other impl the XLA
        ring (``ops.attention.ring_attention``: ``"flash"`` alone would be
        block-diagonal attention). Without one the flash variants are
        single-device flash, the rest plain attention. An unknown impl
        raises."""
        if attn_impl not in self._ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; choose from {self._ATTN_IMPLS}")
        if sp_group is not None and sp_group.size == 1:
            sp_group = None
        if sp_group is not None:
            seq_fn = {"ring2": ring_attention, "ring_flash": ring_flash_attention,
                      "ulysses": ulysses_attention,
                      "ulysses_flash": functools.partial(ulysses_attention, flash=True),
                      }.get(attn_impl, xla_ring_attention)
            return lambda q, k, v, causal=True: seq_fn(q, k, v, sp_group, causal)
        if attn_impl in ("flash", "ring_flash", "ulysses_flash", "ring2"):
            return flash_attention
        return attention

    def _block(self, layer, h, attend, rot=None):
        """One pre-LN block: attention residual, then the FFN residual (the
        only checkpointed part under ``remat="mlp"``, which keeps the
        attention activations, flash's saved residuals among them).
        ``rot`` (:meth:`_rotary`) is unused here; Llama rotates q/k by it."""
        q, k, v = self._qkv_heads(layer, self._tp_in(self._norm1(layer, h)))
        out = qmatmul(self._merge_heads(attend(q, k, v, causal=True)), layer["attn"]["wo"])
        h = h + (self._tp_out(out) + layer["attn"]["bo"])
        if self.config.remat == "mlp" and torch.is_grad_enabled():
            return checkpoint(self._ffn, layer, h, use_reentrant=False)
        return self._ffn(layer, h)

    def _blocks(self, tokens: torch.Tensor, attn_impl: str, sp_group=None) -> torch.Tensor:
        """Embedding and the block stack → pre-final-norm hidden states
        [b, s, d]; ``remat=True`` recomputes each block in the backward,
        ``remat="int8"`` recomputes it from its input stashed as int8. With
        ``sp_group``, ``tokens`` is this rank's contiguous shard of the
        sequence and positions start at its origin."""
        if self.layer_ids != list(range(self.config.n_layer)):
            raise ValueError(f"this model holds the pipeline stage {self.layer_ids}: its blocks "
                             "run through parallel.pp's schedules")
        attend = self._attend(attn_impl, sp_group)
        offset = 0 if sp_group is None else sp_group.rank * tokens.shape[1]
        h = self._embed(tokens, offset)
        rot = self._rotary(offset, tokens.shape[1])
        remat = self.config.remat if torch.is_grad_enabled() else False
        if remat == "int8":
            block = compressed_checkpoint(lambda layer, x: self._block(layer, x, attend, rot))
        for layer in self.layers:
            if remat is True:
                h = checkpoint(self._block, layer, h, attend, rot, use_reentrant=False)
            elif remat == "int8":
                h = block(layer, h)
            else:
                h = self._block(layer, h, attend, rot)
        return h

    def apply(self, tokens: torch.Tensor, attn_impl: str = "xla", sp_group=None) -> torch.Tensor:
        """Logits [b, s, vocab] of ``tokens`` [b, s] (causal). ``attn_impl``
        is one of :attr:`_ATTN_IMPLS`, routed by :meth:`_attend`: ``"xla"``
        plain attention, ``"flash"`` the flash kernels; with ``sp_group``
        (whose rank holds ``tokens`` as its shard of the sequence) a
        sequence-parallel attention over it. Under tp
        the logits are this rank's vocab shard [b, s, vocab/tp], as the JAX
        ``apply_spmd`` returns them."""
        return self._unembed(self._final_norm(self._blocks(tokens, attn_impl, sp_group)))

    forward = apply

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             attn_impl: str = "xla", sp_group=None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` [b, s] against
        ``targets`` [b, s] (the single-shard head of the JAX
        ``_head_loss_spmd``), attention routed by :meth:`_attend`: the
        chunked loss of ``ops/xent.py`` when ``vocab_size > xent_chunk >
        0``, else dense logits in the model's type, cast to f32, then
        log-softmax. With ``sp_group`` (the JAX ``loss_spmd`` with
        ``sp_axis``) both are this rank's shard of the sequence and the loss
        is the mean over this rank's rows. Under tp the
        head is the vocab-parallel cross-entropy (:meth:`head_loss`)."""
        return self.head_loss(self._blocks(tokens, attn_impl, sp_group), targets)

    def head_loss(self, h_raw: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Final norm, unembedding and mean cross-entropy of PRE-final-norm
        hidden states (the JAX ``_head_loss_spmd``, the head the pipeline's
        last stage runs): at tp > 1 the dense vocab-parallel loss in f32
        (``parallel.tp.vocab_parallel_xent``); else the chunked loss of
        ``ops/xent.py`` when ``vocab_size > xent_chunk > 0``, or dense logits
        in the model's type, cast to f32, then log-softmax."""
        cfg = self.config
        h = self._final_norm(h_raw)
        if self.tp > 1:
            return vocab_parallel_xent(self._unembed(h).float(), targets, self.tp_group)
        if cfg.xent_chunk and cfg.vocab_size > cfg.xent_chunk:
            return chunked_softmax_xent(h, self._unembed_matrix(), targets, cfg.xent_chunk)
        logp = torch.log_softmax(self._unembed(h).float(), dim=-1)
        return -logp.gather(-1, targets.long()[..., None]).mean()

    # ---- autoregressive decoding (KV cache) -----------------------------------
    # The cache is allocated at max_seq and updated IN PLACE: the JAX package
    # returns a new cache and donates the old buffers to XLA; here a new
    # cache per step would be a copy.

    @property
    def _n_cache_heads(self) -> int:
        """Heads of a KV cache entry and a page: every head here (Llama: its
        kv heads)."""
        return self.config.n_head

    def init_cache(self, batch: int) -> list[dict[str, torch.Tensor]]:
        """KV cache, one entry per layer, allocated at max_seq, with
        :attr:`_n_cache_heads` heads (this rank's ``1/tp`` of them on a tp
        shard). With ``config.kv_quant`` the entries
        are int8 (or int4 packed in uint8) rows plus one f32 scale per row
        (:meth:`_cache_write`)."""
        self._check_servable("a KV cache")
        return [self._cache_entry(batch) for _ in range(self.config.n_layer)]

    def _kv_mode(self) -> str | None:
        """None | "int8" | "int4" — ``config.kv_quant`` normalised (True
        is "int8"); an unknown mode raises."""
        kq = self.config.kv_quant
        if not kq:
            return None
        if kq is True or kq == "int8":
            return "int8"
        if kq == "int4":
            return "int4"
        raise ValueError(f"unknown kv_quant mode {kq!r}; choose False, True/'int8', or 'int4'")

    def _cache_entry(self, batch: int) -> dict[str, torch.Tensor]:
        cfg = self.config
        hd, heads = cfg.d_model // cfg.n_head, self._n_cache_heads // self.tp
        mode = self._kv_mode()

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if mode:
            if mode == "int4":
                if hd % 2:
                    raise ValueError(f"kv_quant='int4' needs an even head_dim, got {hd}")
                shape, dt = (batch, heads, cfg.max_seq, hd // 2), torch.uint8  # 2 nibbles/byte
            else:
                shape, dt = (batch, heads, cfg.max_seq, hd), torch.int8
            return {"k": zeros(shape, dt), "k_s": zeros((*shape[:3], 1), torch.float32),
                    "v": zeros(shape, dt), "v_s": zeros((*shape[:3], 1), torch.float32)}
        shape = (batch, heads, cfg.max_seq, hd)
        return {"k": zeros(shape, cfg.torch_dtype), "v": zeros(shape, cfg.torch_dtype)}

    def _kv_quantize(self, x, mode: str | None = None):
        """[b, h, s, hd] → (values, f32 scales [b, h, s, 1]) through the one
        KV codec (``ops/quantization.py::quantize_kv_rows``), so the dense
        cache and the page pool hold the same bytes per row."""
        return quantize_kv_rows(x, mode or self._kv_mode())

    def _cache_write(self, c: dict, kc, vc, write) -> None:
        """Write new K/V rows [b, h, s, hd] into the cache entry ``c`` in
        place through ``write(cache_array, new_rows)``, the caller's
        placement; quantized caches write values and scales alike."""
        if self._kv_mode():
            kq, ks = self._kv_quantize(kc)
            vq, vs = self._kv_quantize(vc)
            for key, new in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
                write(c[key], new)
        else:
            write(c["k"], kc)
            write(c["v"], vc)

    def _cache_attn_inputs(self, c: dict):
        """(ck, cv, k_s, v_s) for :meth:`_decode_attention`; the scales are
        None for the plain cache. int8 values go into the products as they
        are (int4 unpacked to int8 first) and the per-row scales fold in
        after each product."""
        mode = self._kv_mode()
        if mode == "int4":
            return unpack_int4(c["k"]), unpack_int4(c["v"]), c["k_s"], c["v_s"]
        if mode:
            return c["k"], c["v"], c["k_s"], c["v_s"]
        return c["k"], c["v"], None, None

    @staticmethod
    def _valid_to_mask(valid):
        """``valid`` [S] (shared depth), [b, S] (per-slot depth) or [b, q, S]
        (a window or chunk) → a mask broadcastable to [b, H, q, S]."""
        if valid.ndim == 1:
            return valid[None, None, None, :]
        if valid.ndim == 2:
            return valid[:, None, None, :]
        return valid[:, None, :, :]

    def _decode_attention(self, q, ck, cv, valid, k_s=None, v_s=None):
        """q [b, H, q, hd] against the whole cache [b, H, S, hd] under the
        ``valid`` mask (:meth:`_valid_to_mask`). With ``k_s``/``v_s`` [b, H,
        S, 1] (a quantized cache) the products run in f32, the key scales
        multiply the scores and the value scales the probabilities."""
        vmask = self._valid_to_mask(valid)
        if k_s is None:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, ck) * (q.shape[-1] ** -0.5)
            scores = scores.masked_fill(~vmask, _NEG_INF)
            return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), cv)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), ck.float()) * (q.shape[-1] ** -0.5)
        scores = scores * k_s.transpose(-1, -2)
        scores = scores.masked_fill(~vmask, _NEG_INF)
        probs = torch.softmax(scores, dim=-1) * v_s.transpose(-1, -2)
        return torch.einsum("bhqk,bhkd->bhqd", probs, cv.float()).to(q.dtype)

    def _prefill_use_flash(self, t: int) -> bool:
        """Gate for the flash-kernel prefill: the prompt's q lies where the
        weights do, so this is ``q.is_cuda and t >= 512``. Separable so the
        CPU tests can force the branch on (the kernel's plain version then
        runs)."""
        return self.wte.is_cuda and t >= 512

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, last_index: int | None = None):
        """Run the prompt [batch, T] in one pass, filling a new cache.
        Returns (logits [batch, vocab] at position ``last_index``, default
        T-1, cache). A quantized cache stores the quantized rows; the pass
        itself attends to the exact ones."""
        b, t = tokens.shape
        h = self._embed(tokens)
        rot = self._rotary(0, t)
        cache = self.init_cache(b)
        attend = flash_attention if self._prefill_use_flash(t) else attention
        for layer, c in zip(self.layers, cache):
            q, kc, vc = self._serving_qkv(layer, self._norm1(layer, h), rot)
            attn_out = qmatmul(self._merge_heads(attend(q, *self._attn_kv(kc, vc), causal=True)),
                               layer["attn"]["wo"])
            h = self._add_attn_out(layer, h, self._tp_out(attn_out))
            h = self._ffn(layer, h)
            self._cache_write(c, kc, vc, lambda arr, new: arr[:, :, :t].copy_(new))
        h = self._final_norm(h)
        h_last = h[:, -1] if last_index is None else h[:, last_index]
        return self._unembed_full(h_last), cache

    def _read_logits(self, h, read_index):
        """Final norm and unembedding of ``h`` [b, C, d] at ``read_index``:
        None reads row 0 (a decode step's one query), "all" every row, an
        int that chunk-local row."""
        h = self._final_norm(h)
        if isinstance(read_index, str) and read_index == "all":
            return self._unembed_full(h)
        return self._unembed_full(h[:, 0 if read_index is None else int(read_index)])

    def _decode_core(self, cache, h, positions, valid, write, read_index=None):
        """The decode layer loop for the tokens ``h`` [b, C, d] at
        ``positions`` (an int start, [C] or [b, C]): norm → qkv → cache write through the
        caller's ``write`` placement (in place) → attention over the cache
        under ``valid`` → wo → ffn; then the logits at ``read_index``
        (:meth:`_read_logits`). ``decode_step``, ``decode_step_slots``,
        ``prefill_chunk`` and ``verify_step`` differ only in positions,
        valid, write and read_index."""
        rot = self._rotary(positions, h.shape[1])
        for layer, c in zip(self.layers, cache):
            q, kc, vc = self._serving_qkv(layer, self._norm1(layer, h), rot)
            self._cache_write(c, kc, vc, write)
            ck, cv, k_s, v_s = self._cache_attn_inputs(c)
            out = self._decode_attention(q, ck, cv, valid, k_s, v_s)
            attn_out = qmatmul(self._merge_heads(out), layer["attn"]["wo"])
            h = self._add_attn_out(layer, h, self._tp_out(attn_out))
            h = self._ffn(layer, h)
        return self._read_logits(h, read_index), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens`` [batch] at position ``pos``. Returns
        (logits [batch, vocab], the cache, updated in place)."""
        pos = int(pos)
        valid = torch.arange(self.config.max_seq, device=self.device) <= pos
        return self._decode_core(
            cache, self._embed(tokens[:, None], offset=pos), pos, valid,
            lambda arr, new: arr[:, :, pos:pos + 1].copy_(new),
        )

    @torch.no_grad()
    def decode_step_slots(self, cache, tokens: torch.Tensor, pos):
        """One decode step with PER-SLOT positions, the continuous batcher's
        step: ``tokens`` [b] are each slot's last token, ``pos`` [b] each
        slot's own depth. The new rows scatter to ``(b, :, pos[b])`` in
        place and row b attends to positions ``<= pos[b]``. Returns (logits
        [b, vocab], the cache)."""
        pos = torch.as_tensor(pos, device=self.device).long()
        bidx = torch.arange(tokens.shape[0], device=self.device)
        valid = torch.arange(self.config.max_seq, device=self.device)[None, :] <= pos[:, None]

        def write(arr, new):  # arr [b, H, S, x], new [b, H, 1, x]
            arr[bidx, :, pos] = new[:, :, 0]

        return self._decode_core(cache, self._embed(tokens[:, None], offset=pos[:, None]),
                                 pos[:, None], valid, write)

    @torch.no_grad()
    def verify_step(self, cache, tokens: torch.Tensor, start):
        """Multi-query decode for speculative verification: ``tokens`` [b, C]
        at per-row positions ``start[b] .. start[b]+C-1``, written into the
        cache and read back with a causal mask; returns (logits [b, C,
        vocab] at every position, the cache). Rejected drafts leave rows
        that the next window overwrites before any query reads them."""
        c = tokens.shape[1]
        start = torch.as_tensor(start, device=self.device).long()
        positions = start[:, None] + torch.arange(c, device=self.device)  # [b, C]
        valid = torch.arange(self.config.max_seq, device=self.device)[None, None, :] \
            <= positions[:, :, None]
        bidx = torch.arange(tokens.shape[0], device=self.device)[:, None]

        def write(arr, new):  # arr [b, H, S, x], new [b, H, C, x]
            arr[bidx, :, positions] = new.transpose(1, 2)

        return self._decode_core(cache, self._embed(tokens, offset=start[:, None]), positions,
                                 valid, write, read_index="all")

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens: torch.Tensor, start: int, last_index: int | None = None):
        """One CHUNK of a chunked prefill: ``tokens`` [b, C] at global
        positions ``start .. start+C-1`` against a cache whose rows below
        ``start`` are filled; writes the chunk's rows in place and returns
        (logits [b, vocab] at chunk-local ``last_index``, default C-1, the
        cache). ``start + C`` must not exceed max_seq (the caller pads the
        last chunk; pad rows land beyond the prompt, where no query looks
        before they are overwritten). With ``kv_quant`` the chunk reads the
        quantized rows of earlier chunks, where a whole-prompt prefill
        attends exactly."""
        c = tokens.shape[1]
        start = int(start)
        positions = start + torch.arange(c, device=self.device)  # [C]
        valid = torch.arange(self.config.max_seq, device=self.device)[None, None, :] \
            <= positions[None, :, None]  # [1, C, S]
        return self._decode_core(
            cache, self._embed(tokens, offset=start), positions, valid,
            lambda arr, new: arr[:, :, start:start + c].copy_(new),
            read_index=c - 1 if last_index is None else last_index,
        )

    # ---- paged KV cache (the serving page pool) --------------------------------
    # A pool of fixed-size token pages shared by every slot through a page
    # table: the same layer loop and sampling as the dense surfaces above,
    # only the cache placement (a scatter at (physical page, row)) and the
    # attention read differ, so paged tokens equal the dense cache's at the
    # same codec. The pool is updated in place, like the dense cache.

    @staticmethod
    def _page_mode(quant) -> str | None:
        """None | "int8" | "int4" — the page pool's codec (True is "int4")."""
        if not quant:
            return None
        if quant is True or quant == "int4":
            return "int4"
        if quant == "int8":
            return "int8"
        raise ValueError(f"unknown page quant mode {quant!r}; choose False, 'int8', or True/'int4'")

    def init_page_pool(self, n_pages: int, page_size: int, quant="int4") -> list:
        """Per-layer page pool: ``n_pages`` physical pages of ``page_size``
        token rows, ``k``/``v`` [n_pages, H, page_size, hd (hd/2 for int4)]
        plus f32 ``k_s``/``v_s`` [n_pages, H, page_size, 1] when quantized,
        H = :attr:`_n_cache_heads` (``1/tp`` of them on a tp shard: the page
        and row axes, and so the page table, are the same on every rank).
        ``page_size`` must divide max_seq, so a slot's table has
        ``max_seq // page_size`` entries. Page 0 is the SCRATCH page: dead
        slots and unallocated entries name it, so their masked writes land
        nowhere that is read."""
        self._check_servable("a page pool")
        cfg = self.config
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(f"page_size must divide max_seq={cfg.max_seq}, got {page_size}")
        if n_pages < 2:
            raise ValueError(f"need n_pages >= 2 (page 0 is the scratch page), got {n_pages}")
        mode = self._page_mode(quant)
        hd, n_heads = cfg.d_model // cfg.n_head, self._n_cache_heads // self.tp
        if mode == "int4":
            if hd % 2:
                raise ValueError(f"int4 pages need an even head_dim, got {hd}")
            shape, dt = (n_pages, n_heads, page_size, hd // 2), torch.uint8
        elif mode == "int8":
            shape, dt = (n_pages, n_heads, page_size, hd), torch.int8
        else:
            shape, dt = (n_pages, n_heads, page_size, hd), cfg.torch_dtype

        def entry():
            e = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
            if mode:
                sshape = (n_pages, n_heads, page_size, 1)
                e["k_s"] = torch.zeros(sshape, dtype=torch.float32, device=self.device)
                e["v_s"] = torch.zeros(sshape, dtype=torch.float32, device=self.device)
            return e

        return [entry() for _ in range(cfg.n_layer)]

    def _paged_write(self, c: dict, kc, vc, write, mode) -> None:
        """:meth:`_cache_write` for a pool entry: quantize the new rows with
        the pool's codec and place values and scales through ``write``."""
        if mode:
            kq, ks = self._kv_quantize(kc, mode)
            vq, vs = self._kv_quantize(vc, mode)
            for key, new in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
                write(c[key], new)
        else:
            write(c["k"], kc)
            write(c["v"], vc)

    def _paged_attn_inputs(self, c: dict, page_table, mode):
        """The gather path: one layer's pool through ``page_table`` [b, n_pt]
        into the dense view [b, H, n_pt·page_size, ·] that
        :meth:`_decode_attention` reads as it reads the dense cache — the
        oracle of the kernels. Unallocated entries read scratch page 0,
        which the mask never admits."""
        table = page_table.long()

        def g(arr):
            t = arr[table]  # [b, n_pt, H, page, x]
            b, npt, h, pg, x = t.shape
            return t.permute(0, 2, 1, 3, 4).reshape(b, h, npt * pg, x)

        if mode == "int4":
            return unpack_int4(g(c["k"])), unpack_int4(g(c["v"])), g(c["k_s"]), g(c["v_s"])
        if mode:
            return g(c["k"]), g(c["v"]), g(c["k_s"]), g(c["v_s"])
        return g(c["k"]), g(c["v"]), None, None

    def _decode_core_paged(self, pool, page_table, h, positions, valid, write, mode,
                           read_index=None):
        """:meth:`_decode_core` against a page pool: per layer, norm → qkv
        → quantized page write (the caller's scatter, in place) → paged
        attention → wo → ffn. The read takes the kernel
        (:func:`paged_attention`) when ``paged_attn_impl`` says "pallas"
        (the default on the card) and the gather path when it says "xla";
        ``positions`` broadcast to [b, C] are the kernel's whole mask."""
        use_kernel = paged_attn_impl(h.device) == "pallas"
        b_q, c_q = h.shape[:2]
        posq = torch.broadcast_to(torch.atleast_2d(positions).to(torch.int32), (b_q, c_q))
        rot = self._rotary(positions, h.shape[1])
        for layer, c in zip(self.layers, pool):
            q, kc, vc = self._serving_qkv(layer, self._norm1(layer, h), rot)
            self._paged_write(c, kc, vc, write, mode)
            if use_kernel:
                out = paged_attention(q, c, page_table, posq, mode)
            else:
                ck, cv, k_s, v_s = self._paged_attn_inputs(c, page_table, mode)
                out = self._decode_attention(q, ck, cv, valid, k_s, v_s)
            attn_out = qmatmul(self._merge_heads(out), layer["attn"]["wo"])
            h = self._add_attn_out(layer, h, self._tp_out(attn_out))
            h = self._ffn(layer, h)
        return self._read_logits(h, read_index), pool

    def _page_size_of(self, page_table) -> int:
        return self.config.max_seq // page_table.shape[1]

    @torch.no_grad()
    def decode_step_slots_paged(self, pool, page_table, tokens: torch.Tensor, pos, quant="int4"):
        """:meth:`decode_step_slots` against a page pool: ``page_table``
        [b, max_seq/page_size] names each slot's physical pages; the new
        row scatters to (table[b, pos[b] // page], pos[b] % page). Returns
        (logits [b, vocab], the pool, updated in place)."""
        mode = self._page_mode(quant)
        page_size = self._page_size_of(page_table)
        pos = torch.as_tensor(pos, device=self.device).long()
        bidx = torch.arange(tokens.shape[0], device=self.device)
        valid = torch.arange(self.config.max_seq, device=self.device)[None, :] <= pos[:, None]
        phys = page_table[bidx, pos // page_size].long()
        row = pos % page_size

        def write(arr, new):  # arr [P, H, page, x], new [b, H, 1, x]
            arr[phys, :, row] = new[:, :, 0]

        return self._decode_core_paged(pool, page_table,
                                       self._embed(tokens[:, None], offset=pos[:, None]),
                                       pos[:, None], valid, write, mode)

    @torch.no_grad()
    def prefill_chunk_paged(self, pool, page_table, tokens: torch.Tensor, start: int,
                            last_index: int | None = None, quant="int4"):
        """:meth:`prefill_chunk` against a page pool: ``tokens`` [1, C] at
        positions ``start .. start+C-1`` scatter into the pages of the
        one-row ``page_table`` [1, n_pt]. With a quantized pool every query
        reads every key quantized, so chunk chaining gives the same bytes
        for any chunk size."""
        mode = self._page_mode(quant)
        page_size = self._page_size_of(page_table)
        c = tokens.shape[1]
        start = int(start)
        positions = start + torch.arange(c, device=self.device)  # [C]
        valid = torch.arange(self.config.max_seq, device=self.device)[None, None, :] \
            <= positions[None, :, None]  # [1, C, S]
        phys = page_table[0, positions // page_size].long()
        row = positions % page_size

        def write(arr, new):  # arr [P, H, page, x], new [1, H, C, x]
            arr[phys, :, row] = new[0].transpose(0, 1)

        return self._decode_core_paged(
            pool, page_table, self._embed(tokens, offset=start), positions, valid, write, mode,
            read_index=c - 1 if last_index is None else last_index,
        )

    @torch.no_grad()
    def verify_step_paged(self, pool, page_table, tokens: torch.Tensor, start, quant="int4"):
        """:meth:`verify_step` against a page pool: the window [b, C]
        written and read through each slot's page table; rejected drafts
        leave rows in the slot's own private pages, which the next window
        overwrites first."""
        mode = self._page_mode(quant)
        page_size = self._page_size_of(page_table)
        b, c = tokens.shape
        start = torch.as_tensor(start, device=self.device).long()
        positions = start[:, None] + torch.arange(c, device=self.device)  # [b, C]
        valid = torch.arange(self.config.max_seq, device=self.device)[None, None, :] \
            <= positions[:, :, None]
        phys = page_table[torch.arange(b, device=self.device)[:, None],
                          positions // page_size].long()
        row = positions % page_size

        def write(arr, new):  # arr [P, H, page, x], new [b, H, C, x]
            arr[phys, :, row] = new.transpose(1, 2)

        return self._decode_core_paged(pool, page_table,
                                       self._embed(tokens, offset=start[:, None]), positions,
                                       valid, write, mode, read_index="all")

    def _check_generate_args(self, t, max_new_tokens, temperature, top_k, top_p):
        cfg = self.config
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if t + max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds max_seq={cfg.max_seq}"
            )
        if top_k < 0 or top_k > cfg.vocab_size:
            raise ValueError(f"top_k must be in [0, vocab_size={cfg.vocab_size}], got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")

    @torch.no_grad()
    def generate(
        self,
        prompt,  # [batch, T] integer ids (tensor or numpy)
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        eos_id: int | None = None,
    ) -> torch.Tensor:
        """Sample ``max_new_tokens`` continuations → [batch, max_new_tokens]
        int64. ``temperature == 0`` is greedy; otherwise softmax sampling,
        optionally truncated by ``top_k``/``top_p``, with noise from a
        ``torch.Generator`` seeded with ``seed``. With ``eos_id`` a row that
        emits it keeps emitting ``eos_id`` for its remaining positions."""
        prompt = torch.as_tensor(prompt, device=self.device).long()
        self._check_generate_args(prompt.shape[1], max_new_tokens, temperature, top_k, top_p)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return self._generate_loop(
            prompt, max_new_tokens,
            lambda logits, i: sample_token_logits(logits, gen, temperature, top_k, top_p), eos_id)

    def _generate_loop(self, prompt: torch.Tensor, max_new_tokens: int, sample,
                       eos_id: int | None) -> torch.Tensor:
        """One prefill, then the decode loop; ``sample(logits, i)`` picks the
        tokens of step ``i`` (0 = from the prefill's logits)."""
        t = prompt.shape[1]
        logits, cache = self.prefill(prompt)
        tok = sample(logits, 0)
        done = tok == eos_id if eos_id is not None else None
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.decode_step(cache, tok, t + i)
            tok = sample(logits, i + 1)
            if done is not None:
                # rows past their EOS keep emitting eos_id
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def generate_spmd(
        self,
        prompt,  # [batch, T] integer ids (tensor or numpy), the same on every rank
        max_new_tokens: int,
        mesh,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        dp_shard: bool = False,
        eos_id: int | None = None,
    ) -> torch.Tensor:
        """Tensor-parallel serving, the JAX ``generate_spmd``: this model is
        the rank's shard of ``mesh``'s ``tp`` group (built with
        ``tp_group=mesh.group("tp")``), every rank calls it with the same
        arguments, and the prefill and decode run head-parallel with the
        rank's cache shard. Every rank rebuilds the whole logits row
        (:meth:`_unembed_full`) and samples it with the same noise, so the
        tokens equal :meth:`generate`'s on one device (greedy, and sampled
        from the same ``torch.Generator`` draws). Returns [batch,
        max_new_tokens] int64 on every rank.

        ``dp_shard=True`` also splits the batch over the mesh's ``dp``
        axis: each dp group decodes its own rows and the rows are gathered
        back over ``dp``. The sampler noise then comes from (seed, global
        row, step) (``utils.hash32.request_uniform``), so a dp = N run
        equals a dp = 1 one with ``dp_shard`` and a row's tokens do not
        depend on the split; greedy tokens equal :meth:`generate`'s. Other
        mesh axes replicate."""
        prompt = torch.as_tensor(prompt, device=self.device).long()
        b, t = prompt.shape
        self._check_generate_args(t, max_new_tokens, temperature, top_k, top_p)
        tp = mesh.shape.get("tp", 1)
        if self.config.n_head % tp:
            raise ValueError(f"n_head={self.config.n_head} not divisible by tp={tp}")
        if self.tp != tp or self.tp_group is not mesh.group("tp"):
            raise ValueError(f"generate_spmd runs on this rank's shard of the mesh's tp = {tp} "
                             "group: build the model with tp_group=mesh.group('tp')")
        dp = mesh.shape.get("dp", 1) if dp_shard else 1
        if dp_shard and b % dp:
            raise ValueError(f"batch {b} not divisible by dp={dp} for dp_shard")
        if not dp_shard:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            return self._generate_loop(
                prompt, max_new_tokens,
                lambda logits, i: sample_token_logits(logits, gen, temperature, top_k, top_p),
                eos_id)
        rows = b // dp
        row0 = mesh.coord("dp") * rows
        keys = torch.tensor([request_key(int(seed), row0 + r) for r in range(rows)],
                            device=self.device)

        def sample(logits, i):
            if temperature <= 0.0:
                return logits.argmax(-1)
            noise = request_uniform(keys, torch.full_like(keys, i), logits.shape[-1])
            return sample_token_logits(logits, None, temperature, top_k, top_p, uniform=noise)

        out = self._generate_loop(prompt[row0:row0 + rows], max_new_tokens, sample, eos_id)
        return out if dp == 1 else all_gather(out, mesh.group("dp"))
