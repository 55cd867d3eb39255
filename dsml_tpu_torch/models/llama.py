"""Llama in PyTorch — the counterpart of ``dsml_tpu/models/llama.py``.

:class:`Llama` subclasses the port's :class:`~dsml_tpu_torch.models.gpt2.GPT2`
and overrides only the architecture, as the JAX ``Llama`` overrides the JAX
``GPT2``; training (``loss``, ``remat``), ``generate`` and every serving
surface of the continuous batcher (dense and paged) are inherited:

- **RMSNorm** instead of LayerNorm (no mean-centering, no bias);
- **RoPE** rotary position embeddings on q/k (rotate-half), no position
  table: every surface turns its token positions (shared ``[s]``, or
  ``[b, s]`` per slot in the continuous batcher) into cos/sin tables once
  (:meth:`Llama._rotary`), which every layer's q/k rotate by;
- **SwiGLU** MLP: ``silu(x·w_gate) ⊙ (x·w_up) · w_down``;
- **GQA**: ``n_kv_head ≤ n_head`` K/V heads. Training and prefill repeat
  them to the query heads (``repeat_interleave`` on the head axis, as
  ``jnp.repeat``) for the shared attention (plain or the flash kernels);
  the KV cache and the page pool hold only the kv heads, and the cached
  attention groups the query heads over their kv head without a repeat
  (:meth:`Llama._decode_attention`); the paged kernels read GQA pools as
  they are;
- an **untied unembedding** ``lm_head``, which the dense and the chunked
  loss both stream (:meth:`Llama._unembed_matrix`).

Weights keep the JAX tree's names and layouts (``state_dict`` keys such as
``lm_head``, ``rms_f.scale``, ``layers.0.attn.wq``, ``layers.0.mlp.w_gate``),
so ``models.convert.params_from_jax`` carries JAX weights over unchanged, and
:meth:`Llama.init` draws the JAX init's ``np.random.default_rng(seed)``
sequence. Under a sequence group (the ``sp`` or ``cp`` axis) each rank
rotates its shard's q/k at their GLOBAL positions (``rank · s_local``
onward, :meth:`GPT2._blocks`' offset, as the JAX ``Llama._block``) and the
repeated K/V go through the routed sequence-parallel attention; Ulysses
then needs the ``n_head/tp`` query heads to divide by the group's size.

Mixtral (``n_experts > 0``, :meth:`LlamaConfig.mixtral_8x7b`): the SwiGLU
MLP becomes the inherited expert layer (``GPT2._moe_block``), with the JAX
package's choices kept: GELU (tanh) experts with biases, the layer's
``moe`` draws in the MLP's slot of the init, experts sharded over tp, and
``remat="mlp"`` checkpointing the expert FFN.

Tensor and pipeline parallelism as in ``models/gpt2.py`` (``tp_group``,
``layer_ids``), with the JAX ``Llama.param_specs``: column-parallel
``wq``/``wk``/``wv``/``w_gate``/``w_up``, row-parallel ``wo``/``w_down``,
vocab-sharded ``wte`` and ``lm_head``, and ``n_kv_head/tp`` local kv heads
repeated inside the rank to its ``n_head/tp`` query heads. Served on a tp
shard (``GPT2.generate_spmd``, the batcher's ``mesh``), the cache and the
page pool hold the rank's ``n_kv_head/tp`` kv heads in every codec, RoPE
rotates the local heads as it rotates all of them, and the untied
``lm_head``'s vocab shards are all-gathered into the logits row.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dsml_tpu_torch.models.common import fsdp_spec_fn, qmatmul
from dsml_tpu_torch.models.gpt2 import _DTYPES, GPT2
from dsml_tpu_torch.ops.attention import _NEG_INF
from dsml_tpu_torch.parallel.tp import vocab_parallel_embed
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["LlamaConfig", "Llama"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq: int = 2048
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 4  # GQA: kv heads grouped under query heads
    d_model: int = 2048
    d_ff: int = 5632  # SwiGLU hidden width
    dtype: str = "float32"
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # Mixtral-style expert layers: >0 replaces the SwiGLU MLP by the
    # inherited top-k expert layer (GPT2._moe_block: GELU experts)
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    remat: bool | str = False  # as GPT2Config.remat
    xent_chunk: int = 8192  # as GPT2Config.xent_chunk; the chunks stream lm_head
    pp_interleave: int = 1
    kv_quant: bool | str = False  # as GPT2Config.kv_quant, over the kv heads only

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from {sorted(_DTYPES)}")
        if self.remat not in (False, True, "int8", "mlp"):
            raise ValueError(
                f"unknown remat mode {self.remat!r}; choose False, True, 'int8', or 'mlp'")
        if self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_head={self.n_head} is not a multiple of n_kv_head={self.n_kv_head}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def tinyllama_1b() -> "LlamaConfig":
        """TinyLlama-1.1B shape (22×2048, GQA 32q/4kv)."""
        return LlamaConfig()

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig(
            n_layer=32, n_head=32, n_kv_head=32, d_model=4096, d_ff=11008, max_seq=4096
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, n_layer=32, n_head=32, n_kv_head=8, d_model=4096,
            d_ff=14336, max_seq=8192, rope_theta=500000.0,
        )

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        """Mixtral-8x7B shape: Llama-2-7B trunk, 8 experts, top-2 routing."""
        return LlamaConfig(
            n_layer=32, n_head=32, n_kv_head=8, d_model=4096, d_ff=14336,
            max_seq=4096, n_experts=8, expert_top_k=2,
        )

    @staticmethod
    def tiny(vocab_size: int = 512, n_experts: int = 0) -> "LlamaConfig":
        """Test-sized config exercising GQA (8q/2kv), RoPE, SwiGLU."""
        return LlamaConfig(
            vocab_size=vocab_size, max_seq=128, n_layer=2, n_head=8, n_kv_head=2,
            d_model=64, d_ff=128, n_experts=n_experts,
        )

    @classmethod
    def by_name(cls, name: str, **tiny_kwargs) -> "LlamaConfig":
        """Preset lookup; ``tiny_kwargs`` reach only the ``tiny`` preset."""
        presets = {
            "tiny": cls.tiny,
            "tinyllama_1b": cls.tinyllama_1b,
            "llama2_7b": cls.llama2_7b,
            "llama3_8b": cls.llama3_8b,
            "mixtral_8x7b": cls.mixtral_8x7b,
        }
        if name not in presets:
            raise ValueError(f"unknown Llama preset {name!r}; choose from {sorted(presets)}")
        return presets[name](**tiny_kwargs) if name == "tiny" else presets[name]()


def _rms_norm(x, scale, eps=1e-5):
    """Normalise in f32, cast back to ``x``'s type, then scale in the
    parameter type — the JAX order."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale


def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) f32 of the rotary angles at ``positions`` ([s] shared
    across the batch, or [b, s] per row), shaped to broadcast against
    [b, h, s, hd/2]."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                      * 2.0 / hd)
    angles = positions.to(torch.float32)[..., None] * freqs  # [(b,) s, half]
    # shared positions broadcast over batch and heads, per-row ones over heads
    lead = (None, None) if angles.ndim == 2 else (slice(None), None)
    return torch.cos(angles)[lead], torch.sin(angles)[lead]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half by the :func:`_rope_tables` angles, in f32, cast back to
    ``x``'s type."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention: ``x`` [b, h, s, hd] at
    ``positions`` [s] shared across the batch, or [b, s] per row (each slot
    of the continuous batcher at its own depth)."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


class Llama(GPT2):
    """Llama on the GPT-2 scaffolding (see the module docstring). Build it,
    then fill its weights with :meth:`init` (or ``load_state_dict``): the
    constructor allocates them uninitialised on ``device`` (``None`` = the
    CUDA card)."""

    def __init__(self, config: LlamaConfig | None = None, device=None, tp_group=None,
                 layer_ids=None):
        nn.Module.__init__(self)
        self.config = cfg = config or LlamaConfig.tinyllama_1b()
        self._kv_mode()  # a bad kv_quant string fails at construction
        self.device = resolve_device(device)
        self._set_parallel(tp_group, layer_ids)
        dt, d, tp = cfg.torch_dtype, cfg.d_model, self.tp
        kv_d = cfg.n_kv_head * (d // cfg.n_head)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=self.device))

        def norm():
            return nn.ParameterDict({"scale": param(d)})

        self.wte = param(cfg.vocab_size // tp, d)
        self.lm_head = param(cfg.vocab_size // tp, d)
        self.rms_f = norm()
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "rms_1": norm(),
                "rms_2": norm(),
                "attn": nn.ParameterDict({
                    "wq": param(d, d // tp), "wk": param(d, kv_d // tp),
                    "wv": param(d, kv_d // tp), "wo": param(d // tp, d),
                }),
                **({"moe": self._moe_params(param)} if cfg.n_experts else {
                    "mlp": nn.ParameterDict({
                        "w_gate": param(d, cfg.d_ff // tp), "w_up": param(d, cfg.d_ff // tp),
                        "w_down": param(cfg.d_ff // tp, d),
                    })}),
            })
            for _ in self.layer_ids
        )

    def _set_parallel(self, tp_group, layer_ids) -> None:
        cfg, tp = self.config, 1 if tp_group is None else tp_group.size
        if cfg.n_head % tp or cfg.n_kv_head % tp:
            raise ValueError(
                f"n_head={cfg.n_head}/n_kv_head={cfg.n_kv_head} not divisible by tp={tp}")
        super()._set_parallel(tp_group, layer_ids)

    def param_specs(self, fsdp: int = 1) -> dict:
        """The JAX ``Llama.param_specs`` (see ``GPT2.param_specs``)."""
        cfg = self.config
        d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
        kv_d = cfg.n_kv_head * (cfg.d_model // cfg.n_head)
        F = fsdp_spec_fn(fsdp)
        layer = {
            "rms_1.scale": F((), d), "rms_2.scale": F((), d),
            "attn.wq": F((None, "tp"), d, d), "attn.wk": F((None, "tp"), d, kv_d),
            "attn.wv": F((None, "tp"), d, kv_d), "attn.wo": F(("tp", None), d, d),
            **(self._moe_specs(fsdp) if cfg.n_experts else {
                "mlp.w_gate": F((None, "tp"), d, ff), "mlp.w_up": F((None, "tp"), d, ff),
                "mlp.w_down": F(("tp", None), ff, d),
            }),
        }
        specs = {"wte": F(("tp", None), V, d), "lm_head": F(("tp", None), V, d),
                 "rms_f.scale": F((), d)}
        for i in range(cfg.n_layer):
            specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
        return specs

    # ---- params ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Llama":
        """Fill the weights from ``np.random.default_rng(seed)`` in the JAX
        init's order and scales (``wte``, ``lm_head``, then per layer ``wq``,
        ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down`` — Mixtral:
        the experts' ``gate``, ``w_in``, ``w_out`` in the MLP's place, their
        biases zero; the residual projections ``wo``, ``w_down`` and
        ``w_out`` at 0.02/sqrt(2·n_layer)):
        the same seed gives the same f32 weights in both packages (a bf16
        model rounds them from f32). Returns ``self``."""
        cfg = self.config
        d, ff = cfg.d_model, cfg.d_ff
        kv_d = cfg.n_kv_head * (d // cfg.n_head)
        normal = self._drawer(seed)
        res_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        normal("wte", (cfg.vocab_size, d))
        normal("lm_head", (cfg.vocab_size, d))
        self.rms_f["scale"].fill_(1.0)
        for i in range(cfg.n_layer):
            for key, shape in (("wq", (d, d)), ("wk", (d, kv_d)), ("wv", (d, kv_d))):
                normal(f"layers.{i}.attn.{key}", shape)
            normal(f"layers.{i}.attn.wo", (d, d), std=res_std)
            if cfg.n_experts:
                self._moe_draw(normal, i, res_std)
                continue
            normal(f"layers.{i}.mlp.w_gate", (d, ff))
            normal(f"layers.{i}.mlp.w_up", (d, ff))
            normal(f"layers.{i}.mlp.w_down", (ff, d), std=res_std)
        for layer in self.layers:
            layer["rms_1"]["scale"].fill_(1.0)
            layer["rms_2"]["scale"].fill_(1.0)
            if cfg.n_experts:
                layer["moe"]["b_in"].zero_()
                layer["moe"]["b_out"].zero_()
        return self

    # ---- architecture hooks ---------------------------------------------------

    def _embed(self, tokens: torch.Tensor, offset=0) -> torch.Tensor:
        """Token embedding only: positions enter through RoPE."""
        return vocab_parallel_embed(self.wte, tokens, self.tp_group)

    def _norm1(self, layer, h):
        return _rms_norm(h, layer["rms_1"]["scale"], self.config.rms_eps)

    def _final_norm(self, h):
        return _rms_norm(h, self.rms_f["scale"], self.config.rms_eps)

    def _unembed_matrix(self) -> torch.Tensor:
        return self.lm_head

    def _add_attn_out(self, layer, h, attn_out):
        return h + attn_out  # no attention bias

    @property
    def _n_cache_heads(self) -> int:
        return self.config.n_kv_head

    def _rotary(self, positions, length):
        cfg = self.config
        if isinstance(positions, int):
            positions = positions + torch.arange(length, device=self.device)
        return _rope_tables(positions, cfg.d_model // cfg.n_head, cfg.rope_theta)

    def _serving_qkv(self, layer, x, rot):
        """Separate q/k/v projections, head split, RoPE on q/k by ``rot``
        (:meth:`_rotary`'s tables) → q [b, n_head, s, hd] and the kv-head k,
        v [b, n_kv_head, s, hd] the cache stores — one copy of the GQA math
        for training and serving, as the JAX ``_qkv_gqa``."""
        cfg = self.config
        hd = cfg.d_model // cfg.n_head
        attn = layer["attn"]
        b, s, _ = x.shape

        def heads(t, n):  # [b, s, n·hd] -> [b, n, s, hd]
            return t.reshape(b, s, n, hd).transpose(1, 2)

        nq, nkv = cfg.n_head // self.tp, cfg.n_kv_head // self.tp  # this rank's heads
        q = _apply_rope(heads(qmatmul(x, attn["wq"]), nq), *rot)
        k = _apply_rope(heads(qmatmul(x, attn["wk"]), nkv), *rot)
        return q, k, heads(qmatmul(x, attn["wv"]), nkv)

    def _attn_kv(self, k, v):
        """K/V repeated to the query heads, as ``jnp.repeat(k, rep, axis=1)``:
        each kv head in place (0,0,1,1,..); ``Tensor.repeat`` would tile
        (0,1,0,1,..) and pair query heads with the wrong kv heads."""
        rep = self.config.n_head // self.config.n_kv_head
        if rep == 1:
            return k, v
        return torch.repeat_interleave(k, rep, dim=1), torch.repeat_interleave(v, rep, dim=1)

    def _mlp_block(self, mlp, x):
        x = self._tp_in(x)
        return self._tp_out(qmatmul(F.silu(qmatmul(x, mlp["w_gate"])) * qmatmul(x, mlp["w_up"]),
                                    mlp["w_down"]))

    def _ffn(self, layer, h):
        x = _rms_norm(h, layer["rms_2"]["scale"], self.config.rms_eps)
        if self.config.n_experts:
            return h + self._moe_block(layer["moe"], x)
        return h + self._mlp_block(layer["mlp"], x)

    def _block(self, layer, h, attend, rot=None):
        """One pre-norm block: RMSNorm → GQA attention, q/k rotated by ``rot``
        (:meth:`_rotary`), over the repeated K/V → wo residual, then the
        SwiGLU FFN residual (the only checkpointed part under
        ``remat="mlp"``)."""
        q, k, v = self._serving_qkv(layer, self._tp_in(self._norm1(layer, h)), rot)
        h = h + self._tp_out(qmatmul(self._merge_heads(attend(q, *self._attn_kv(k, v),
                                                              causal=True)),
                                     layer["attn"]["wo"]))
        if self.config.remat == "mlp" and torch.is_grad_enabled():
            return checkpoint(self._ffn, layer, h, use_reentrant=False)
        return self._ffn(layer, h)

    def _decode_attention(self, q, ck, cv, valid, k_s=None, v_s=None):
        """Grouped-query attention against the kv-head cache: q [b, Hq, q,
        hd] grouped over ck/cv [b, Hkv, S, hd] without a materialised
        repeat; scores and the value sum in f32, as the JAX einsums'
        ``preferred_element_type``. ``valid`` is [S], [b, S] or [b, q, S];
        ``k_s``/``v_s`` [b, Hkv, S, 1] are a quantized cache's scales (both
        q·k operands then go to f32, as in GPT-2's quantized branch)."""
        b, hq, s, hd = q.shape
        rep = hq // ck.shape[1]
        qg = q.reshape(b, hq // rep, rep, s, hd)
        scores = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), ck.float()) * (hd ** -0.5)
        if k_s is not None:
            scores = scores * k_s.transpose(-1, -2)[:, :, None]  # per-key scale [b, g, 1, 1, S]
        if valid.ndim == 1:
            vmask = valid[None, None, None, None, :]
        elif valid.ndim == 2:
            vmask = valid[:, None, None, None, :]
        else:
            vmask = valid[:, None, None, :, :]
        probs = torch.softmax(scores.masked_fill(~vmask, _NEG_INF), dim=-1)
        if v_s is not None:
            probs = probs * v_s.transpose(-1, -2)[:, :, None]
        else:
            probs = probs.to(cv.dtype)  # the JAX einsum's operand type, summed in f32
        out = torch.einsum("bgrqk,bgkd->bgrqd", probs.float(), cv.float())
        return out.reshape(b, hq, s, hd).to(q.dtype)
