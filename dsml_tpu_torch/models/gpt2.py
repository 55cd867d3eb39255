"""GPT-2 in PyTorch — the counterpart of ``dsml_tpu/models/gpt2.py``.

Two single-device paths are ported. Serving: ``GPT2.generate`` runs one
:meth:`GPT2.prefill` over the prompt (its attention through the
hand-written CUDA flash kernel once the prompt reaches 512 tokens on the
card), then a loop of :meth:`GPT2.decode_step` over the dense KV cache, with
:func:`sample_token_logits` picking each token. Training: :meth:`GPT2.loss`
is the mean next-token cross-entropy over the block stack, with attention
through the flash kernels (forward and backward) when asked, dense or
chunked logits (``xent_chunk``) and optional rematerialisation (``remat``).
The plain forward :meth:`GPT2.apply` is here too, for the parity tests.

Weights keep the JAX package's layouts (``wqkv [d, 3, d]``, ``w_in [d, d_ff]``
used as ``x @ W``, q/k/v ``[batch, heads, seq, head_dim]``) and names: the
module's ``state_dict()`` keys are the dotted paths of the JAX parameter
tree (``layers.0.attn.wqkv``), so ``models.convert.params_from_jax`` maps
one onto the other. :meth:`GPT2.init` draws the same
``np.random.default_rng(seed)`` sequence as the JAX init, so both packages
build identical weights from one seed.

Tensor, pipeline and sequence parallelism, MoE, compressed (int8) remat,
the int8/int4 KV cache, the paged and continuous-batching surfaces and
speculative decoding come with later slices.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dsml_tpu_torch.models.common import qmatmul
from dsml_tpu_torch.ops.attention import _NEG_INF, attention
from dsml_tpu_torch.ops.flash import flash_attention
from dsml_tpu_torch.ops.xent import chunked_softmax_xent
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
    # (torch.utils.checkpoint), "mlp" only its FFN sub-block
    remat: bool | str = False
    # loss: stream the unembedding in chunks of this many vocab rows
    # (ops/xent.py) when vocab_size > xent_chunk; 0 = dense logits
    xent_chunk: int = 8192
    # kept so that a JAX config's serving fields carry over; both raise if set
    n_experts: int = 0
    kv_quant: bool | str = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from {sorted(_DTYPES)}")
        if self.remat == "int8":
            raise NotImplementedError(
                "compressed int8 remat (ops/quantization.py::compressed_checkpoint) comes "
                "with the compressed-communication slice"
            )
        if self.remat not in (False, True, "mlp"):
            raise ValueError(f"unknown remat mode {self.remat!r}; choose False, True or 'mlp'")
        if self.n_experts:
            raise NotImplementedError(
                "MoE layers (n_experts > 0) come with the model-parallel training slice"
            )
        if self.kv_quant:
            raise NotImplementedError(
                "the int8/int4 KV cache (kv_quant) comes with the paged-KV serving slice"
            )

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
                        top_p: float = 0.0) -> torch.Tensor:
    """Next-token ids from ``logits`` [..., vocab]: greedy (first maximum)
    at ``temperature <= 0``, else softmax sampling, optionally truncated to
    the ``top_k`` most likely tokens (ties with the k-th value are kept)
    and/or the nucleus holding ``top_p`` mass (the argmax is always kept).
    Sampling is Gumbel-max with noise from ``generator``: the same seed
    gives the same tokens, but not the JAX package's tokens."""
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
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
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
    """Decoder-only transformer on one device. Build it, then fill its
    weights with :meth:`init` (or ``load_state_dict``): the constructor
    allocates them uninitialised on ``device`` (``None`` = the CUDA card)."""

    _ATTN_IMPLS = ("flash", "xla")

    def __init__(self, config: GPT2Config | None = None, device=None):
        super().__init__()
        self.config = cfg = config or GPT2Config.small()
        self.device = resolve_device(device)
        dt, d = cfg.torch_dtype, cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=self.device))

        def norm():
            return nn.ParameterDict({"scale": param(d), "bias": param(d)})

        self.wte = param(cfg.vocab_size, d)
        self.wpe = param(cfg.max_seq, d)
        self.ln_f = norm()
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ln_1": norm(),
                "ln_2": norm(),
                "attn": nn.ParameterDict({
                    "wqkv": param(d, 3, d), "bqkv": param(3, d),
                    "wo": param(d, d), "bo": param(d),
                }),
                "mlp": nn.ParameterDict({
                    "w_in": param(d, cfg.d_ff), "b_in": param(cfg.d_ff),
                    "w_out": param(cfg.d_ff, d), "b_out": param(d),
                }),
            })
            for _ in range(cfg.n_layer)
        )

    # ---- params ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, seed: int = 0) -> "GPT2":
        """Fill the weights from ``np.random.default_rng(seed)`` in the JAX
        init's order and scales (``dsml_tpu/models/gpt2.py::GPT2.init``):
        the same seed gives the same f32 weights in both packages (a bf16
        model rounds them from f32). Returns ``self``."""
        cfg = self.config
        rng = np.random.default_rng(seed)

        def normal(p, std=0.02):
            p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * std).astype(np.float32)))

        def unit_norm(ln):
            ln["scale"].fill_(1.0)
            ln["bias"].zero_()

        # GPT-2 scales residual-path projections by 1/sqrt(2*n_layer)
        res_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        normal(self.wte)
        normal(self.wpe, std=0.01)
        unit_norm(self.ln_f)
        for layer in self.layers:
            unit_norm(layer["ln_1"])
            unit_norm(layer["ln_2"])
            attn, mlp = layer["attn"], layer["mlp"]
            normal(attn["wqkv"])
            attn["bqkv"].zero_()
            normal(attn["wo"], std=res_std)
            attn["bo"].zero_()
            normal(mlp["w_in"])
            mlp["b_in"].zero_()
            normal(mlp["w_out"], std=res_std)
            mlp["b_out"].zero_()
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---- forward --------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Token + position embedding → [b, s, d]; positions start at
        ``offset`` (the decode position)."""
        pos = torch.arange(tokens.shape[1], device=tokens.device) + offset
        return self.wte[tokens] + self.wpe[pos]

    def _qkv_heads(self, layer, x):
        """Fused QKV projection (``wqkv [d, 3, d]``) and head split →
        q, k, v [b, n_head, s, head_dim]."""
        attn = layer["attn"]
        qkv = qmatmul(x, attn["wqkv"]) + attn["bqkv"]  # [b, s, 3, d]
        b, s = x.shape[:2]

        def heads(t):  # [b, s, d] -> [b, h, s, hd]
            return t.reshape(b, s, self.config.n_head, -1).transpose(1, 2)

        return heads(qkv[:, :, 0]), heads(qkv[:, :, 1]), heads(qkv[:, :, 2])

    @staticmethod
    def _merge_heads(t):  # [b, H, s, hd] -> [b, s, d]
        b, _, s, _ = t.shape
        return t.transpose(1, 2).reshape(b, s, -1)

    def _mlp_block(self, mlp, x):
        # jax.nn.gelu defaults to the tanh approximation; the erf form
        # differs by up to ~5e-4 per activation
        hmid = F.gelu(qmatmul(x, mlp["w_in"]) + mlp["b_in"], approximate="tanh")
        return qmatmul(hmid, mlp["w_out"]) + mlp["b_out"]

    def _ffn(self, layer, h):
        return h + self._mlp_block(layer["mlp"], _layer_norm(h, layer["ln_2"]["scale"],
                                                             layer["ln_2"]["bias"]))

    def _norm1(self, layer, h):
        return _layer_norm(h, layer["ln_1"]["scale"], layer["ln_1"]["bias"])

    def _final_norm(self, h):
        return _layer_norm(h, self.ln_f["scale"], self.ln_f["bias"])

    def _unembed(self, h):
        return h @ self.wte.T  # tied to wte

    def _attend(self, attn_impl: str):
        if attn_impl not in self._ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl {attn_impl!r}: this port serves {self._ATTN_IMPLS}; the "
                "sequence-parallel variants come with the long-context slice"
            )
        return flash_attention if attn_impl == "flash" else attention

    def _block(self, layer, h, attend):
        """One pre-LN block: attention residual, then the FFN residual (the
        only checkpointed part under ``remat="mlp"``, which keeps the
        attention activations, flash's saved residuals among them)."""
        q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
        out = qmatmul(self._merge_heads(attend(q, k, v, causal=True)), layer["attn"]["wo"])
        h = h + (out + layer["attn"]["bo"])
        if self.config.remat == "mlp" and torch.is_grad_enabled():
            return checkpoint(self._ffn, layer, h, use_reentrant=False)
        return self._ffn(layer, h)

    def _blocks(self, tokens: torch.Tensor, attn_impl: str) -> torch.Tensor:
        """Embedding and the block stack → pre-final-norm hidden states
        [b, s, d]; ``remat=True`` recomputes each block in the backward."""
        attend = self._attend(attn_impl)
        h = self._embed(tokens)
        whole = self.config.remat is True and torch.is_grad_enabled()
        for layer in self.layers:
            if whole:
                h = checkpoint(self._block, layer, h, attend, use_reentrant=False)
            else:
                h = self._block(layer, h, attend)
        return h

    def apply(self, tokens: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        """Logits [b, s, vocab] of ``tokens`` [b, s] (causal). ``attn_impl``
        is ``"xla"`` (plain attention) or ``"flash"`` (the flash kernels)."""
        return self._unembed(self._final_norm(self._blocks(tokens, attn_impl)))

    forward = apply

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             attn_impl: str = "xla") -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` [b, s] against
        ``targets`` [b, s] (the single-shard head of the JAX
        ``_head_loss_spmd``): the chunked loss of ``ops/xent.py`` when
        ``vocab_size > xent_chunk > 0``, else dense logits in the model's
        type, cast to f32, then log-softmax."""
        cfg = self.config
        h = self._final_norm(self._blocks(tokens, attn_impl))
        if cfg.xent_chunk and cfg.vocab_size > cfg.xent_chunk:
            return chunked_softmax_xent(h, self.wte, targets, cfg.xent_chunk)
        logp = torch.log_softmax(self._unembed(h).float(), dim=-1)
        return -logp.gather(-1, targets.long()[..., None]).mean()

    # ---- autoregressive decoding (KV cache) -----------------------------------
    # The cache is allocated at max_seq and updated IN PLACE (the JAX
    # version returns a new cache each step; here that would copy it).

    def init_cache(self, batch: int) -> list[dict[str, torch.Tensor]]:
        """KV cache, one entry per layer, allocated at max_seq."""
        return [self._cache_entry(batch) for _ in range(self.config.n_layer)]

    def _cache_entry(self, batch: int) -> dict[str, torch.Tensor]:
        cfg = self.config
        shape = (batch, cfg.n_head, cfg.max_seq, cfg.d_model // cfg.n_head)
        return {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device),
        }

    def _decode_attention(self, q, ck, cv, valid):
        """q [b, H, q, hd] against the whole cache [b, H, S, hd]; ``valid``
        [S] admits the filled positions."""
        scores = torch.einsum("bhqd,bhkd->bhqk", q, ck) * (q.shape[-1] ** -0.5)
        scores = scores.masked_fill(~valid[None, None, None, :], _NEG_INF)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), cv)

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
        T-1, cache)."""
        b, t = tokens.shape
        h = self._embed(tokens)
        cache = self.init_cache(b)
        attend = flash_attention if self._prefill_use_flash(t) else attention
        for layer, c in zip(self.layers, cache):
            q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
            attn_out = qmatmul(self._merge_heads(attend(q, k, v, causal=True)),
                               layer["attn"]["wo"])
            h = h + attn_out + layer["attn"]["bo"]
            h = self._ffn(layer, h)
            c["k"][:, :, :t] = k
            c["v"][:, :, :t] = v
        h = self._final_norm(h)
        h_last = h[:, -1] if last_index is None else h[:, last_index]
        return self._unembed(h_last), cache

    def _decode_core(self, cache, h, pos: int):
        """The decode layer loop for the tokens ``h`` [b, 1, d] at ``pos``:
        norm → qkv → cache write at ``pos`` (in place) → attention over
        cache[0..pos] → wo → ffn, then the final norm and the unembedding."""
        valid = torch.arange(self.config.max_seq, device=h.device) <= pos
        for layer, c in zip(self.layers, cache):
            q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
            c["k"][:, :, pos:pos + 1] = k
            c["v"][:, :, pos:pos + 1] = v
            out = self._decode_attention(q, c["k"], c["v"], valid)
            attn_out = qmatmul(self._merge_heads(out), layer["attn"]["wo"])
            h = h + attn_out + layer["attn"]["bo"]
            h = self._ffn(layer, h)
        return self._unembed(self._final_norm(h)[:, 0]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens`` [batch] at position ``pos``. Returns
        (logits [batch, vocab], the cache, updated in place)."""
        pos = int(pos)
        return self._decode_core(cache, self._embed(tokens[:, None], offset=pos), pos)

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
        t = prompt.shape[1]
        self._check_generate_args(t, max_new_tokens, temperature, top_k, top_p)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def sample(logits):
            return sample_token_logits(logits, gen, temperature, top_k, top_p)

        logits, cache = self.prefill(prompt)
        tok = sample(logits)
        done = tok == eos_id if eos_id is not None else None
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.decode_step(cache, tok, t + i)
            tok = sample(logits)
            if done is not None:
                # rows past their EOS keep emitting eos_id
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
            out.append(tok)
        return torch.stack(out, dim=1)
