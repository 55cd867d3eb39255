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

Tensor, pipeline and sequence parallelism, MoE and speculative decoding
come with later slices.
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
from dsml_tpu_torch.ops.paged_attention import paged_attention, paged_attn_impl
from dsml_tpu_torch.ops.quantization import compressed_checkpoint, quantize_kv_rows, unpack_int4
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
    # (torch.utils.checkpoint), "mlp" only its FFN sub-block, "int8" each
    # block from its input stashed as int8 (ops.quantization.compressed_checkpoint)
    remat: bool | str = False
    # loss: stream the unembedding in chunks of this many vocab rows
    # (ops/xent.py) when vocab_size > xent_chunk; 0 = dense logits
    xent_chunk: int = 8192
    # MoE layers: kept so that a JAX config carries over; raises if set
    n_experts: int = 0
    # dense KV cache codec: False (model dtype) | True/"int8" | "int4"
    kv_quant: bool | str = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from {sorted(_DTYPES)}")
        if self.remat not in (False, True, "int8", "mlp"):
            raise ValueError(
                f"unknown remat mode {self.remat!r}; choose False, True, 'int8', or 'mlp'")
        if self.n_experts:
            raise NotImplementedError(
                "MoE layers (n_experts > 0) come with the model-parallel training slice"
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

    def _embed(self, tokens: torch.Tensor, offset: int | torch.Tensor = 0) -> torch.Tensor:
        """Token + position embedding → [b, s, d]; positions start at
        ``offset``: an int, or a tensor [b, 1] of per-row starts."""
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
        [b, s, d]; ``remat=True`` recomputes each block in the backward,
        ``remat="int8"`` recomputes it from its input stashed as int8."""
        attend = self._attend(attn_impl)
        h = self._embed(tokens)
        remat = self.config.remat if torch.is_grad_enabled() else False
        if remat == "int8":
            block = compressed_checkpoint(lambda layer, x: self._block(layer, x, attend))
        for layer in self.layers:
            if remat is True:
                h = checkpoint(self._block, layer, h, attend, use_reentrant=False)
            elif remat == "int8":
                h = block(layer, h)
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
    # The cache is allocated at max_seq and updated IN PLACE: the JAX package
    # returns a new cache and donates the old buffers to XLA; here a new
    # cache per step would be a copy.

    def init_cache(self, batch: int) -> list[dict[str, torch.Tensor]]:
        """KV cache, one entry per layer, allocated at max_seq. With
        ``config.kv_quant`` the entries are int8 (or int4 packed in uint8)
        rows plus one f32 scale per row (:meth:`_cache_write`)."""
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
        hd = cfg.d_model // cfg.n_head
        mode = self._kv_mode()

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if mode:
            if mode == "int4":
                if hd % 2:
                    raise ValueError(f"kv_quant='int4' needs an even head_dim, got {hd}")
                shape, dt = (batch, cfg.n_head, cfg.max_seq, hd // 2), torch.uint8  # 2 nibbles/byte
            else:
                shape, dt = (batch, cfg.n_head, cfg.max_seq, hd), torch.int8
            return {"k": zeros(shape, dt), "k_s": zeros((*shape[:3], 1), torch.float32),
                    "v": zeros(shape, dt), "v_s": zeros((*shape[:3], 1), torch.float32)}
        shape = (batch, cfg.n_head, cfg.max_seq, hd)
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
        cache = self.init_cache(b)
        attend = flash_attention if self._prefill_use_flash(t) else attention
        for layer, c in zip(self.layers, cache):
            q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
            attn_out = qmatmul(self._merge_heads(attend(q, k, v, causal=True)),
                               layer["attn"]["wo"])
            h = h + attn_out + layer["attn"]["bo"]
            h = self._ffn(layer, h)
            self._cache_write(c, k, v, lambda arr, new: arr[:, :, :t].copy_(new))
        h = self._final_norm(h)
        h_last = h[:, -1] if last_index is None else h[:, last_index]
        return self._unembed(h_last), cache

    def _read_logits(self, h, read_index):
        """Final norm and unembedding of ``h`` [b, C, d] at ``read_index``:
        None reads row 0 (a decode step's one query), "all" every row, an
        int that chunk-local row."""
        h = self._final_norm(h)
        if isinstance(read_index, str) and read_index == "all":
            return self._unembed(h)
        return self._unembed(h[:, 0 if read_index is None else int(read_index)])

    def _decode_core(self, cache, h, valid, write, read_index=None):
        """The decode layer loop for the tokens ``h`` [b, C, d]: norm → qkv
        → cache write through the caller's ``write`` placement (in place) →
        attention over the cache under ``valid`` → wo → ffn; then the logits
        at ``read_index`` (:meth:`_read_logits`). ``decode_step``,
        ``decode_step_slots``, ``prefill_chunk`` and ``verify_step`` differ
        only in valid, write and read_index."""
        for layer, c in zip(self.layers, cache):
            q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
            self._cache_write(c, k, v, write)
            ck, cv, k_s, v_s = self._cache_attn_inputs(c)
            out = self._decode_attention(q, ck, cv, valid, k_s, v_s)
            attn_out = qmatmul(self._merge_heads(out), layer["attn"]["wo"])
            h = h + attn_out + layer["attn"]["bo"]
            h = self._ffn(layer, h)
        return self._read_logits(h, read_index), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """One decode step: ``tokens`` [batch] at position ``pos``. Returns
        (logits [batch, vocab], the cache, updated in place)."""
        pos = int(pos)
        valid = torch.arange(self.config.max_seq, device=self.device) <= pos
        return self._decode_core(
            cache, self._embed(tokens[:, None], offset=pos), valid,
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
                                 valid, write)

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

        return self._decode_core(cache, self._embed(tokens, offset=start[:, None]), valid,
                                 write, read_index="all")

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
            cache, self._embed(tokens, offset=start), valid,
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
        token rows, ``k``/``v`` [n_pages, n_head, page_size, hd (hd/2 for
        int4)] plus f32 ``k_s``/``v_s`` [n_pages, n_head, page_size, 1] when
        quantized. ``page_size`` must divide max_seq, so a slot's table has
        ``max_seq // page_size`` entries. Page 0 is the SCRATCH page: dead
        slots and unallocated entries name it, so their masked writes land
        nowhere that is read."""
        cfg = self.config
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(f"page_size must divide max_seq={cfg.max_seq}, got {page_size}")
        if n_pages < 2:
            raise ValueError(f"need n_pages >= 2 (page 0 is the scratch page), got {n_pages}")
        mode = self._page_mode(quant)
        hd = cfg.d_model // cfg.n_head
        if mode == "int4":
            if hd % 2:
                raise ValueError(f"int4 pages need an even head_dim, got {hd}")
            shape, dt = (n_pages, cfg.n_head, page_size, hd // 2), torch.uint8
        elif mode == "int8":
            shape, dt = (n_pages, cfg.n_head, page_size, hd), torch.int8
        else:
            shape, dt = (n_pages, cfg.n_head, page_size, hd), cfg.torch_dtype

        def entry():
            e = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
            if mode:
                sshape = (n_pages, cfg.n_head, page_size, 1)
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
        for layer, c in zip(self.layers, pool):
            q, k, v = self._qkv_heads(layer, self._norm1(layer, h))
            self._paged_write(c, k, v, write, mode)
            if use_kernel:
                out = paged_attention(q, c, page_table, posq, mode)
            else:
                ck, cv, k_s, v_s = self._paged_attn_inputs(c, page_table, mode)
                out = self._decode_attention(q, ck, cv, valid, k_s, v_s)
            attn_out = qmatmul(self._merge_heads(out), layer["attn"]["wo"])
            h = h + attn_out + layer["attn"]["bo"]
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
