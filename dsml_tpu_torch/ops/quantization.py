"""Quantization codecs of the port — the counterpart of
``dsml_tpu/ops/quantization.py``: the KV-row codec of the paged and
quantized KV caches, the block-quantized serving weights with their
dequant-fused matmul (the hand-written CUDA kernel ``csrc/qmm.cu``), and
the blockwise stochastic int8 activation codec (the CUDA kernel
``csrc/quantize_int8.cu``) behind compressed rematerialisation.

**KV rows.** A K or V row (one position, one head) quantizes on its own
with a symmetric absmax scale, so a cache or page write never touches
another row's bytes, and a row's bytes are the same in a dense cache and in
a page pool. int8 stores the values as they are; int4 packs two offset
nibbles per byte with the channel halves contiguous: byte j holds channel j
in its high nibble and channel j + hd/2 in its low nibble, each offset by
+8. The rounding is ``torch.round``, which rounds half to even like
``jnp.round``, so both packages write the same bytes for the same rows.

**Serving weights.** :func:`quantize_weight_blocks` turns a matmul weight
(contracting on its first axis) into int8 or int4 codes with one f32 scale
per (k-block, output channel), and :func:`quantized_matmul` multiplies by
it without ever expanding the weight: the kernel unpacks the codes in
shared memory and folds each block's scale in after that block's integer
dot. The int4 layout is NOT the KV codec's: within each k-block the two ROW
halves pack along the contraction axis (byte row r of block b holds row
b·kb + r in its high nibble and row b·kb + kb/2 + r in its low nibble).

**Activations.** :func:`quantize_int8` is blockwise absmax int8 over
512-element blocks with stochastic rounding ``floor(x/scale + u)``. The TPU
kernel draws ``u`` from its on-core generator, which has no twin; here
``u`` is a counter hash of (seed, element index) (:func:`_noise_bits`), so
the CUDA kernel and :func:`_quantize_int8_reference` agree bit for bit.
:func:`compressed_checkpoint` stashes a block's input in that form and
recomputes the block from it in the backward.

On CUDA tensors :func:`quantized_matmul` and :func:`quantize_int8` launch
their kernels or raise; on CPU tensors they run the plain versions
(:func:`_qmm_reference`, :func:`_quantize_int8_reference`). There is no
dequantize-then-dot fallback and no shared-memory budget guard: each
kernel's shared memory is fixed by its own tiles.

The collective codecs of the JAX module (``compressed_all_reduce``, the
quantized ring schedules) come with the data-parallel slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.utils.hash32 import M32, mix32, mul32

__all__ = [
    "QuantScheme",
    "QuantizedTensor",
    "QuantizedWeight",
    "compressed_checkpoint",
    "default_qblock",
    "dequantize_int8",
    "dequantize_kv_rows",
    "dequantize_weight_blocks",
    "get_scheme",
    "kv_row_bytes",
    "pack_int4",
    "quantize_int8",
    "quantize_kv_rows",
    "quantize_weight_blocks",
    "quantized_matmul",
    "unpack_int4",
    "weight_quant_mode",
]

_BLOCK = 512  # elements per scale block of the activation codec, and the default weight block

# Launches of each CUDA kernel, counted where it launches. chip_smoke.py
# zeroes them before driving the main path and reads them after.
qmm_launches = 0
quantize_int8_launches = 0


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if name == "qmm":
        lib.qmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        lib.quantize_int8.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
    getattr(lib, name).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib(name)
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: {getattr(lib, f'{name}_error_string')(err).decode()}")


# ---------------------------------------------------------------------------
# the KV-row codec
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack integer values in [-7, 7] two per byte along the last axis
    (which must be even): the first half of the axis goes to the high
    nibbles, the second half to the low ones, each offset to q + 8."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {tuple(q.shape)}")
    q = q.to(torch.int32) + 8
    half = q.shape[-1] // 2
    return (q[..., :half] << 4 | q[..., half:]).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., k]`` packed bytes → ``[..., 2k]``
    int8 in [-7, 7] (channel halves contiguous)."""
    hi = (p >> 4).to(torch.int8) - 8
    lo = (p & 0xF).to(torch.int8) - 8
    return torch.cat([hi, lo], dim=-1)


def quantize_kv_rows(x: torch.Tensor, mode: str = "int4"):
    """Symmetric absmax quantization of KV rows ``[..., rows, hd]`` →
    ``(values, f32 scales [..., rows, 1])``, one scale per row; a zero row
    gets scale 1. ``mode="int8"`` gives int8 values, ``"int4"`` packed
    uint8 (:func:`pack_int4`, even ``hd``)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown KV quant mode {mode!r}; choose 'int8' or 'int4'")
    x32 = x.float()
    a = x32.abs().amax(dim=-1, keepdim=True)
    if mode == "int4":
        if x.shape[-1] % 2:
            raise ValueError(f"int4 KV rows need an even trailing dim, got {tuple(x.shape)}")
        s = torch.where(a > 0, a / 7.0, 1.0)
        return pack_int4(torch.clamp(torch.round(x32 / s), -7, 7)), s
    s = torch.where(a > 0, a / 127.0, 1.0)
    return torch.round(x32 / s).to(torch.int8), s


def dequantize_kv_rows(values: torch.Tensor, scales: torch.Tensor, mode: str = "int4") -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` → f32 rows ``[..., rows, hd]``.
    The serving path never calls it (attention folds the scales in after
    its products); it is for round-trip tests and tools."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown KV quant mode {mode!r}; choose 'int8' or 'int4'")
    q = unpack_int4(values) if mode == "int4" else values
    return q.float() * scales


def kv_row_bytes(head_dim: int, mode: str | None) -> int:
    """Device bytes of one K or V row (one position, one head) under
    ``mode`` (None = f32), its scale included."""
    if mode is None:
        return 4 * head_dim
    if mode == "int8":
        return head_dim + 4  # int8 values + one f32 scale
    if mode == "int4":
        if head_dim % 2:
            raise ValueError(f"int4 KV rows need an even head_dim, got {head_dim}")
        return head_dim // 2 + 4  # two nibbles per byte + one f32 scale
    raise ValueError(f"unknown KV quant mode {mode!r}")


# ---------------------------------------------------------------------------
# quant schemes and the env knobs
# ---------------------------------------------------------------------------

_SCHEME_TABLE = {"int8": (8, 127), "int4": (4, 7)}


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """One block-scaled integer format: ``bits`` per element, symmetric
    range ``[-qmax, qmax]``, one f32 scale per ``block`` elements. int4
    packs two values per byte, so its block must be even."""

    name: str  # "int8" | "int4"
    bits: int
    qmax: int
    block: int


def default_qblock() -> int:
    """Elements per scale block: 512, overridable with ``DSML_QBLOCK``.
    Malformed, non-positive or odd values fall back to 512 (an odd block
    would split an int4 nibble pair)."""
    try:
        b = int(os.environ.get("DSML_QBLOCK", _BLOCK))
    except ValueError:
        return _BLOCK
    return b if b > 0 and b % 2 == 0 else _BLOCK


def get_scheme(name, block: int | None = None) -> QuantScheme:
    """``"int8"``/``"int4"`` (or a :class:`QuantScheme`, returned as it is)
    → a scheme with ``block`` elements per scale (default
    :func:`default_qblock`)."""
    if isinstance(name, QuantScheme):
        return name
    if name not in _SCHEME_TABLE:
        raise ValueError(f"unknown quant scheme {name!r}; choose from {sorted(_SCHEME_TABLE)}")
    bits, qmax = _SCHEME_TABLE[name]
    block = default_qblock() if block is None else int(block)
    if block <= 0 or block % 2:
        raise ValueError(f"quant block must be positive and even, got {block}")
    return QuantScheme(name, bits, qmax, block)


def weight_quant_mode() -> str | None:
    """The serving weight-codec knob ``DSML_WEIGHT_QUANT``: "int8"/"8" or
    "int4"/"4"; anything else (unset, "0", "off", malformed) is off, so a
    bad value never refuses to serve. Read once per batcher."""
    raw = os.environ.get("DSML_WEIGHT_QUANT", "").strip().lower()
    if raw in ("int8", "8"):
        return "int8"
    if raw in ("int4", "4"):
        return "int4"
    return None


# ---------------------------------------------------------------------------
# block-quantized serving weights and the dequant-fused matmul (kernel 7)
# ---------------------------------------------------------------------------


class QuantizedWeight(nn.Module):
    """A block-quantized matmul weight contracting on its FIRST axis.

    Buffers: ``qw``, the integer codes over the padded 2-D form ``[d_p,
    n_p]`` (int8) or ``[d_p // 2, n_p]`` (int4, each k-block's two row
    halves packed high/low per byte); ``qs``, one f32 scale per (k-block,
    output channel), ``[d_p // block, n_p]``. ``shape`` and ``dtype`` are
    the original weight's; ``block`` is the effective k-block
    (:func:`_weight_pads`). A module, so a model holding it moves and
    saves it like any weight (``...wqkv.qw`` in ``state_dict()``)."""

    def __init__(self, qw: torch.Tensor, qs: torch.Tensor, scheme: str, block: int,
                 shape: tuple, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("qw", qw)
        self.register_buffer("qs", qs)
        self.scheme = scheme
        self.block = int(block)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def hbm_bytes(self) -> int:
        """Resident bytes: packed codes plus scales."""
        return self.qw.nbytes + self.qs.nbytes

    @property
    def dense_bytes(self) -> int:
        """Bytes of the same weight dense at its original type."""
        return math.prod(self.shape) * torch.empty((), dtype=self.dtype).element_size()

    def extra_repr(self) -> str:
        return f"scheme={self.scheme}, block={self.block}, shape={self.shape}, dtype={self.dtype}"


def _weight_pads(d: int, n: int, block: int) -> tuple[int, int, int]:
    """(kb, d_p, n_p): the effective k-block and the padded operand dims.
    The contraction axis pads to a multiple of 8 only, and ``kb`` is the
    largest multiple-of-8 divisor of ``d_p`` not above the block (768 and
    3072 give kb 384 and 512, no waste); channels pad to 128 with zero
    columns of scale 1."""
    d_p = -(-d // 8) * 8
    cap = min(int(block), d_p)
    kb = max(k for k in range(8, cap + 1, 8) if d_p % k == 0)
    n_p = -(-n // 128) * 128
    return kb, d_p, n_p


def quantize_weight_blocks(w: torch.Tensor, scheme="int8", block: int | None = None) -> QuantizedWeight:
    """Block-quantize a matmul weight for :func:`quantized_matmul`:
    round half to even, a symmetric absmax scale per (k-block, output
    channel), zero blocks at scale 1. ``w``'s first axis is the
    contraction axis; trailing axes flatten to output channels (GPT-2's
    ``wqkv [d, 3, d]`` keeps a scale per (block, slot, channel)). The codes
    are made where ``w`` lies."""
    sch = get_scheme(scheme, block)
    if w.ndim < 2:
        raise ValueError(f"weight quant needs a matmul weight, got shape {tuple(w.shape)}")
    d = int(w.shape[0])
    wf = w.detach().float().reshape(d, -1)
    n = int(wf.shape[1])
    kb, d_p, n_p = _weight_pads(d, n, sch.block)
    if (d_p, n_p) != (d, n):
        wf = F.pad(wf, (0, n_p - n, 0, d_p - d))
    nb = d_p // kb
    blocks = wf.reshape(nb, kb, n_p)
    a = blocks.abs().amax(dim=1)  # [nb, n_p]
    qs = torch.where(a > 0, a / sch.qmax, 1.0)
    q = torch.clamp(torch.round(blocks / qs[:, None, :]), -sch.qmax, sch.qmax)
    if sch.bits == 4:
        half = kb // 2
        hi = q[:, :half].to(torch.int32) + 8
        lo = q[:, half:].to(torch.int32) + 8
        qw = (hi << 4 | lo).to(torch.uint8).reshape(d_p // 2, n_p)
    else:
        qw = q.to(torch.int8).reshape(d_p, n_p)
    return QuantizedWeight(qw, qs, sch.name, kb, tuple(w.shape), w.dtype)


def _block_codes(qwt: QuantizedWeight, b: int) -> torch.Tensor:
    """The integer codes of k-block ``b`` as f32 ``[kb, n_p]``: int4 bytes
    unpack to the block's high-nibble rows, then its low-nibble rows."""
    kb = qwt.block
    if qwt.scheme == "int4":
        raw = qwt.qw[b * kb // 2:(b + 1) * kb // 2]
        return torch.cat([(raw >> 4).to(torch.int8) - 8, (raw & 0xF).to(torch.int8) - 8]).float()
    return qwt.qw[b * kb:(b + 1) * kb].float()


def dequantize_weight_blocks(qwt: QuantizedWeight) -> torch.Tensor:
    """Inverse of :func:`quantize_weight_blocks` → f32 at the original
    shape. The serving path never calls it (it would expand the weight the
    kernel exists to keep packed); it is for tests and tools."""
    nb = qwt.qs.shape[0]
    full = torch.cat([_block_codes(qwt, b) * qwt.qs[b] for b in range(nb)])
    d, n = qwt.shape[0], math.prod(qwt.shape[1:])
    return full[:d, :n].reshape(qwt.shape)


def _qmm_reference(x: torch.Tensor, qwt: QuantizedWeight) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in f32: for each k-block the
    dot of x's columns with the block's integer codes, times the block's
    scales, added to an f32 accumulator → ``[m, n]``."""
    m, d = x.shape
    xf = x.float()
    acc = torch.zeros(m, qwt.qs.shape[1], dtype=torch.float32, device=x.device)
    kb = qwt.block
    for b in range(-(-d // kb)):
        lo, hi = b * kb, min((b + 1) * kb, d)
        acc = acc + (xf[:, lo:hi] @ _block_codes(qwt, b)[:hi - lo]) * qwt.qs[b]
    return acc[:, :math.prod(qwt.shape[1:])]


_QMM_ROWS = 16  # the kernel's row tile (csrc/qmm.cu BM)
_MAX_GRID_Y = 65535


def _check_qmm_inputs(x, qwt: QuantizedWeight) -> None:
    qw, qs = qwt.qw, qwt.qs
    if any(t.device != x.device for t in (qw, qs)) or x.device.type != "cuda":
        raise ValueError(
            "quantized_matmul needs x and the weight on one CUDA device, got "
            f"{sorted({str(t.device) for t in (x, qw, qs)})}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantized_matmul takes float32 or bfloat16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantized_matmul needs a contiguous x [m, d] (row-major)")
    nb, n_p = qs.shape
    kb = qwt.block
    rows = nb * kb // 2 if qwt.scheme == "int4" else nb * kb
    want = torch.uint8 if qwt.scheme == "int4" else torch.int8
    if (qw.dtype, tuple(qw.shape)) != (want, (rows, n_p)) or qs.dtype != torch.float32:
        raise ValueError(
            f"a {qwt.scheme} weight of block {kb} holds {want} codes [{rows}, {n_p}] and f32 "
            f"scales; got {qw.dtype} {tuple(qw.shape)}, {qs.dtype} {tuple(qs.shape)}"
        )
    if kb % 8 or n_p % 128:
        raise ValueError(f"the kernel needs kb % 8 == 0 and n_p % 128 == 0, got {kb}, {n_p}")
    for name, t in (("qw", qw), ("qs", qs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quantized_matmul needs a contiguous, 16-byte aligned {name}")
    if -(-x.shape[0] // _QMM_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"quantized_matmul supports <= {_MAX_GRID_Y * _QMM_ROWS} rows, got {x.shape[0]}")


def quantized_matmul(x: torch.Tensor, qwt: QuantizedWeight) -> torch.Tensor:
    """``x [m, d] @ dequant(qwt)`` → f32 ``[m, n]`` with the dequantization
    fused into the product (``n`` = the weight's trailing axes flattened):
    codes stream at their packed width and each k-block's scale folds in
    after that block's dot. ``x`` is f32 or bf16, read in its own type.
    CUDA tensors launch ``csrc/qmm.cu`` on the current stream (no
    synchronisation) or raise; CPU tensors run :func:`_qmm_reference`."""
    if x.ndim != 2 or x.shape[1] != qwt.shape[0]:
        raise ValueError(f"x must be [m, {qwt.shape[0]}], got {tuple(x.shape)}")
    if x.device.type == "cpu" and qwt.qw.device.type == "cpu":
        return _qmm_reference(x, qwt)
    _check_qmm_inputs(x, qwt)
    m, d = x.shape
    nb, n_p = qwt.qs.shape
    n = math.prod(qwt.shape[1:])
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m:
        _launch("qmm", x.data_ptr(), qwt.qw.data_ptr(), qwt.qs.data_ptr(), out.data_ptr(),
                m, d, n, n_p, qwt.block, nb, int(x.dtype == torch.bfloat16),
                int(qwt.scheme == "int4"), torch.cuda.current_stream(x.device).cuda_stream)
        global qmm_launches
        qmm_launches += 1
    return out


# ---------------------------------------------------------------------------
# the stochastic int8 activation codec (kernel 8) and compressed remat
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedTensor:
    """Blockwise int8 tensor: ``values`` int8 ``[blocks, 512]``, ``scales``
    f32 ``[blocks, 1]``, and the original element count, shape and type."""

    values: torch.Tensor
    scales: torch.Tensor
    size: int
    shape: tuple
    dtype: torch.dtype


def _blocked(x: torch.Tensor):
    """``x`` flattened to f32 and zero-padded to whole 512-element blocks
    → (``[blocks, 512]``, element count)."""
    flat = x.reshape(-1).float()
    size = flat.numel()
    padded = max(-(-size // _BLOCK), 1) * _BLOCK
    if padded != size:
        flat = F.pad(flat, (0, padded - size))
    return flat.reshape(-1, _BLOCK), size


def _seed_tensor(seed, device) -> torch.Tensor:
    """The rounding seed as an int32 tensor of one element on ``device``:
    a tensor (kept on the device, never read on the host) or an int."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _noise_bits(seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """32 random bits per global element index ``idx`` (int64) under
    ``seed`` (int32): ``mix32(mix32(mix32(seed) ^ (lo(idx) + 1)·φ) ^
    hi(idx))`` with φ = 0x9E3779B9, in int64 arithmetic kept below 2**32 —
    the expression ``csrc/quantize_int8.cu`` computes in uint32."""
    key = mix32(seed.long() & M32)
    a = mix32(key ^ mul32(((idx & M32) + 1) & M32, 0x9E3779B9))
    return mix32(a ^ (idx >> 32))


def _quantize_int8_reference(x: torch.Tensor, seed) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel → (int8 ``[blocks, 512]``, f32
    scales ``[blocks, 1]``): ``scale = max(absmax / 127, 1e-12)``, ``y =
    x / scale``, ``q = clip(floor(y + u), -127, 127)`` with ``u = (bits >>
    8)·2^-24`` from :func:`_noise_bits`. Both divisions are tensor by
    tensor, so they are IEEE divisions on the card too (PyTorch multiplies
    by the reciprocal of a host scalar divisor)."""
    blocks, _ = _blocked(x)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    idx = torch.arange(blocks.numel(), device=x.device).reshape(blocks.shape)
    u = (_noise_bits(_seed_tensor(seed, x.device), idx) >> 8).float() * 2.0 ** -24
    q = torch.clamp(torch.floor(blocks / scale + u), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, seed=0) -> QuantizedTensor:
    """Blockwise (512-element) absmax int8 quantization with stochastic
    rounding, unbiased: E[q·scale] = x. ``seed`` (an int, or an int32
    tensor that stays on the device) varies the noise. CUDA tensors launch
    ``csrc/quantize_int8.cu``, which reads ``x`` in its own type (f32 or
    bf16), or raise; CPU tensors run :func:`_quantize_int8_reference`."""
    if x.device.type == "cpu":
        q, s = _quantize_int8_reference(x, seed)
        return QuantizedTensor(q, s, x.numel(), tuple(x.shape), x.dtype)
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_int8 takes a float32 or bfloat16 CUDA tensor, got {x.dtype} "
                         f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 needs a contiguous x")
    size = x.numel()
    rows = max(-(-size // _BLOCK), 1)
    if rows > 2**31 - 1:
        raise ValueError(f"quantize_int8 supports < 2**31 blocks, got {rows}")
    seed_t = _seed_tensor(seed, x.device)
    q = torch.empty(rows, _BLOCK, dtype=torch.int8, device=x.device)
    s = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    _launch("quantize_int8", x.data_ptr(), seed_t.data_ptr(), q.data_ptr(), s.data_ptr(), size,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    global quantize_int8_launches
    quantize_int8_launches += 1
    return QuantizedTensor(q, s, size, tuple(x.shape), x.dtype)


def dequantize_int8(qt: QuantizedTensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`, back in the original type."""
    flat = (qt.values.float() * qt.scales).reshape(-1)[:qt.size]
    return flat.reshape(qt.shape).to(qt.dtype)


def _leaf_seed(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-leaf seed: the sum of the int32 bitcasts of
    ``x`` in f32, wrapping in int32 — an int32 tensor on ``x``'s device
    (``torch.sum`` of int32 gives int64; the wrap is explicit)."""
    s = x.float().view(torch.int32).sum()
    return (((s & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _param_list(params) -> list:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


class _CompressedCheckpoint(torch.autograd.Function):
    """Forward: run ``fn`` without building a graph and stash each float
    input as int8 (integer inputs as they are). Backward: dequantize,
    recompute ``fn`` with grad on, and differentiate it with respect to the
    stash and the parameters, which are this Function's inputs (after the
    activations) so that autograd hands their gradients on."""

    @staticmethod
    def forward(ctx, fn, params, seed, n_x, *args):
        xs = args[:n_x]
        with torch.no_grad():
            out = fn(params, *xs)
        ctx.fn, ctx.params, ctx.n_x = fn, params, n_x
        ctx.meta, saved = [], []
        for x in xs:
            if x.is_floating_point():
                qt = quantize_int8(x, _leaf_seed(x) if seed is None else seed)
                ctx.meta.append((qt.size, qt.shape, qt.dtype))
                saved += [qt.values, qt.scales]
            else:
                ctx.meta.append(None)
                saved.append(x)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = list(ctx.saved_tensors)
        need = ctx.needs_input_grad[4:]
        xs = []
        for meta, want in zip(ctx.meta, need):
            if meta is None:
                xs.append(saved.pop(0))
            else:
                values, scales = saved.pop(0), saved.pop(0)
                x_hat = dequantize_int8(QuantizedTensor(values, scales, *meta))
                xs.append(x_hat.requires_grad_(want))
        inputs = xs + _param_list(ctx.params)
        with torch.enable_grad():
            out = ctx.fn(ctx.params, *xs)
        wrt = [t for t, want in zip(inputs, need) if want]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None, None, None, None, *(next(grads) if want else None for want in need))


def compressed_checkpoint(fn, seed=None):
    """Compressed rematerialisation: ``compressed_checkpoint(fn)(params,
    *xs)`` is ``fn(params, *xs)``, but where plain remat stashes the inputs
    at full precision this stashes each float input blockwise int8
    (:func:`quantize_int8`; 2× under bf16, 4× under f32) and the backward
    recomputes ``fn`` from the dequantized stash. Gradients are ``fn``'s at
    the dequantized input: exact in expectation, off by the rounding noise.

    ``params`` is an ``nn.Module`` (its ``parameters()``), a dict or a list
    of tensors; each is handed to the autograd Function so it gets its
    gradient. ``seed=None`` derives each input's seed from its own bits
    (:func:`_leaf_seed`, as the JAX package does), which changes every
    layer and step without a counter and never leaves the device."""

    def wrapped(params, *xs):
        return _CompressedCheckpoint.apply(fn, params, seed, len(xs), *xs, *_param_list(params))

    return wrapped
