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
it without ever expanding the weight: the kernel unpacks the codes to
bf16 in registers for the tensor cores (bf16 x) and folds each block's
scale in after that block's integer dot. The int4 layout is NOT the KV
codec's: within each k-block the two ROW halves pack along the
contraction axis (byte row r of block b holds row b·kb + r in its high
nibble and row b·kb + kb/2 + r in its low nibble).

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

**Compressed gradient communication.** :func:`quantized_ring_all_reduce`
runs the 2(n−1)-hop ring of ``ops/collectives.py`` with every hop's chunk
block-quantized to int8 or packed int4 (one f32 scale per block);
:func:`quantized_flat_reduce_scatter` is its scatter-reduce half alone;
:func:`compressed_all_reduce` quantizes the whole payload once with
:func:`quantize_int8` (kernel 8 on CUDA tensors) and all-gathers it.
Their hops move through ``ops.collectives.ring_pass``: gloo for CPU
tensors, the CUDA IPC transport for CUDA tensors. Under deterministic
rounding the ring, the reduce-scatter and :func:`quantize_roundtrip` equal
the JAX package's bit for bit. Two points of XLA's CPU arithmetic are
copied for that: a division by a constant is a multiply by its f32
reciprocal (the scale is ``absmax · f32(1/qmax)``), and ``a + q·s`` is
one fused multiply-add (:func:`_fma`). The stochastic paths draw their
noise from :func:`_noise_bits` where JAX draws it from ``jax.random``, so
they agree with it in distribution, not in bits.
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
from dsml_tpu_torch.ops.collectives import _avg, _hops, ring_pass
from dsml_tpu_torch.utils.hash32 import M32, mix32, mul32

__all__ = [
    "QuantScheme",
    "QuantizedTensor",
    "QuantizedWeight",
    "compressed_all_reduce",
    "compressed_checkpoint",
    "compressed_gather_wire_bytes",
    "default_qblock",
    "dequantize_int8",
    "dequantize_kv_rows",
    "dequantize_weight_blocks",
    "get_scheme",
    "kv_row_bytes",
    "pack_int4",
    "quant_algorithm_for",
    "quantize_int8",
    "quantize_kv_rows",
    "quantize_roundtrip",
    "quantize_weight_blocks",
    "quantized_flat_reduce_scatter",
    "quantized_matmul",
    "quantized_ring_all_reduce",
    "quantized_ring_wire_bytes",
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
        lib.qmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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

    @property
    def wire_bytes_per_block(self) -> int:
        """Bytes one quantized block takes on the wire: its packed values
        and its f32 scale."""
        return self.block * self.bits // 8 + 4


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


_ALGO_FOR_SCHEME = {
    ("int8", "ring"): "q8_ring",
    ("int8", "ring2"): "q8_ring2",
    ("int4", "ring"): "q4_ring",
    ("int4", "ring2"): "q4_ring2",
}
_DEFAULT_QUANT = "int8:ring2"


def _dtype_name(dtype) -> str:
    """The JAX name of a dtype (``"float32"``, ``"bfloat16"``, ...): a
    string as it is, a torch dtype without its ``torch.`` prefix."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def quant_algorithm_for(dtype) -> str:
    """The ``DSML_QUANT`` knob: the quantized sync a gradient of ``dtype``
    (a torch dtype or its JAX name) takes under ``algorithm="quant"``.

    ``SCHEME[:ALGO]`` for every float dtype, or a per-dtype comma list
    ``float32=int8:ring2,bfloat16=int4:ring2`` keyed by the JAX dtype
    name (an unlisted dtype takes the ``default=`` entry, else the
    built-in ``int8:ring2``). SCHEME is int8, int4 or none; ALGO ring or
    ring2 (default ring2). ``none`` syncs that dtype at full precision
    (``"ring"``/``"ring2"``). A malformed value falls back to the default
    rather than failing a training step."""
    key = _dtype_name(dtype)
    raw = os.environ.get("DSML_QUANT", "").strip() or _DEFAULT_QUANT
    if "=" in raw:
        table = {}
        for item in raw.split(","):
            if "=" in item:
                k, _, v = item.partition("=")
                table[k.strip()] = v.strip()
        chosen = table.get(key, table.get("default"))
    else:
        chosen = raw
    scheme, _, algo = (chosen or _DEFAULT_QUANT).partition(":")
    scheme, algo = scheme.strip(), (algo.strip() or "ring2")
    if scheme == "none":
        return algo if algo in ("ring", "ring2") else "ring"
    if scheme not in _SCHEME_TABLE or algo not in ("ring", "ring2"):
        scheme, _, algo = _DEFAULT_QUANT.partition(":")
    return _ALGO_FOR_SCHEME[(scheme, algo)]


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


# The kernel's tiling (csrc/qmm.cu). bf16 x: 128 channels a block, 16 rows
# (the decode regime, m <= 16) or 64 (the chunk regime), K cut into units of
# 32 k and split over the blocks of a cluster (at most 8) where the tiles
# alone leave the card's SMs idle. f32 x: 16 rows × 32 channels, no
# split.
_QMM_TILE_N = 128
_QMM_DECODE_ROWS = 16
_QMM_CHUNK_ROWS = 64
_QMM_FMA_ROWS = 16
_QMM_UNIT_ROWS = {"int4": 16, "int8": 32}  # code rows of a unit (32 k)
_QMM_MIN_UNITS = 2  # a split's fewest units
_QMM_MAX_SPLITS = 8  # a portable cluster
_QMM_BLOCKS_PER_SM = 2
_MAX_GRID_Y = 65535


def _qmm_plan(m: int, n: int, kb: int, nb: int, scheme: str, x_dtype, sms: int) -> tuple[int, int]:
    """(rows of a tile, K splits) of one kernel launch on a card of ``sms``
    SMs. bf16 x: the decode regime (16 rows) for m <= 16, else the chunk
    regime (64); the splits bring the (row tile, 128-channel tile) grid up
    to at most two blocks an SM, each split keeping 2 units or more, at
    most 8. f32 x: 16 rows, one split."""
    if x_dtype != torch.bfloat16:
        return _QMM_FMA_ROWS, 1
    rows = _QMM_DECODE_ROWS if m <= _QMM_DECODE_ROWS else _QMM_CHUNK_ROWS
    units = nb * -(-(kb // 2 if scheme == "int4" else kb) // _QMM_UNIT_ROWS[scheme])
    tiles = -(-n // _QMM_TILE_N) * -(-m // rows)
    splits = min(_QMM_BLOCKS_PER_SM * sms // tiles, units // _QMM_MIN_UNITS, _QMM_MAX_SPLITS)
    return rows, max(splits, 1)


def _qmm_max_rows(x_dtype) -> int:
    """The most rows one launch takes: its row tiles fill at most the grid's y."""
    rows = _QMM_FMA_ROWS if x_dtype != torch.bfloat16 else _QMM_CHUNK_ROWS
    return _MAX_GRID_Y * rows


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
    if x.shape[0] > _qmm_max_rows(x.dtype):
        raise ValueError(f"quantized_matmul supports <= {_qmm_max_rows(x.dtype)} rows of {x.dtype} x, "
                         f"got {x.shape[0]}")


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
        if x.dtype == torch.bfloat16 and (d % 4 or x.data_ptr() % 8):
            # the tensor-core body reads x 4 elements at a time: pad its rows (zeros)
            x = F.pad(x, (0, -d % 4)) if d % 4 else x.clone()
            d = x.shape[1]
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, splits = _qmm_plan(m, n, qwt.block, nb, qwt.scheme, x.dtype, sms)
        _launch("qmm", x.data_ptr(), qwt.qw.data_ptr(), qwt.qs.data_ptr(), out.data_ptr(),
                m, d, n, n_p, qwt.block, nb, int(x.dtype == torch.bfloat16),
                int(qwt.scheme == "int4"), splits, torch.cuda.current_stream(x.device).cuda_stream)
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


def _wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced modulo 2**32 into int32, as int32
    arithmetic wraps."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _leaf_seed(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-leaf seed: the sum of the int32 bitcasts of
    ``x`` in f32, wrapping in int32 — an int32 tensor on ``x``'s device
    (``torch.sum`` of int32 gives int64; the wrap is explicit)."""
    return _wrap_i32(x.float().view(torch.int32).sum())


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


# ---------------------------------------------------------------------------
# compressed gradient communication: the quantized ring schedules and the
# int8 gather
# ---------------------------------------------------------------------------


def _block_quant(blocks: torch.Tensor, scheme: QuantScheme, seed=None):
    """Blockwise absmax quantization of f32 ``[rows, block]`` → (int8
    values, f32 scales ``[rows, 1]``). ``seed=None`` rounds to nearest,
    half to even (the error-feedback pairing: the residual accounts the
    committed rounding exactly); an int32 seed tensor rounds
    ``floor(y + u)`` with ``u`` from :func:`_noise_bits` over the element
    index, unbiased. The scale multiplies by the f32 reciprocal of qmax,
    as XLA compiles the JAX package's ``/ qmax``; ``blocks / scales`` is a
    true division on both sides."""
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scales = torch.clamp_min(amax * (1.0 / scheme.qmax), 1e-12)
    y = blocks / scales
    if seed is None:
        q = torch.round(y)
    else:
        idx = torch.arange(blocks.numel(), device=blocks.device).reshape(blocks.shape)
        q = torch.floor(y + (_noise_bits(seed, idx) >> 8).float() * 2.0 ** -24)
    return torch.clamp(q, -scheme.qmax, scheme.qmax).to(torch.int8), scales


def _to_wire(q: torch.Tensor, scheme: QuantScheme) -> torch.Tensor:
    return pack_int4(q) if scheme.bits == 4 else q


def _from_wire(w: torch.Tensor, scheme: QuantScheme) -> torch.Tensor:
    return unpack_int4(w) if scheme.bits == 4 else w


def _fma(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``acc + q·scales`` (f32 ``acc`` flat, int ``q`` ``[rows, block]``)
    rounded once to f32, as XLA on the CPU fuses the JAX package's
    dequantize-and-add into one multiply-add. In f64 the product is exact
    (an int8 times an f32 needs at most 31 significant bits of the 53);
    the f64 sum then rounds to f32 like the fused operation unless it
    lands exactly on an f32 rounding midpoint, which the bitwise tests
    against the JAX package would show."""
    prod = (q.double() * scales.double()).reshape(-1)[:acc.numel()]
    return (acc.double() + prod).float()


def _padded(flat: torch.Tensor, quantum: int) -> torch.Tensor:
    """``flat`` as f32, zero-padded to a multiple of ``quantum``: a new
    tensor, which the caller may write."""
    size = flat.numel()
    out = torch.zeros(-(-size // quantum) * quantum, dtype=torch.float32, device=flat.device)
    out[:size].copy_(flat.reshape(-1))
    return out


def quantize_roundtrip(flat: torch.Tensor, scheme="int8") -> torch.Tensor:
    """``dequantize(quantize(flat))`` under deterministic rounding: the
    local compression a rank commits when it first ships ``flat``, flat
    f32. The error-feedback residual is ``flat −`` this
    (:func:`_roundtrip_residual`)."""
    sch = get_scheme(scheme)
    size = flat.numel()
    q, scales = _block_quant(_padded(flat, sch.block).view(-1, sch.block), sch)
    return (q.float() * scales).reshape(-1)[:size]


def _roundtrip_residual(flat: torch.Tensor, scheme="int8") -> torch.Tensor:
    """``flat − quantize_roundtrip(flat)`` rounded once (:func:`_fma` with
    the codes negated), as XLA fuses the JAX package's subtraction into
    the dequantization."""
    sch = get_scheme(scheme)
    q, scales = _block_quant(_padded(flat, sch.block).view(-1, sch.block), sch)
    return _fma(flat.float().reshape(-1), -q, scales)


def quantized_ring_wire_bytes(n_elems: int, n_ranks: int, scheme="int8",
                              bidirectional: bool = False) -> int:
    """Per-rank wire bytes of one quantized ring all-reduce: 2(n−1) hops,
    each one padded segment's packed values and f32 block scales, per
    direction."""
    sch = get_scheme(scheme)
    if n_ranks <= 1:
        return 0
    k = 2 if bidirectional else 1
    quantum = k * n_ranks * sch.block
    padded = -(-n_elems // quantum) * quantum
    blocks_per_seg = padded // (k * n_ranks) // sch.block
    return k * 2 * (n_ranks - 1) * blocks_per_seg * sch.wire_bytes_per_block


def compressed_gather_wire_bytes(n_elems: int, n_ranks: int) -> int:
    """Per-rank wire bytes of :func:`compressed_all_reduce`: every rank
    receives the other n−1 ranks' int8 values and f32 block scales."""
    if n_ranks <= 1:
        return 0
    blocks = -(-n_elems // _BLOCK)
    return (n_ranks - 1) * (blocks * _BLOCK + blocks * 4)


def _dither_seed(blocks: torch.Tensor, base: torch.Tensor, rank: int, salt: int) -> torch.Tensor:
    """The stochastic-rounding seed of one hop's chunk, in int32
    arithmetic: the sum of the chunk's int32 bitcasts (it changes with the
    data every step) + ``base`` (the caller's seed · 1_000_003) + rank ·
    7919 + the hop's salt, so no two ranks or hops share a dither. One
    definition for both ring schedules."""
    return _wrap_i32(blocks.view(torch.int32).sum() + base + rank * 7919 + salt)


def _quant_chunk_wire(blocks, scheme: QuantScheme, stochastic: bool, base, rank: int, salt: int):
    """f32 ``[rows, block]`` → (wire values, f32 scales): the one
    quantize-for-the-wire step every hop of both ring schedules takes."""
    seed = _dither_seed(blocks, base, rank, salt) if stochastic else None
    q, scales = _block_quant(blocks, scheme, seed)
    return _to_wire(q, scheme), scales


def _seed_base(seed, device) -> torch.Tensor:
    """``seed · 1_000_003`` as an int64 tensor on ``device`` (wrapped to
    int32 with the terms it is added to)."""
    return _seed_tensor(seed, device).long() * 1_000_003


def quantized_ring_all_reduce(x: torch.Tensor, group, scheme="int8", bidirectional: bool = False,
                              mean: bool = True, stochastic: bool = True, seed=0) -> torch.Tensor:
    """Block-quantized ring all-reduce (SUM, or AVG with ``mean``) of
    ``x`` over ``group``: the 2(n−1)-hop schedule of ``ops.collectives``
    with the quantization inside it. Each scatter-reduce hop quantizes its
    outgoing chunk to ``scheme`` (int8, or int4 packed two to a byte; one
    f32 scale per block), ships the (values, scales) pair as one
    ``ring_pass``, and the receiver dequantizes and accumulates in f32; the
    next hop re-quantizes the partial sum. In the all-gather half the
    owner quantizes its reduced segment once and the hops forward those
    wire bytes untouched, so every rank (the owner too) holds the same
    dequantization: the result is bit-identical across ranks.
    ``bidirectional`` runs two halves in opposite directions (ring2),
    each step's two hops issued together.

    ``stochastic`` dithers each hop's rounding with a seed from the
    chunk's own bits, ``seed`` (an int or an int32 device tensor), the
    rank and the hop; ``stochastic=False`` rounds to nearest, the error-
    feedback pairing, and equals the JAX package bit for bit. The payload
    is zero-padded to a multiple of directions·n·block, so hops stay
    block-aligned; pad lanes quantize to exactly 0 and are sliced off.
    Returns a tensor of ``x``'s shape and type."""
    sch = get_scheme(scheme)
    if not x.is_floating_point():
        raise ValueError(f"quantized ring all-reduce needs a float input, got {x.dtype}")
    n, rank = group.size, group.rank
    if n == 1:
        return x
    signs = (+1, -1) if bidirectional else (+1,)
    k = len(signs)
    size = x.numel()
    flat = _padded(x, k * n * sch.block)
    part = flat.numel() // k
    bufs = [flat[d * part:(d + 1) * part].view(n, part // n) for d in range(k)]
    rows = part // n // sch.block
    base = _seed_base(seed, x.device)

    def q_chunk(chunk, salt):
        return _quant_chunk_wire(chunk.view(rows, sch.block), sch, stochastic, base, rank, salt)

    # scatter-reduce: quantize, ship, dequantize-accumulate, per hop
    for step in range(n - 1):
        sent = [q_chunk(b[(rank - s * step) % n], 2 * step + (s < 0)) for b, s in zip(bufs, signs)]
        for b, s, (wire, sc) in zip(bufs, signs, _hops(sent, signs, group)):
            resident = b[(rank - s * (step + 1)) % n]
            resident.copy_(_fma(resident, _from_wire(wire, sch), sc))
    # all-gather: the owner's wire bytes, forwarded untouched
    carries = []
    for b, s in zip(bufs, signs):
        own = (rank + s) % n
        carries.append(q_chunk(b[own], 1_000 + (s < 0)))
        b[own].copy_(_dequant_wire(*carries[-1], sch))
    for step in range(n - 1):
        carries = _hops(carries, signs, group)
        for b, s, carry in zip(bufs, signs, carries):
            b[(rank - s * step) % n].copy_(_dequant_wire(*carry, sch))
    out = flat[:size]
    if mean:
        out = _avg(out, n)
    return out.view(x.shape).to(x.dtype)


def _dequant_wire(wire, scales, scheme: QuantScheme) -> torch.Tensor:
    """Inverse of :func:`_quant_chunk_wire`, flat f32."""
    return (_from_wire(wire, scheme).float() * scales).reshape(-1)


def quantized_flat_reduce_scatter(flat: torch.Tensor, group, scheme="int8", mean: bool = True,
                                  stochastic: bool = True, seed=0):
    """Quantized ring reduce-scatter of a flat vector: the scatter-reduce
    half of :func:`quantized_ring_all_reduce` alone, with
    ``ops.collectives.flat_reduce_scatter``'s layout. Rank i keeps
    contiguous segment i of the (mean) reduction, f32; returns ``(shard,
    padded)``, ``padded`` the length rounded up to a multiple of the group
    size (not of the block: each hop's chunk is zero-padded to whole
    blocks on its own, so the shard length is the full-precision path's).
    Virtual rank r − 1 runs the forward schedule, so ownership lands on
    segment r."""
    sch = get_scheme(scheme)
    if not flat.is_floating_point():
        raise ValueError(f"quantized reduce-scatter needs a float input, got {flat.dtype}")
    n, rank = group.size, group.rank
    x = _padded(flat, n)
    padded = x.numel()
    if n == 1:
        return x, padded
    seg = padded // n
    rows = -(-seg // sch.block)
    buf = x.view(n, seg)
    base = _seed_base(seed, flat.device)
    vr = (rank - 1) % n
    for step in range(n - 1):
        chunk = _padded(buf[(vr - step) % n], rows * sch.block).view(rows, sch.block)
        wire, sc = ring_pass(_quant_chunk_wire(chunk, sch, stochastic, base, rank, step), group)
        resident = buf[(vr - step - 1) % n]
        resident.copy_(_fma(resident, _from_wire(wire, sch), sc))
    shard = buf[rank]
    return (_avg(shard, n) if mean else shard.clone()), padded


def compressed_all_reduce(x: torch.Tensor, group, seed=0, mean: bool = True) -> torch.Tensor:
    """8-bit all-reduce: :func:`quantize_int8` on this rank (kernel 8 on a
    CUDA tensor), every rank's int8 values and scales gathered over n − 1
    ring passes (the pair as one payload), then dequantized and summed in
    f32, times 1/n for the mean, cast back to ``x``'s type. The rounding
    seed is ``seed · 1_000_003 + rank`` in int32 arithmetic, a device
    tensor (no host sync), so the ranks' noise differs; the result is
    unbiased and the same on every rank."""
    n, rank = group.size, group.rank
    if n == 1:
        return x
    rank_seed = _wrap_i32(_seed_base(seed, x.device) + rank)
    qt = quantize_int8(x.contiguous(), rank_seed)
    vals = qt.values.new_empty((n, *qt.values.shape))
    scales = qt.scales.new_empty((n, *qt.scales.shape))
    vals[rank].copy_(qt.values)
    scales[rank].copy_(qt.scales)
    for step in range(n - 1):
        got_v, got_s = ring_pass([vals[(rank - step) % n], scales[(rank - step) % n]], group)
        vals[(rank - step - 1) % n].copy_(got_v)
        scales[(rank - step - 1) % n].copy_(got_s)
    total = (vals.float() * scales).sum(0).reshape(-1)[:qt.size].view(qt.shape)
    if mean:
        total = _avg(total, n)
    return total.to(x.dtype)
