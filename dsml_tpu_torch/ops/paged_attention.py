"""Paged attention: the hand-written CUDA kernels ``csrc/paged_attn.cu``
behind the counterpart of ``dsml_tpu/ops/paged_attention.py``'s
``paged_attention``.

The gather path of the model (``GPT2._paged_attn_inputs``) gathers
``pool[page_table]`` into a dense ``[b, H, max_seq, hd]`` view per layer,
whatever the slots' depths. The kernels read the pool through the table
instead: int4 nibbles and int8 codes are unpacked in the kernel, the
per-row scales folded in after q·k and into p, and keys past a row tile's
largest query position are never read. Query heads group over their kv
head (head h reads kv head h // rep), so one kernel serves GPT-2 (rep = 1)
and GQA. The mask is ``key_pos <= query_pos``, the one mask of all three
paged serving surfaces (decode, chunked prefill, verify).

The kernels split the key axis (flash-decoding): each (slot, kv head, row
tile)'s live keys are cut into splits of :data:`KEYS_PER_SPLIT` keys
(:func:`split_plan`, a function of the positions only), one thread block
per split, and the last block of a tile to finish merges the splits'
(m, l, acc) in split order. Row tiles are 1 or 4 rows in the register
regime (f32 queries, and bf16 queries with at most 16 rows per kv head:
decode, the verify window, GQA) and 64 rows on the tensor cores (bf16
queries, prefill chunks) (:func:`tile_rows`). Scratch for the partials and
the arrival counters is cached per device and stream
(:func:`paged_scratch_bytes`), so a call allocates only its output.

Two kernels, one fold: ``paged_attn_kernel`` (the TPU's single-buffer
``_kernel``) reads the units of its split with plain loads;
``paged_attn_pipelined_kernel`` (the TPU's ``_pipelined_kernel``) stops at
the live depth and copies the next unit with ``cp.async`` while the current
one folds. They pass the same bytes through the same device functions in
the same order, so their outputs are bit-identical. :func:`paged_pipeline`
picks one (``DSML_PAGED_ATTN_PIPELINE``, on by default for CUDA tensors).

On CUDA tensors :func:`paged_attention` launches a kernel or raises; on CPU
tensors it runs :func:`_paged_attention_reference`, the plain PyTorch
version of the same function (gather, fold the scales in the kernel's
order, mask, softmax in f32), which the tests compare with the JAX kernel
and ``chip_smoke.py`` compares with both CUDA kernels;
:func:`_paged_attention_split_reference` is the plain model of the split
plan and the merge, for the tests. There is no fallback from one to the
other, and no shared-memory budget guard: the kernels' shared memory is
fixed by their own tiles (:func:`paged_smem_bytes`), not by the page size,
so every page size that divides ``max_seq`` launches. The model's choice
between the kernel and its gather path is :func:`paged_attn_impl`
(``DSML_PAGED_ATTN``), an explicit choice.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from dsml_tpu_torch.ops import _build
from dsml_tpu_torch.ops.quantization import kv_row_bytes, unpack_int4

__all__ = [
    "KEYS_PER_SPLIT",
    "paged_attention",
    "paged_attn_impl",
    "paged_hbm_bytes",
    "paged_pipeline",
    "paged_smem_bytes",
    "paged_scratch_bytes",
    "split_plan",
    "tile_rows",
]

_NEG_INF = -1e30
_MAX_FLOOR = -1e20  # running-max floor: a fully masked row gives exp(-1e30 + 1e20) = 0
_HEAD_DIMS = (64, 128)
_MAX_GRID = 65535  # kv heads × row tiles and slots are the kernel's grid y and z
# the kernels' tiles (csrc/paged_attn.cu): keys per split, per fold unit and
# per tensor-core step; rows of a tile in each regime; warps of a block
KEYS_PER_SPLIT = 128
_UNIT_KEYS = 16
_TC_KEYS = 64
_TC_ROWS = 64
_REG_ROWS = 4
_WARPS = 4
_POOL_KIND = {None: 0, "int8": 1, "int4": 2}

# Launches of each CUDA kernel, counted where it launches. chip_smoke.py
# zeroes them before driving the main path and reads them after.
paged_attn_launches = 0
paged_attn_pipelined_launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attn")
    lib.paged_attn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.paged_attn.restype = ctypes.c_int
    lib.paged_attn_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attn_smem_bytes.restype = ctypes.c_longlong
    lib.paged_attn_scratch_bytes.argtypes = [ctypes.c_int] * 7
    lib.paged_attn_scratch_bytes.restype = ctypes.c_longlong
    lib.paged_attn_error_string.argtypes = [ctypes.c_int]
    lib.paged_attn_error_string.restype = ctypes.c_char_p
    return lib


def _device_type(device) -> str:
    return torch.device("cuda" if device is None else device).type


def paged_attn_impl(device=None) -> str:
    """The model's paged-attention route: ``DSML_PAGED_ATTN`` ∈ {"pallas",
    "xla"}. "pallas" names the hand-written kernel (:func:`paged_attention`),
    "xla" the gather path. Unset or malformed: the kernel for tensors on
    ``device`` = CUDA (``None`` means CUDA), the gather on the CPU. Read at
    every call."""
    raw = os.environ.get("DSML_PAGED_ATTN", "").strip().lower()
    if raw in ("pallas", "xla"):
        return raw
    return "pallas" if _device_type(device) == "cuda" else "xla"


def paged_pipeline(device=None) -> bool:
    """The prefetch knob: ``DSML_PAGED_ATTN_PIPELINE`` ∈ {"1"/"on"/"true",
    "0"/"off"/"false"}; unset or malformed means the pipelined kernel for
    CUDA tensors (``device`` ``None`` means CUDA). Read at every call."""
    raw = os.environ.get("DSML_PAGED_ATTN_PIPELINE", "").strip().lower()
    if raw in ("1", "on", "true"):
        return True
    if raw in ("0", "off", "false"):
        return False
    return _device_type(device) == "cuda"


def paged_smem_bytes(head_dim: int, mode: str | None, pipeline: bool = True,
                     fp_itemsize: int = 4, tensor_cores: bool = False) -> int:
    """Dynamic shared memory of one kernel launch, in bytes — the
    counterpart of the JAX ``paged_vmem_bytes``. It depends on the head
    dimension, the pool's codec (``fp_itemsize`` is the fp pool's element
    size), the regime (``tensor_cores``: bf16 queries in 64-row tiles) and
    the pipelining, never on the page size: keys stream through in units.
    Register regime: a 2-stage ring per warp of one 16-key unit's raw K and
    V rows and scales (pipelined), and the warps' f32 partials (4 warps × 4
    rows × (hd + 2)). Tensor-core regime: a 2-stage ring of 64 keys' raw
    rows and scales (pipelined), bf16 q, K and V tiles of 64 rows × (hd + 8)
    and the 64 keys' two f32 scales."""
    width = head_dim // 2 if mode == "int4" else head_dim
    row = width * (1 if mode else fp_itemsize)
    if tensor_cores:
        stage = 2 * _TC_KEYS * row + 2 * _TC_KEYS * 4
        tiles = 2 * 3 * _TC_ROWS * (head_dim + 8) + 2 * _TC_KEYS * 4
        return (2 * stage if pipeline else 0) + tiles
    stage = 2 * _UNIT_KEYS * row + 2 * _UNIT_KEYS * 4
    merge = 4 * _WARPS * _REG_ROWS * (head_dim + 2)
    return (2 * _WARPS * stage if pipeline else 0) + merge


def tile_rows(q_dtype, n_rows: int) -> int:
    """Query rows of one row tile for ``n_rows`` = rep·C rows per kv head:
    64 on the tensor cores (bf16 queries, more than 16 rows), else 1 (one
    row) or 4 — the kernels' choice."""
    if q_dtype == torch.bfloat16 and n_rows > 16:
        return _TC_ROWS
    return 1 if n_rows == 1 else _REG_ROWS


def split_plan(max_pos: int, n_keys: int,
               keys_per_split: int = KEYS_PER_SPLIT) -> list[tuple[int, int]]:
    """The live splits of one row tile whose largest query position is
    ``max_pos``, over a table of ``n_keys`` keys: ``[(first key, end key)]``
    of each, in split order. Split s covers keys [s·k, s·k + k) up to the
    last live key, min(max_pos, n_keys - 1); a tile whose rows are all dead
    (``max_pos < 0``) has none. A function of the positions only, as in the
    kernels: both kernels and every call use the same plan."""
    if max_pos < 0:
        return []
    live_end = min(max_pos + 1, n_keys)
    return [(k0, min(k0 + keys_per_split, live_end)) for k0 in range(0, live_end, keys_per_split)]


def paged_scratch_bytes(b: int, n_kv_head: int, n_rows: int, head_dim: int, n_keys: int,
                        q_dtype) -> tuple[int, int]:
    """Bytes of scratch one kernel call needs (the C side's
    ``paged_attn_scratch_bytes``): (an int32 arrival counter per (slot, kv
    head, row tile), an f32 partial — acc, m, l, padded to hd + 4 — per
    (slot, kv head, row tile, split, row))."""
    rows = tile_rows(q_dtype, n_rows)
    n_tiles = -(-n_rows // rows)
    n_splits = -(-n_keys // KEYS_PER_SPLIT)
    return (4 * b * n_kv_head * n_tiles,
            4 * b * n_kv_head * n_tiles * n_splits * rows * (head_dim + 4))


# Scratch of the kernels, per (device index, stream): int32 counters that
# every launch leaves at zero, and the f32 partials, in buffers of their
# own (a call's partials never cover another's counters). Each only grows
# (the counters as a new zeroed buffer); launches on one stream run in
# order, so they may share them.
_SCRATCH: dict[tuple[int, int], list[torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, need: tuple[int, int]) -> list[torch.Tensor]:
    bufs = _SCRATCH.setdefault((device.index, stream), [None, None])
    if bufs[0] is None or bufs[0].numel() < need[0]:
        bufs[0] = torch.zeros(max(need[0], 1 << 16), dtype=torch.uint8, device=device)
    if bufs[1] is None or bufs[1].numel() < need[1]:
        bufs[1] = torch.empty(max(need[1], 1 << 22), dtype=torch.uint8, device=device)
    return bufs


def _group_positions(positions, b, rep, c):
    """[b, C] positions → [b, rep·C] int32, one per grouped query row (row
    r·C + j of kv head h is query head h·rep + r at window row j)."""
    pos = torch.as_tensor(positions).to(torch.int32)
    return torch.broadcast_to(pos[:, None, :], (b, rep, c)).reshape(b, rep * c)


def _paged_attention_reference(q, pool_layer, page_table, positions, mode):
    """Plain PyTorch version of the kernels: gather the table's pages into
    a dense view, scores in f32 times hd^-½ and then the key scales, mask
    ``key_pos <= query_pos`` to -1e30, max floored at -1e20, p times the
    value scales after its sum, out = p·v / max(l, 1e-30), cast to q's
    type — the kernels' numeric edges, so a dead slot returns zeros."""
    b, hq, c, hd = q.shape
    hkv = pool_layer["k"].shape[1]
    rep = hq // hkv
    table = page_table.long()

    def gather(arr):  # [P, hkv, page, x] -> [b, hkv, n_pt·page, x]
        t = arr[table]
        return t.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, arr.shape[-1])

    k, v = gather(pool_layer["k"]), gather(pool_layer["v"])
    if mode == "int4":
        k, v = unpack_int4(k), unpack_int4(v)
    qg = q.float().reshape(b, hkv, rep * c, hd)
    s = (qg @ k.float().transpose(-1, -2)) * hd ** -0.5
    if mode:
        s = s * gather(pool_layer["k_s"]).transpose(-1, -2)
    posq = _group_positions(positions, b, rep, c).to(q.device)
    key_pos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(key_pos[None, None, None, :] > posq[:, None, :, None], _NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(_MAX_FLOOR)
    p = torch.exp(s - m)
    l_fin = p.sum(-1, keepdim=True).clamp_min(1e-30)
    if mode:
        p = p * gather(pool_layer["v_s"]).transpose(-1, -2)
    out = (p @ v.float()) / l_fin
    return out.reshape(b, hq, c, hd).to(q.dtype)


def _paged_attention_split_reference(q, pool_layer, page_table, positions, mode,
                                     keys_per_split: int = KEYS_PER_SPLIT, rows: int | None = None):
    """Plain PyTorch model of the kernels' split plan and merge, for the
    tests: per (slot, kv head, row tile of ``rows`` rows; :func:`tile_rows`
    by default) the live splits of :func:`split_plan` each give a partial
    (m = max(scores, -1e20), l = Σp, acc = (p · value scales) @ v) in f32,
    and the merge rescales them by exp(m_i - m) in split order, sums and
    divides by max(l, 1e-30). A tile with no live split returns zeros. The
    same function as :func:`_paged_attention_reference`, in the kernels'
    order of operations."""
    b, hq, c, hd = q.shape
    hkv, page_size = pool_layer["k"].shape[1], pool_layer["k"].shape[2]
    rep = hq // hkv
    g = rep * c
    n_keys = page_table.shape[1] * page_size
    table = page_table.long()

    def gather(arr):  # [P, hkv, page, x] -> [b, hkv, n_keys, x] f32
        t = arr[table]
        return t.permute(0, 2, 1, 3, 4).reshape(b, hkv, n_keys, arr.shape[-1])

    k, v = gather(pool_layer["k"]), gather(pool_layer["v"])
    if mode == "int4":
        k, v = unpack_int4(k), unpack_int4(v)
    k, v = k.float(), v.float()
    ks = gather(pool_layer["k_s"])[..., 0] if mode else None
    vs = gather(pool_layer["v_s"])[..., 0] if mode else None
    qg = q.float().reshape(b, hkv, g, hd)
    posq = _group_positions(positions, b, rep, c).to(q.device).long()
    rows = tile_rows(q.dtype, g) if rows is None else rows
    out = torch.zeros(b, hkv, g, hd, device=q.device)
    for bi in range(b):
        for r0 in range(0, g, rows):
            pos = posq[bi, r0:r0 + rows]  # [R]
            parts = []
            for k0, k1 in split_plan(int(pos.max()), n_keys, keys_per_split):
                s = (qg[bi, :, r0:r0 + rows] @ k[bi, :, k0:k1].transpose(-1, -2)) * hd ** -0.5
                if mode:
                    s = s * ks[bi, :, None, k0:k1]
                key_pos = torch.arange(k0, k1, device=q.device)
                s = s.masked_fill(key_pos[None, None, :] > pos[None, :, None], _NEG_INF)
                m = s.amax(-1, keepdim=True).clamp_min(_MAX_FLOOR)
                p = torch.exp(s - m)
                l_i = p.sum(-1, keepdim=True)
                if mode:
                    p = p * vs[bi, :, None, k0:k1]
                parts.append((m, l_i, p @ v[bi, :, k0:k1]))
            if not parts:
                continue
            m = torch.stack([m_i for m_i, _, _ in parts]).amax(0)
            l_sum, acc = torch.zeros_like(m), 0.0
            for m_i, l_i, a_i in parts:
                f = torch.exp(m_i - m)
                l_sum = l_sum + l_i * f
                acc = acc + a_i * f
            out[bi, :, r0:r0 + rows] = acc / l_sum.clamp_min(1e-30)
    return out.reshape(b, hq, c, hd).to(q.dtype)


def _check_kernel_inputs(q, pool_layer, table, mode) -> None:
    k, v = pool_layer["k"], pool_layer["v"]
    b, hq, c, hd = q.shape
    n_pages, hkv, page_size, width = k.shape
    tensors = [q, table, *pool_layer.values()]
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(
            "paged_attention needs q, the table and the pool on one CUDA device, got "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention takes float32 or bfloat16 queries, got {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_attention supports head_dim in {_HEAD_DIMS}, got {hd}")
    want = {None: (q.dtype, hd), "int8": (torch.int8, hd), "int4": (torch.uint8, hd // 2)}[mode]
    if (k.dtype, width) != want or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(
            f"a {mode or 'fp'} pool for {q.dtype} queries at head_dim {hd} holds {want[0]} rows "
            f"of width {want[1]}; got k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}"
        )
    if mode and any(pool_layer[s].shape != (n_pages, hkv, page_size, 1)
                    or pool_layer[s].dtype != torch.float32 for s in ("k_s", "v_s")):
        raise ValueError(f"a {mode} pool needs f32 scales k_s/v_s [{n_pages}, {hkv}, {page_size}, 1]")
    for name, t in pool_layer.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention needs a contiguous, 16-byte aligned pool; {name!r} is not")
    if table.ndim != 2 or table.shape[0] != b:
        raise ValueError(f"page_table must be [b={b}, n_pt], got {tuple(table.shape)}")
    g = hq // hkv * c
    n_tiles = -(-g // tile_rows(q.dtype, g))
    if b > _MAX_GRID or hkv * n_tiles > _MAX_GRID:
        raise ValueError(f"paged_attention supports <= {_MAX_GRID} slots and kv heads × row tiles, "
                         f"got {b}, {hkv} × {n_tiles}")


def paged_attention(q, pool_layer: dict, page_table, positions, mode: str | None,
                    pipeline: bool | None = None) -> torch.Tensor:
    """Attention of ``q`` [b, hq, C, hd] straight off one layer's page pool
    — no dense ``[b, H, S, hd]`` view. ``pool_layer`` holds ``k``/``v``
    [P, hkv, page_size, hd or hd/2] plus ``k_s``/``v_s`` [P, hkv,
    page_size, 1] f32 when quantized (``GPT2.init_page_pool``'s layout);
    ``page_table`` [b, n_pt] int32 names each slot's physical pages (dead
    slots and entries at scratch page 0); ``positions`` [b, C] are the
    query rows' global positions, and key_pos <= query_pos is the mask.
    ``mode`` ∈ {None, "int8", "int4"} is the pool codec. Returns [b, hq, C,
    hd] in q's type.

    ``pipeline`` picks the kernel (None: :func:`paged_pipeline`): True the
    cp.async-pipelined one, False the single-buffer one; their outputs are
    bit-identical. CUDA tensors launch it on the current stream (no
    synchronisation) or raise; CPU tensors run the plain version."""
    if mode not in (None, "int8", "int4"):
        raise ValueError(f"unknown page quant mode {mode!r}")
    b, hq, c, hd = q.shape
    n_pages, hkv, page_size, _ = pool_layer["k"].shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not grouped by kv heads {hkv}")
    table = torch.as_tensor(page_table)
    if all(t.device.type == "cpu" for t in (q, table, *pool_layer.values())):
        return _paged_attention_reference(q, pool_layer, table, positions, mode)
    table = table.to(torch.int32).contiguous()
    _check_kernel_inputs(q, pool_layer, table, mode)
    if pipeline is None:
        pipeline = paged_pipeline(q.device)
    g = hq // hkv * c
    qg = q.reshape(b, hkv, g, hd).contiguous()
    pos = torch.as_tensor(positions)
    if pos.shape != (b, c):
        pos = torch.broadcast_to(pos, (b, c))
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(b, hkv, g, hd, dtype=q.dtype, device=q.device)
    k, v = pool_layer["k"], pool_layer["v"]
    ks, vs = (pool_layer["k_s"].data_ptr(), pool_layer["v_s"].data_ptr()) if mode else (None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count, part = _scratch(q.device, stream,
                           paged_scratch_bytes(b, hkv, g, hd, table.shape[1] * page_size, q.dtype))
    lib = _lib()
    err = lib.paged_attn(
        qg.data_ptr(), pos.data_ptr(), k.data_ptr(), v.data_ptr(), ks, vs, table.data_ptr(),
        out.data_ptr(), count.data_ptr(), count.numel(), part.data_ptr(), part.numel(), b, hkv, g, c, hd, page_size, table.shape[1],
        int(q.dtype == torch.bfloat16), _POOL_KIND[mode], int(bool(pipeline)), hd ** -0.5, stream,
    )
    if err:
        raise RuntimeError(f"paged_attn launch failed: {lib.paged_attn_error_string(err).decode()}")
    global paged_attn_launches, paged_attn_pipelined_launches
    if pipeline:
        paged_attn_pipelined_launches += 1
    else:
        paged_attn_launches += 1
    return out.reshape(b, hq, c, hd)


def paged_hbm_bytes(
    n_slots: int,
    n_pt: int,
    page_size: int,
    n_kv_head: int,
    head_dim: int,
    mode: str | None,
    live_pages: int,
    impl: str,
    n_query_rows: int = 1,
    n_query_heads: int | None = None,
) -> int:
    """Device bytes ONE layer's paged-attention read moves per decode tick,
    counted from the program's structure — the JAX package's accounting,
    integer for integer. ``impl="xla"``: the gather reads one page per
    table entry of every slot, writes the dense view and reads it back.
    ``impl="pallas"``: the kernel reads the ``live_pages`` live table
    entries (summed over slots) once per kv head, plus a scratch page per
    slot as the worst case of a dead-entry tail. Query and output bytes (f32,
    per query head) ride both."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    payload_row, scale_row = _paged_row_bytes(head_dim, mode)
    row = payload_row + scale_row  # one position's K + V + both scales
    page_bytes = n_kv_head * page_size * row
    hq = n_kv_head if n_query_heads is None else n_query_heads
    qo_bytes = 2 * n_slots * hq * n_query_rows * head_dim * 4
    if impl == "pallas":
        return (live_pages + n_slots) * page_bytes + qo_bytes
    gathered = n_slots * n_pt * page_bytes
    dense_row = 2 * (head_dim + 4) if mode else 2 * 4 * head_dim
    dense = n_slots * n_pt * page_size * n_kv_head * dense_row
    return gathered + 2 * dense + qo_bytes


def _paged_row_bytes(head_dim: int, mode: str | None) -> tuple[int, int]:
    """(payload, scale) bytes one POSITION moves through a paged read: its
    K and V rows, and their two f32 scales when quantized. The sum is
    ``2 * kv_row_bytes(head_dim, mode)``."""
    scale_row = 8 if mode else 0
    payload_row = 2 * kv_row_bytes(head_dim, mode) - scale_row
    return payload_row, scale_row
