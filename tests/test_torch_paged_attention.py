"""The port's paged attention (``dsml_tpu_torch.ops.paged_attention``) and
the model's paged and per-slot surfaces against the JAX package's.

On CPU tensors ``paged_attention`` runs the kernels' plain version; it is
held to the JAX Pallas kernel run as the JAX suite runs it on the CPU
(``interpret=True, pipeline=False``) over every table shape the batcher
makes — scattered and permuted pages, straddling tails, dead entries at
scratch page 0, a dead slot, GQA, a verify window, a chunk, CoW-shared
pages — for all three codecs, at the JAX suite's own tolerance. The model's
surfaces (``decode_step_slots[_paged]``, ``prefill_chunk[_paged]``,
``verify_step[_paged]``) give the JAX logits at f32 from the same weights
and cache state, through both routes of the paged read (the gather and the
kernel's plain version), and write the same quantized bytes."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.ops import paged_attention as jpa
from dsml_tpu.ops.quantization import quantize_kv_rows as jax_quantize_kv_rows
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.ops import paged_attention as tpa
from dsml_tpu_torch.ops.quantization import quantize_kv_rows, unpack_int4

# the JAX suite's tolerance for the kernel against its dense oracle
# (tests/test_paged_attention.py): f32 on both sides, another summation order
TOL = dict(atol=2e-5, rtol=2e-5)
PAGE = 8


def _pool(rng, n_pages, hkv, hd, mode):
    """One layer's pool with random rows in ``init_page_pool``'s layout,
    quantized by the JAX codec, as (jax arrays, torch tensors) of the same
    bytes."""
    k = rng.standard_normal((n_pages, hkv, PAGE, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, PAGE, hd)).astype(np.float32)
    if mode is None:
        layer = {"k": k, "v": v}
    else:
        (kq, ks), (vq, vs) = jax_quantize_kv_rows(jnp.asarray(k), mode), \
            jax_quantize_kv_rows(jnp.asarray(v), mode)
        layer = {"k": np.asarray(kq), "k_s": np.asarray(ks), "v": np.asarray(vq), "v_s": np.asarray(vs)}
    return ({key: jnp.asarray(a) for key, a in layer.items()},
            {key: torch.from_numpy(a.copy()) for key, a in layer.items()})


def _check(q, pools, table, positions, mode):
    jlayer, tlayer = pools
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jlayer, jnp.asarray(table), jnp.asarray(positions), mode,
        interpret=True, pipeline=False))
    got = tpa.paged_attention(torch.from_numpy(q), tlayer, torch.from_numpy(table),
                              torch.from_numpy(positions), mode)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    return got


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_scattered_pages_dead_entries_and_dead_slot_match_jax(mode):
    """Decode over permuted physical pages: depths 21 (straddles page 3), 8
    (exactly one page) and 1, dead entries at scratch page 0, and a dead
    slot (position -1) that returns zeros."""
    rng = np.random.default_rng(0)
    pools = _pool(rng, 12, 2, 8, mode)
    table = np.zeros((4, 4), np.int32)
    table[0, :3] = [7, 2, 10]  # scattered, not monotonic
    table[1, :1] = [5]
    table[2, :1] = [9]
    positions = np.asarray([[20], [7], [0], [-1]], np.int32)
    q = rng.standard_normal((4, 2, 1, 8)).astype(np.float32)
    got = _check(q, pools, table, positions, mode)
    assert (got[3] == 0).all()


def test_gqa_grouped_heads_match_jax():
    """8 query heads over 2 kv heads (rep 4): head h reads kv head h // 4."""
    rng = np.random.default_rng(1)
    pools = _pool(rng, 10, 2, 8, "int4")
    table = np.zeros((2, 4), np.int32)
    table[0, :2] = [3, 8]
    table[1, :3] = [6, 1, 4]
    positions = np.asarray([[13], [22]], np.int32)
    _check(rng.standard_normal((2, 8, 1, 8)).astype(np.float32), pools, table, positions, "int4")


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_verify_window_matches_jax(mode):
    """C = 4 rows per slot at positions start..start+3 (GQA rep 2)."""
    rng = np.random.default_rng(2)
    pools = _pool(rng, 10, 2, 8, mode)
    table = np.zeros((2, 4), np.int32)
    table[0, :3] = [2, 9, 5]
    table[1, :2] = [7, 3]
    positions = (np.asarray([17, 9])[:, None] + np.arange(4)[None, :]).astype(np.int32)
    _check(rng.standard_normal((2, 4, 4, 8)).astype(np.float32), pools, table, positions, mode)


def test_chunk_rows_match_jax():
    """A prefill chunk: one slot, 12 rows at start 5, crossing two pages."""
    rng = np.random.default_rng(3)
    pools = _pool(rng, 6, 2, 8, "int8")
    table = np.asarray([[4, 1, 3, 0]], np.int32)
    positions = (5 + np.arange(12))[None, :].astype(np.int32)
    _check(rng.standard_normal((1, 2, 12, 8)).astype(np.float32), pools, table, positions, "int8")


def test_cow_shared_pages_match_jax():
    """Two slots whose tables name the SAME prefix pages."""
    rng = np.random.default_rng(4)
    pools = _pool(rng, 10, 2, 8, "int4")
    table = np.zeros((2, 4), np.int32)
    table[0, :3] = [4, 6, 2]
    table[1, :3] = [4, 6, 8]
    positions = np.asarray([[18], [21]], np.int32)
    _check(rng.standard_normal((2, 2, 1, 8)).astype(np.float32), pools, table, positions, "int4")


def test_validation_errors_match_jax():
    rng = np.random.default_rng(5)
    jlayer, tlayer = _pool(rng, 4, 2, 8, None)
    t, p = np.zeros((1, 2), np.int32), np.zeros((1, 1), np.int32)
    for q, mode in ((np.zeros((1, 2, 1, 8), np.float32), "int2"),
                    (np.zeros((1, 3, 1, 8), np.float32), None)):
        with pytest.raises(ValueError) as jerr:
            jpa.paged_attention(jnp.asarray(q), jlayer, jnp.asarray(t), jnp.asarray(p), mode,
                                interpret=True)
        with pytest.raises(ValueError) as terr:
            tpa.paged_attention(torch.from_numpy(q), tlayer, torch.from_numpy(t),
                                torch.from_numpy(p), mode)
        assert str(terr.value) == str(jerr.value)


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    q = torch.empty(1, 2, 1, 64, device="meta")
    layer = {"k": torch.empty(4, 2, PAGE, 32, dtype=torch.uint8, device="meta"),
             "v": torch.empty(4, 2, PAGE, 32, dtype=torch.uint8, device="meta"),
             "k_s": torch.empty(4, 2, PAGE, 1, device="meta"),
             "v_s": torch.empty(4, 2, PAGE, 1, device="meta")}
    table = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, layer, table, torch.zeros(1, 1, dtype=torch.int32), "int4")


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_paged_hbm_bytes_match_jax(mode, impl):
    for args in ((4, 16, 16, 12, 64, 100), (16, 64, 16, 12, 64, 451), (2, 8, 8, 2, 128, 3)):
        for kw in ({}, {"n_query_rows": 4, "n_query_heads": 8}):
            assert tpa.paged_hbm_bytes(*args[:5], mode, args[5], impl, **kw) == \
                jpa.paged_hbm_bytes(*args[:5], mode, args[5], impl, **kw)
    assert tpa._paged_row_bytes(64, mode) == jpa._paged_row_bytes(64, mode)
    with pytest.raises(ValueError, match="unknown paged-attention impl"):
        tpa.paged_hbm_bytes(1, 1, 8, 1, 8, mode, 1, "cuda")


def test_routing_knobs(monkeypatch):
    monkeypatch.delenv("DSML_PAGED_ATTN", raising=False)
    monkeypatch.delenv("DSML_PAGED_ATTN_PIPELINE", raising=False)
    # unset: the kernel on the card (None means CUDA), the gather on the CPU
    assert tpa.paged_attn_impl("cpu") == "xla"
    assert tpa.paged_attn_impl("cuda") == tpa.paged_attn_impl(None) == "pallas"
    assert tpa.paged_pipeline("cuda") and tpa.paged_pipeline() and not tpa.paged_pipeline("cpu")
    monkeypatch.setenv("DSML_PAGED_ATTN", "  XLA ")
    assert tpa.paged_attn_impl("cuda") == "xla"
    monkeypatch.setenv("DSML_PAGED_ATTN", "pallas")
    assert tpa.paged_attn_impl("cpu") == "pallas"
    monkeypatch.setenv("DSML_PAGED_ATTN", "triton")  # malformed: the default
    assert tpa.paged_attn_impl("cpu") == "xla"
    monkeypatch.setenv("DSML_PAGED_ATTN_PIPELINE", "off")
    assert not tpa.paged_pipeline("cuda")
    monkeypatch.setenv("DSML_PAGED_ATTN_PIPELINE", "1")
    assert tpa.paged_pipeline("cpu")


def test_smem_is_fixed_by_the_tiles_not_the_page():
    # register regime, int4 at hd 64: a 2-stage ring per warp of one 16-key
    # unit (2·16·32 B of K and V rows + 2·16·4 B of scales) for 4 warps,
    # then the warps' f32 partials (4 warps × 4 rows × (64 + 2) floats)
    assert tpa.paged_smem_bytes(64, "int4") == 4 * 2 * (1024 + 128) + 4 * 4 * 4 * 66
    assert tpa.paged_smem_bytes(64, "int4", pipeline=False) == 4 * 4 * 4 * 66
    # tensor-core regime, int4 at hd 64: a 2-stage ring of 64 keys' raw rows
    # and scales, bf16 q/K/V tiles of 64 × (64 + 8), the 64 keys' scales
    assert tpa.paged_smem_bytes(64, "int4", tensor_cores=True) == \
        2 * (2 * 64 * 32 + 2 * 64 * 4) + 2 * 3 * 64 * 72 + 2 * 64 * 4
    assert tpa.paged_smem_bytes(64, "int4", pipeline=False) < tpa.paged_smem_bytes(64, "int4")
    assert tpa.paged_smem_bytes(128, None, fp_itemsize=4) > tpa.paged_smem_bytes(128, None, fp_itemsize=2)
    assert max(tpa.paged_smem_bytes(hd, m, tensor_cores=tc) for hd in (64, 128)
               for m in (None, "int8", "int4") for tc in (False, True)) < 227 * 1024


# ---------------------------------------------------------------------------
# the kernels' split plan and merge (split-K over the key axis)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_pos,n_keys,keys_per_split", [
    (-1, 1024, 128), (0, 1024, 128), (14, 1024, 128), (15, 1024, 128), (16, 1024, 128),
    (127, 1024, 128), (128, 1024, 128), (255, 1024, 128), (256, 1024, 128), (1022, 1024, 128),
    (1023, 1024, 128), (5000, 1024, 128), (199, 200, 128), (63, 64, 16)])
def test_split_plan_covers_every_live_unit_once(max_pos, n_keys, keys_per_split):
    """The plan's count of splits, contiguous splits of at most k keys that
    start on multiples of k, and every live 16-key unit in exactly one
    split; an all-dead tile gets an empty plan."""
    plan = tpa.split_plan(max_pos, n_keys, keys_per_split)
    live_end = min(max_pos + 1, n_keys) if max_pos >= 0 else 0
    assert len(plan) == -(-live_end // keys_per_split)
    assert [k0 for k0, _ in plan] == list(range(0, live_end, keys_per_split))
    assert all(0 < k1 - k0 <= keys_per_split for k0, k1 in plan)
    assert (plan[-1][1] if plan else 0) == live_end
    keys = [k for k0, k1 in plan for k in range(k0, k1)]
    assert keys == list(range(live_end))  # no key lost or repeated
    units = [u for k0, k1 in plan for u in sorted({k // 16 for k in range(k0, k1)})]
    assert units == list(range(-(-live_end // 16)))
    if max_pos < 0:
        assert plan == []


def test_tile_rows_and_scratch_bytes():
    assert tpa.tile_rows(torch.float32, 1) == tpa.tile_rows(torch.bfloat16, 1) == 1
    assert tpa.tile_rows(torch.bfloat16, 16) == tpa.tile_rows(torch.float32, 256) == 4
    assert tpa.tile_rows(torch.bfloat16, 17) == tpa.tile_rows(torch.bfloat16, 256) == 64
    # decode: 16 slots × 12 heads, one 1-row tile, 8 splits of 128 keys:
    # 192 counters, 192·8 records of 64 + 4 floats
    assert tpa.paged_scratch_bytes(16, 12, 1, 64, 1024, torch.bfloat16) == (768, 4 * 192 * 8 * 68)
    # a 256-row bf16 chunk: 4 tiles of 64 rows; in f32, 64 tiles of 4
    assert tpa.paged_scratch_bytes(1, 12, 256, 64, 1024, torch.bfloat16) == \
        (4 * 48, 4 * 12 * 4 * 8 * 64 * 68)
    assert tpa.paged_scratch_bytes(1, 12, 256, 64, 1024, torch.float32) == \
        (4 * 768, 4 * 12 * 64 * 8 * 4 * 68)
    assert tpa.paged_scratch_bytes(1, 1, 5, 128, 200, torch.float32) == (8, 4 * 2 * 2 * 4 * 132)


# depths (keys) of the split-edge slots: one key, a unit's edge, a split's
# edge and the next split's, the deepest, a dead slot
_EDGE_DEPTHS = [1, 15, 16, 17, 127, 128, 129, 256, 257, 1023, 1024, 0]


def _split_case(rng, case, mode):
    """(q, pools, table, positions, rows) of one split-reference case; the
    page size of each case is its own (16 or 64)."""
    if case.startswith("edges"):
        page = int(case.rsplit("_", 1)[1])
        b, hq, hkv, hd, c = len(_EDGE_DEPTHS), 2, 2, 64, 1
        positions = (np.asarray(_EDGE_DEPTHS) - 1)[:, None].astype(np.int32)
        rows = None
    elif case == "gqa_dead":
        page, b, hq, hkv, hd, c = 16, 4, 8, 2, 128, 1
        positions = np.asarray([[300], [-1], [128], [0]], np.int32)
        rows = None
    elif case == "verify":
        page, b, hq, hkv, hd, c = 16, 3, 4, 2, 64, 4
        positions = (np.asarray([125, 0, 700])[:, None] + np.arange(4)[None, :]).astype(np.int32)
        rows = None
    else:  # a 256-row chunk at 512, in the register regime's or the tensor cores' tiles
        page, b, hq, hkv, hd, c = 16, 1, 2, 2, 64, 256
        positions = (512 + np.arange(256))[None, :].astype(np.int32)
        rows = 64 if case == "chunk_tc_tiles" else None
    n_pt = 1024 // page
    live = [0 if p.max() < 0 else int(p.max()) // page + 1 for p in positions]
    n_pages = 1 + sum(live)
    table = np.zeros((b, n_pt), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    at = 0
    for i, n in enumerate(live):
        table[i, :n] = perm[at:at + n]
        at += n
    k = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32)
    if mode is None:
        layer = {"k": k, "v": v}
    else:
        (kq, ks), (vq, vs) = jax_quantize_kv_rows(jnp.asarray(k), mode), \
            jax_quantize_kv_rows(jnp.asarray(v), mode)
        layer = {"k": np.asarray(kq), "k_s": np.asarray(ks), "v": np.asarray(vq), "v_s": np.asarray(vs)}
    pools = ({key: jnp.asarray(a) for key, a in layer.items()},
             {key: torch.from_numpy(a.copy()) for key, a in layer.items()})
    q = rng.standard_normal((b, hq, c, hd)).astype(np.float32)
    return q, pools, table, positions, rows


@pytest.mark.parametrize("case", ["edges_16", "edges_64", "gqa_dead", "verify", "chunk",
                                  "chunk_tc_tiles"])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_split_reference_matches_jax(mode, case):
    """The kernels' split plan and merge (the plain model
    ``_paged_attention_split_reference``) against the JAX kernel
    (``interpret=True, pipeline=False``) at the file's tolerance: decode at
    the split edges with pages of 16 and 64, GQA at hd 128 with a dead
    slot, a verify window, and a 256-row chunk in the register regime's
    4-row tiles and the tensor cores' 64-row tiles."""
    rng = np.random.default_rng(11)
    q, (jlayer, tlayer), table, positions, rows = _split_case(rng, case, mode)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jlayer, jnp.asarray(table), jnp.asarray(positions), mode,
        interpret=True, pipeline=False))
    got = tpa._paged_attention_split_reference(
        torch.from_numpy(q), tlayer, torch.from_numpy(table), torch.from_numpy(positions), mode,
        rows=rows)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dead = positions.max(1) < 0
    assert (got[torch.from_numpy(dead)] == 0).all()


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (2^-7 of its binade)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_two_term_bf16_p_holds_the_pv_tolerance(mode):
    """The tensor-core regime's p·v: p (value scale folded in) as p_hi =
    bf16(p) plus p_lo = bf16(p - p_hi) against bf16-exact v, each product
    summed in f32, against f32 p·v at the chunk shape (256 rows at 512,
    768 keys, hd 64) and its value range: within one bf16 ulp of the
    output + 1e-4, the tolerance the card holds the kernel to — and closer
    than a single bf16 p."""
    rng = np.random.default_rng(12)
    rows, n_keys, hd = 256, 768, 64
    pos = 512 + np.arange(rows)
    s = torch.from_numpy(rng.standard_normal((rows, hd)).astype(np.float32)) @ \
        torch.from_numpy(rng.standard_normal((hd, n_keys)).astype(np.float32)) * hd ** -0.5
    s = s.masked_fill(torch.arange(n_keys)[None, :] > torch.from_numpy(pos)[:, None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_fin = p.sum(-1, keepdim=True)
    v = torch.from_numpy(rng.standard_normal((n_keys, hd)).astype(np.float32))
    if mode:
        vq, vs = (t[0, 0] for t in quantize_kv_rows(v[None, None], mode))
        v = (unpack_int4(vq) if mode == "int4" else vq).float()
        p = p * vs.reshape(1, n_keys)
    else:
        v = v.bfloat16().float()
    want = (p.double() @ v.double()) / l_fin.double()
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    got = (p_hi @ v + p_lo @ v) / l_fin
    single = (p_hi @ v) / l_fin
    err = (got.double() - want).abs()
    assert bool((err <= _bf16_ulp(want) + 1e-4).all())
    assert err.max().item() < 1e-5
    assert err.max().item() < (single.double() - want).abs().max().item() / 10


# ---------------------------------------------------------------------------
# model surfaces at f32
# ---------------------------------------------------------------------------

# f32 on both sides through two layers (tests/test_torch_generate.py's TOL)
SURF_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights():
    cfg = jgpt2.GPT2Config.tiny()  # max_seq 128, 8 heads, d 64 -> hd 8
    jparams = jgpt2.GPT2(cfg).init(3)
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, jparams, state


def _models(weights, **over):
    cfg, jparams, state = weights
    jmodel = jgpt2.GPT2(dataclasses.replace(cfg, **over))
    tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), **over), device="cpu")
    tmodel.load_state_dict(state)
    return jmodel, jparams, tmodel


@contextlib.contextmanager
def _port_route(impl):
    """DSML_PAGED_ATTN for the port's calls only (the JAX side keeps its
    gather oracle)."""
    old = os.environ.get("DSML_PAGED_ATTN")
    os.environ["DSML_PAGED_ATTN"] = impl
    try:
        yield
    finally:
        if old is None:
            del os.environ["DSML_PAGED_ATTN"]
        else:
            os.environ["DSML_PAGED_ATTN"] = old


def _close(got, want, msg):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SURF_TOL, err_msg=msg)


def _pool_equal(tpool, jpool, quantized):
    """The written pool (or cache) against JAX's: quantized values bit for
    bit; the f32 scales (absmax / qmax of K/V rows that the two packages
    sum in another order) and fp rows at the surface tolerance."""
    for t, j in zip(tpool, jpool):
        for key in t:
            got, want = t[key].numpy(), np.asarray(j[key])
            if quantized and key not in ("k_s", "v_s"):
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, **SURF_TOL, err_msg=key)


def _paged_script():
    """The paged surface calls, in order: two slots on scattered pages,
    each slot's prompt chunk-prefilled (prefill_chunk_paged), three decode
    steps at different depths (decode_step_slots_paged), one verify window
    (verify_step_paged). Items: (surface, table, tokens, start or pos,
    last_index)."""
    table = np.zeros((2, 128 // PAGE), np.int32)
    table[0, :4] = [5, 2, 9, 1]
    table[1, :3] = [11, 3, 7]
    rng = np.random.default_rng(8)
    calls = []
    for s, n in enumerate((13, 6)):
        for start in range(0, n, 8):
            toks = np.zeros((1, 8), np.int32)
            toks[0, : min(8, n - start)] = rng.integers(1, 512, min(8, n - start))
            calls.append(("chunk", table[s:s + 1], toks, start, min(7, n - 1 - start)))
    pos = np.asarray((13, 6), np.int32)
    for _ in range(3):
        calls.append(("decode", table, rng.integers(1, 512, 2).astype(np.int32), pos, None))
        pos = pos + 1
    calls.append(("verify", table, rng.integers(1, 512, (2, 3)).astype(np.int32), pos, None))
    return calls


_JAX_PAGED: dict = {}


def _jax_paged(jmodel, jparams, quant):
    """JAX's logits per call and its final pool, once per codec."""
    if quant not in _JAX_PAGED:
        pool, logits = jmodel.init_page_pool(12, PAGE, quant=quant), []
        surfaces = {"chunk": jmodel.prefill_chunk_paged, "decode": jmodel.decode_step_slots_paged,
                    "verify": jmodel.verify_step_paged}
        for surface, table, toks, at, last in _paged_script():
            kw = {"last_index": last} if surface == "chunk" else {}
            out, pool = surfaces[surface](jparams, pool, jnp.asarray(table), jnp.asarray(toks),
                                          jnp.asarray(at), quant=quant, **kw)
            logits.append(np.asarray(out))
        _JAX_PAGED[quant] = logits, pool
    return _JAX_PAGED[quant]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("quant", ["fp", "int8", "int4"])
def test_paged_surfaces_match_jax(weights, quant, impl):
    """:func:`_paged_script` through both packages: the same logits at
    every call, through the gather ("xla") and the kernel's plain version
    ("pallas"), and the same pool at the end."""
    jmodel, jparams, tmodel = _models(weights)
    q = False if quant == "fp" else quant
    want, jpool = _jax_paged(jmodel, jparams, q)
    tpool = tmodel.init_page_pool(12, PAGE, quant=q)
    surfaces = {"chunk": tmodel.prefill_chunk_paged, "decode": tmodel.decode_step_slots_paged,
                "verify": tmodel.verify_step_paged}
    for i, (surface, table, toks, at, last) in enumerate(_paged_script()):
        kw = {"last_index": last} if surface == "chunk" else {}
        at = at if surface == "chunk" else torch.from_numpy(at)
        with _port_route(impl):
            got, tpool = surfaces[surface](tpool, torch.from_numpy(table),
                                           torch.from_numpy(toks).long(), at, quant=q, **kw)
        assert got.shape == want[i].shape
        _close(got, want[i], f"call {i}: {surface}")
    _pool_equal(tpool, jpool, quantized=quant != "fp")


@pytest.mark.parametrize("kv_quant", [False, "int8", "int4"])
def test_dense_slot_surfaces_match_jax(weights, kv_quant):
    """The dense per-slot surfaces: a batch-2 chunked prefill
    (prefill_chunk), three decode steps at per-slot depths
    (decode_step_slots), one verify window (verify_step); the quantized
    cache's bytes equal JAX's."""
    jmodel, jparams, tmodel = _models(weights, kv_quant=kv_quant)
    jcache, tcache = jmodel.init_cache(2), tmodel.init_cache(2)
    rng = np.random.default_rng(9)
    for start in (0, 8):
        toks = rng.integers(1, 512, (2, 8)).astype(np.int32)
        want, jcache = jmodel.prefill_chunk(jparams, jcache, jnp.asarray(toks), start, last_index=5)
        got, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks).long(), start,
                                           last_index=5)
        _close(got, want, f"chunk at {start}")
    pos = np.asarray([16, 13], np.int32)  # slot 1 rewinds: rows 13.. get overwritten
    for step in range(3):
        toks = rng.integers(1, 512, 2).astype(np.int32)
        want, jcache = jmodel.decode_step_slots(jparams, jcache, jnp.asarray(toks), jnp.asarray(pos))
        got, tcache = tmodel.decode_step_slots(tcache, torch.from_numpy(toks).long(),
                                               torch.from_numpy(pos))
        _close(got, want, f"decode step {step}")
        pos = pos + 1
    toks = rng.integers(1, 512, (2, 4)).astype(np.int32)
    want, jcache = jmodel.verify_step(jparams, jcache, jnp.asarray(toks), jnp.asarray(pos))
    got, tcache = tmodel.verify_step(tcache, torch.from_numpy(toks).long(), torch.from_numpy(pos))
    assert got.shape == (2, 4, 512)
    _close(got, want, "verify")
    _pool_equal(tcache, jcache, quantized=bool(kv_quant))


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_prefill_and_decode_step_match_jax(weights, kv_quant):
    """Whole-prompt prefill into a quantized cache (exact attention, stored
    quantized) and the shared-position decode step over it."""
    jmodel, jparams, tmodel = _models(weights, kv_quant=kv_quant)
    toks = np.random.default_rng(10).integers(1, 512, (2, 12)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(toks[:, :9]))
    got, tcache = tmodel.prefill(torch.from_numpy(toks[:, :9]).long())
    _close(got, want, "prefill")
    for pos in range(9, 12):
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]), pos)
        got, tcache = tmodel.decode_step(tcache, torch.from_numpy(toks[:, pos]).long(), pos)
        _close(got, want, f"decode at {pos}")
    _pool_equal(tcache, jcache, quantized=True)
