"""The port's context-parallel ring (``dsml_tpu_torch.ops.ring_attention``,
``ops.collectives.ring_pass``, ``ops.flash.flash_stream_hop``) against the
JAX package's, on the CPU in f32.

The port's ranks are processes: each module-scoped fixture spawns one ring
(gloo, rendezvous through a file under ``tmp_path``) that runs every case
once and saves its shard of the results; the tests then assemble the
shards and compare them with the JAX ring on the conftest's virtual CPU
mesh. The JAX oracle is the UNFUSED ring (``fused=None``): the JAX suite
pins the fused schedules bit-identical to it, and its own ``dma`` legs
cannot run on this jax. On CPU tensors kernel 4's wrapper runs its plain
version (``_flash_stream_reference``); the CUDA kernel is held to that
version on the card by ``chip_smoke.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dsml_tpu.ops import collectives as jcollectives
from dsml_tpu.ops import ring_attention as jring
from dsml_tpu.ops.attention import attention as jax_attention
from dsml_tpu.ops.flash import flash_attention_lse as jax_flash_attention_lse
from dsml_tpu_torch.ops import collectives as tcollectives
from dsml_tpu_torch.ops import flash as tflash
from dsml_tpu_torch.ops import ring_attention as tring

# the JAX suite's tolerances (tests/test_ring_attention.py): forward against
# the unfused ring and dense attention; backward between schedules and
# against dense attention
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_SCHEDULE_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_DENSE_TOL = dict(rtol=2e-4, atol=2e-5)
# sequence lengths: odd per-rank lengths (66/2 = 33, 52/4 = 13) keep the
# kernels' ragged edges load-bearing; zigzag needs 2·cp stripes (13 rows each)
S_CONTIGUOUS = {2: 66, 4: 52}
S_ZIGZAG = {2: 52, 4: 104}
SCHEDULES = (None, "sendahead", "dma")
LAYOUTS = ("contiguous", "zigzag")


def _qkv(s, seed, d=16, h=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, s, d)).astype(np.float32) for _ in range(3)]


def _case_inputs(cp, layout):
    """(q, k, v) in global row order and the row permutation the layout
    shards (identity for contiguous)."""
    s = S_CONTIGUOUS[cp] if layout == "contiguous" else S_ZIGZAG[cp]
    perm = np.arange(s) if layout == "contiguous" else tring.zigzag_indices(cp, s)
    return _qkv(s, seed=cp * 7 + s), perm


def _ring_worker(rank, cp, tmp):
    """One rank: every case of the module, its shard of each result saved
    to ``tmp/rank{rank}.pt``."""
    torch.set_num_threads(1)
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(dp=1, cp=cp), rank, cp, os.path.join(tmp, "rendezvous"), "cpu")
    group = mesh.group("cp")
    res = {}
    for layout in LAYOUTS:
        (q, k, v), perm = _case_inputs(cp, layout)
        n = len(perm) // cp
        rows = perm[rank * n:(rank + 1) * n]
        for causal in (True, False):
            for fused in SCHEDULES:
                shard = [torch.from_numpy(t[:, :, rows]).requires_grad_() for t in (q, k, v)]
                out = tring.ring_attention(*shard, group, causal, layout, fused)
                res[("fwd", layout, causal, fused)] = out.detach()
                if causal:
                    torch.tanh(out).sum().backward()
                    res[("grad", layout, fused)] = [t.grad for t in shard]
    x = torch.tensor([float(rank)])
    res["pass"] = {sign: tcollectives.ring_pass(x, group, sign) for sign in (+1, -1)}
    res["pass_tuple"] = tcollectives.ring_pass((x, 2 * x), group, +1)
    (q, k, v), _ = _case_inputs(cp, "contiguous")
    n = q.shape[2] // cp
    kv = [torch.from_numpy(t[:, :, rank * n:(rank + 1) * n]) for t in (k, v)]
    q_shard = torch.from_numpy(q[:, :, rank * n:(rank + 1) * n])
    # the pair at the shard's own offsets; pred false for −1 (the skip identity)
    res["hop"] = {sign: tflash.flash_stream_hop(q_shard, *kv, sign > 0, group, sign, True,
                                                rank * n, rank * n) for sign in (+1, -1)}
    if cp == 2:
        model = GPT2(GPT2Config.tiny(), device="cpu").init(9)
        tokens, targets = _gpt2_batch()
        s = tokens.shape[1] // cp
        cols = slice(rank * s, (rank + 1) * s)
        loss = model.loss(torch.from_numpy(tokens[:, cols]).long(),
                          torch.from_numpy(targets[:, cols]).long(), attn_impl="ring2",
                          sp_group=group).detach()
        dist.all_reduce(loss)
        res["gpt2_loss"] = loss / cp
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _gpt2_batch():
    rng = np.random.default_rng(10)
    x = rng.integers(0, 512, (4, 128)).astype(np.int32)
    return x, np.roll(x, -1, 1)


def _spawn(cp, tmp):
    mp.spawn(_ring_worker, args=(cp, str(tmp)), nprocs=cp, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(cp)]


@pytest.fixture(scope="module")
def ring2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("cp2"))


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("cp4"))


@pytest.fixture
def ring(request):
    return request.getfixturevalue(f"ring{request.param}")


def _assemble(ranks, key, cp, layout):
    """The shards of ``key`` concatenated along the sequence and put back
    in global row order."""
    _, perm = _case_inputs(cp, layout)
    got = torch.cat([r[key] for r in ranks], dim=2).numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return got[:, :, inv]


def _jax_ring(cp, layout, causal, q, k, v, devices8):
    mesh = Mesh(np.asarray(devices8[:cp]).reshape(cp), ("cp",))
    spec = P(None, None, "cp", None)
    fn = jax.jit(jax.shard_map(
        lambda q, k, v: jring.ring_attention(q, k, v, "cp", causal, layout=layout, fused=None),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
    _, perm = _case_inputs(cp, layout)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return np.asarray(fn(*(jnp.asarray(t[:, :, perm]) for t in (q, k, v))))[:, :, inv]


@pytest.mark.parametrize("ring,layout,causal", [
    (2, "contiguous", True), (2, "contiguous", False), (4, "contiguous", True),
    (4, "contiguous", False), (2, "zigzag", True), (4, "zigzag", True),
], indirect=["ring"])
def test_ring_forward_matches_jax_unfused_ring(ring, layout, causal, devices8):
    cp = len(ring)
    (q, k, v), _ = _case_inputs(cp, layout)
    got = _assemble(ring, ("fwd", layout, causal, None), cp, layout)
    want = _jax_ring(cp, layout, causal, q, k, v, devices8)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_attention(q, k, v, causal)), **FWD_TOL)


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_zigzag_and_contiguous_forward_match_dense(ring, layout):
    """Both causal flags of both layouts against dense attention (the JAX
    oracle ring's non-causal zigzag leg is covered by the dense reference,
    which the JAX suite holds it to)."""
    cp = len(ring)
    (q, k, v), _ = _case_inputs(cp, layout)
    for causal in (True, False):
        got = _assemble(ring, ("fwd", layout, causal, None), cp, layout)
        np.testing.assert_allclose(got, np.asarray(jax_attention(q, k, v, causal)), **FWD_TOL)


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fused", ["sendahead", "dma"])
def test_ring_schedules_bit_identical(ring, layout, causal, fused):
    """The three hop schedules merge the same pairs in the same order: the
    fused forwards equal the unfused one bit for bit on every rank."""
    for r in ring:
        assert torch.equal(r[("fwd", layout, causal, fused)], r[("fwd", layout, causal, None)])


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fused", ["sendahead", "dma"])
def test_ring_backward_schedules_agree(ring, layout, fused):
    for r in ring:
        for got, want in zip(r[("grad", layout, fused)], r[("grad", layout, None)]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **BWD_SCHEDULE_TOL)


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fused", SCHEDULES)
def test_ring_backward_matches_dense_jax_grads(ring, layout, fused):
    """The KV re-streaming backward (dq local, dk/dv home after touring
    the ring) against ``jax.grad`` of dense attention, all three operands."""
    cp = len(ring)
    (q, k, v), perm = _case_inputs(cp, layout)
    want = jax.grad(lambda a: jnp.sum(jnp.tanh(jax_attention(*a, True))))(
        tuple(jnp.asarray(t) for t in (q, k, v)))
    for i, w in enumerate(want):
        got = np.concatenate([r[("grad", layout, fused)][i].numpy() for r in ring], axis=2)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        np.testing.assert_allclose(got[:, :, inv], np.asarray(w), **BWD_DENSE_TOL)


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
def test_ring_pass_rotates_both_directions(ring):
    cp = len(ring)
    for rank, r in enumerate(ring):
        # +1: rank i → i+1, so rank r receives from r−1; −1 the mirror
        assert r["pass"][+1].item() == (rank - 1) % cp
        assert r["pass"][-1].item() == (rank + 1) % cp
        x, x2 = r["pass_tuple"]
        assert x.item() == (rank - 1) % cp and x2.item() == 2 * ((rank - 1) % cp)


@pytest.mark.parametrize("ring", [2, 4], indirect=True)
def test_flash_stream_hop_returns_flash_and_the_neighbours_kv(ring):
    """One fused hop on CPU tensors: (out, lse) of the plain flash (or the
    skip identity for ``pred`` false) and the K/V of the source rank."""
    cp = len(ring)
    (q, k, v), _ = _case_inputs(cp, "contiguous")
    n = q.shape[2] // cp
    for rank, r in enumerate(ring):
        rows = slice(rank * n, (rank + 1) * n)
        for sign in (+1, -1):
            out, lse, k_next, v_next = r["hop"][sign]
            src = (rank - sign) % cp
            src_rows = slice(src * n, (src + 1) * n)
            assert np.array_equal(k_next.numpy(), k[:, :, src_rows])
            assert np.array_equal(v_next.numpy(), v[:, :, src_rows])
            if sign > 0:
                want_out, want_lse = jax_flash_attention_lse(
                    *(jnp.asarray(t[:, :, rows]) for t in (q, k, v)), True, rank * n, rank * n,
                    interpret=True)
                np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD_TOL)
                np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
            else:
                assert not out.any() and bool((lse == -1e30).all())


def test_gpt2_ring2_loss_matches_jax_loss_spmd(ring2, devices8):
    """``attn_impl="ring2"`` through the model on cp = 2: per-rank positions
    offset by the shard origin, each rank's own cross-entropy, averaged —
    the JAX ``loss_spmd`` on a cp mesh."""
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel.hybrid import hybrid_loss_fn, shard_params
    from dsml_tpu.parallel.mesh import MeshSpec, build_mesh

    model = GPT2(GPT2Config.tiny())
    params = model.init(9)
    x, y = _gpt2_batch()
    mesh = build_mesh(MeshSpec(dp=1, cp=2), devices8[:2])
    fn = jax.jit(jax.shard_map(
        lambda p, xx, yy: lax.pmean(hybrid_loss_fn(model, "ring2", seq_axis="cp")(p, xx, yy),
                                    ("dp", "cp")),
        mesh=mesh, in_specs=(model.param_specs(), P("dp", "cp"), P("dp", "cp")), out_specs=P(),
        check_vma=False))
    want = float(fn(shard_params(params, mesh, model.param_specs()), jnp.asarray(x),
                    jnp.asarray(y)))
    for r in ring2:
        np.testing.assert_allclose(r["gpt2_loss"].item(), want, rtol=1e-5)


# ---- pure functions, no ranks ---------------------------------------------------


def test_ring_perm_tables_match_jax():
    for n in (1, 2, 4, 8):
        assert tcollectives.ring_perm_tables(n) == jcollectives.ring_perm_tables(n)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("backward", [True, False])
def test_ring_kv_wire_bytes_matches_jax(bidirectional, backward):
    for args in ((128, 4, 2, 16), (9, 2, 1, 8), (33, 2, 12, 64), (128, 1, 2, 16)):
        for itemsize in (2, 4):
            kw = dict(batch=3, itemsize=itemsize, bidirectional=bidirectional, backward=backward)
            assert tring.ring_kv_wire_bytes(*args, **kw) == jring.ring_kv_wire_bytes(*args, **kw)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_causal_fractions_match_jax(layout):
    for n in (1, 2, 3, 4, 8, 1024):
        assert tring.causal_keep_fraction(n, layout) == jring.causal_keep_fraction(n, layout)
        assert (tring.causal_critical_path_fraction(n, layout)
                == jring.causal_critical_path_fraction(n, layout))


def test_zigzag_permutations_match_jax():
    for n, s in ((2, 8), (2, 52), (4, 104), (3, 36)):
        assert np.array_equal(tring.zigzag_indices(n, s), jring.zigzag_indices(n, s))
        assert np.array_equal(tring.zigzag_inverse(n, s), jring.zigzag_inverse(n, s))
    with pytest.raises(ValueError, match="2·cp stripes"):
        tring.zigzag_indices(2, 10)


def test_ring_fused_mode_knob(monkeypatch):
    """The port reads ``DSML_RING_FUSED`` as the JAX package does, and
    refuses a value it does not know instead of quietly unfusing."""
    monkeypatch.delenv("DSML_RING_FUSED", raising=False)
    assert tring.ring_fused_mode() is None
    for raw in ("0", "off", "1", "on", "auto", "sendahead", "DMA "):
        monkeypatch.setenv("DSML_RING_FUSED", raw)
        assert tring.ring_fused_mode() == jring.ring_fused_mode(), raw
    monkeypatch.setenv("DSML_RING_FUSED", "bogus")
    with pytest.raises(ValueError, match="DSML_RING_FUSED"):
        tring.ring_fused_mode()


def test_ring_attention_validation():
    z = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="layout"):
        tring.ring_attention(z, z, z, None, layout="striped")
    with pytest.raises(ValueError, match="fused"):
        tring.ring_attention(z, z, z, None, fused="bogus")
    with pytest.raises(ValueError, match="sign"):
        tcollectives.ring_pass(z, None, 2)


def test_ring_attention_without_a_ring_is_flash():
    """A group of one (or none) is single-device flash attention, as the
    JAX ring at n = 1."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(40, seed=3))
    want = tflash.flash_attention(q, k, v, True)
    assert torch.equal(tring.ring_attention(q, k, v, None, True), want)


@pytest.mark.parametrize("s_q,s_kv,q_start,k_start", [(33, 33, 33, 0), (33, 17, 33, 33),
                                                       (64, 32, 0, 64), (13, 7, 26, 13)])
def test_flash_stream_reference_matches_jax_flash_lse(s_q, s_kv, q_start, k_start):
    """Kernel 4's plain version against the JAX flash kernel (interpret
    mode) at the same global offsets, and its copy."""
    rng = np.random.default_rng(s_q + s_kv)
    q = rng.standard_normal((4, s_q, 16)).astype(np.float32)
    k, v = (rng.standard_normal((4, s_kv, 16)).astype(np.float32) for _ in range(2))
    want_out, want_lse = jax_flash_attention_lse(
        *(jnp.asarray(t)[None] for t in (q, k, v)), True, q_start, k_start, interpret=True)
    k_dst, v_dst = torch.empty(k.shape), torch.empty(v.shape)
    out, lse = tflash.flash_stream(*(torch.from_numpy(t) for t in (q, k, v)), k_dst, v_dst, True,
                                   True, q_start, k_start)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out)[0], **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[0], **FWD_TOL)
    assert np.array_equal(k_dst.numpy(), k) and np.array_equal(v_dst.numpy(), v)


def test_flash_stream_reference_skip_identity_still_copies():
    """``pred`` false: out = 0, lse = -1e30 (the unfused ring's skipped
    pair), and the K/V bytes still move."""
    q, k, v = (torch.from_numpy(t[0]) for t in _qkv(24, seed=5))
    k_dst, v_dst = torch.zeros_like(k), torch.zeros_like(v)
    out, lse = tflash.flash_stream(q, k, v, k_dst, v_dst, False, True, 0, 100)
    assert out.shape == q.shape and not out.any()
    assert lse.dtype == torch.float32 and bool((lse == -1e30).all())
    assert torch.equal(k_dst, k) and torch.equal(v_dst, v)
    assert tflash.flash_stream_launches == 0  # CPU tensors never launch
