"""The port's sequence-parallel attention functions (``dsml_tpu_torch.ops.
attention``: the XLA ring, Ulysses, the 2D grid; ``ops.flash.
ring_flash_attention``; the differentiable ``ops.collectives.ring_pass``)
against the JAX package's, on the CPU in f32.

One module-scoped spawn of four ranks (gloo, rendezvous through a file
under ``tmp_path``) builds three meshes on the same processes, dp = 2 × sp
= 2 (rings of two), sp = 4 and sp = 2 × tp = 2 (the 2D grid: sp outer, tp
inner), runs every case's forward and its backward against a seeded
cotangent on each rank's sequence shard, and saves what each rank holds.
The tests assemble the shards and hold them against the same JAX function
under ``shard_map`` on the ``devices8`` virtual mesh (its flash kernels in
interpret mode, as ``tests/test_attention.py`` runs them), forward and in
gradients, at the JAX suite's tolerances."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from dsml_tpu_torch.ops import attention as tattn
from dsml_tpu_torch.ops import flash as tflash
from dsml_tpu_torch.ops.collectives import ring_pass
from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh, rank_coords

B, H, S, D = 2, 4, 32, 8
NO_AXES = {"pp": 0, "dp": 0, "fsdp": 0, "sp": 0, "cp": 0, "tp": 0}
# the JAX suite's bounds (tests/test_attention.py): forward, then gradients
FWD = {"rtol": 2e-4, "atol": 2e-5}
GRAD = {"rtol": 1e-3, "atol": 1e-4}
# the JAX functions compile without XLA's backend optimizations: less
# compile time, the same arithmetic up to summation order
FAST_COMPILE = {"xla_backend_optimization_level": 0}

# name -> (function, ring size or "2d", causal); the 2D cases run on the
# sp = 2 (outer) × tp = 2 (inner) grid
CASES = {
    "ring-2": ("ring", 2, True), "ring-4-full": ("ring", 4, False),
    "ulysses-2": ("ulysses", 2, True), "ulysses-4-full": ("ulysses", 4, False),
    "ulysses_flash-2": ("ulysses_flash", 2, True), "ulysses_flash-4": ("ulysses_flash", 4, True),
    "ring_flash-2": ("ring_flash", 2, True), "ring_flash-4": ("ring_flash", 4, True),
    "2d": ("2d", "2d", True), "2d-full": ("2d", "2d", False),
}


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    return q, k, v, w  # w: the cotangent of the output


def _port_fn(fn, causal, group, inner=None):
    return {
        "ring": lambda q, k, v: tattn.ring_attention(q, k, v, group, causal),
        "ulysses": lambda q, k, v: tattn.ulysses_attention(q, k, v, group, causal),
        "ulysses_flash": lambda q, k, v: tattn.ulysses_attention(q, k, v, group, causal, flash=True),
        "ring_flash": lambda q, k, v: tflash.ring_flash_attention(q, k, v, group, causal),
        "2d": lambda q, k, v: tattn.attention_2d(q, k, v, inner, group, causal),
    }[fn]


def _run_case(fn, block, n_blocks, causal, group, inner=None):
    """This rank's output shard and the gradients of <out, w> on its shard."""
    s = S // n_blocks
    cols = slice(block * s, (block + 1) * s)
    q, k, v, w = (torch.from_numpy(t[:, :, cols].copy()) for t in _inputs())
    for t in (q, k, v):
        t.requires_grad_(True)
    out = _port_fn(fn, causal, group, inner)(q, k, v)
    (out * w).sum().backward()
    return {"block": block, "out": out.detach(), "grads": [t.grad for t in (q, k, v)]}


def _worker(rank, tmp):
    torch.set_num_threads(1)
    rendezvous = os.path.join(tmp, "rendezvous")
    res = {}
    meshes = {2: MeshSpec(dp=2, sp=2), 4: MeshSpec(sp=4), "2d": MeshSpec(sp=2, tp=2)}
    for n, spec in meshes.items():
        mesh = build_mesh(spec, rank, 4, rendezvous, "cpu")
        group = mesh.group("sp")
        for name, (fn, size, causal) in CASES.items():
            if size != n:
                continue
            if n == "2d":  # rank (o, i) holds global sub-block o·n_inner + i
                block = mesh.coord("sp") * 2 + mesh.coord("tp")
                res[name] = _run_case(fn, block, 4, causal, group, mesh.group("tp"))
            else:
                res[name] = _run_case(fn, group.rank, n, causal, group)
        if n == 2:
            # the differentiable hop: <ring_pass((x, 2x)), (w0, w1)> pulls
            # w0 + 2·w1 of the NEXT rank back onto x
            x = torch.full((3,), float(rank + 1), requires_grad=True)
            w0 = torch.full((3,), float(10 * group.rank + 1))
            y0, y1 = ring_pass((x, 2 * x), group, +1)
            ((y0 * w0).sum() + (y1 * w0).sum()).backward()
            res["ring_pass"] = {"received": [y0.detach(), y1.detach()], "grad": x.grad}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """The four ranks' results and every case's JAX result; the JAX
    functions compile here while the ranks run."""
    tmp = tmp_path_factory.mktemp("long_context")
    ranks = mp.spawn(_worker, args=(str(tmp),), nprocs=4, join=False)
    with ThreadPoolExecutor(3) as pool:  # XLA compiles outside the GIL
        want = dict(zip(CASES, pool.map(lambda name: _jax_case(devices8, name), CASES)))
    while not ranks.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(4)], want


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[0]


def _assemble(port_runs, name):
    """(out, [dq, dk, dv]) over the global sequence from the ranks' shards
    (one copy of each block: the dp = 2 mesh holds two)."""
    n_blocks = 2 if CASES[name][1] == 2 else 4
    blocks = {}
    for r in port_runs:
        blocks.setdefault(r[name]["block"], r[name])
    parts = [blocks[b] for b in range(n_blocks)]
    out = torch.cat([p["out"] for p in parts], dim=2).numpy()
    grads = [torch.cat([p["grads"][i] for p in parts], dim=2).numpy() for i in range(3)]
    return out, grads


def _jax_case(devices8, name):
    """The JAX function of ``name`` under shard_map: its output and the
    gradients of <out, w> (differentiated outside shard_map)."""
    from dsml_tpu.ops.attention import attention_2d, ring_attention, ulysses_attention
    from dsml_tpu.ops.flash import ring_flash_attention

    fn, size, causal = CASES[name]
    if size == "2d":
        mesh = JaxMesh(np.asarray(devices8[:4]).reshape(2, 2), ("o", "i"))
        spec = P(None, None, ("o", "i"), None)
        body = lambda q, k, v: attention_2d(q, k, v, "i", "o", causal)  # noqa: E731
    else:
        mesh = JaxMesh(np.asarray(devices8[:size]), ("sp",))
        spec = P(None, None, "sp", None)
        body = {
            "ring": lambda q, k, v: ring_attention(q, k, v, "sp", causal),
            "ulysses": lambda q, k, v: ulysses_attention(q, k, v, "sp", causal),
            "ulysses_flash": lambda q, k, v: ulysses_attention(q, k, v, "sp", causal, flash=True),
            "ring_flash": lambda q, k, v: ring_flash_attention(q, k, v, "sp", causal),
        }[fn]
    sharded = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                            check_vma=False)
    q, k, v, w = (jnp.asarray(t) for t in _inputs())

    def objective(q, k, v):
        out = sharded(q, k, v)
        return jnp.sum(out * w), out

    fn = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True))
    (_, out), grads = fn.lower(q, k, v).compile(compiler_options=FAST_COMPILE)(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(runs, name):
    got, _ = _assemble(runs[0], name)
    want, _ = runs[1][name]
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(runs, name):
    """dq, dk and dv of <out, w>: the K/V cotangents rode the ring (or the
    inverse all-to-all) home, and the fully masked flash hop of the causal
    ring_flash cases added nothing, NaN least of all."""
    _, got = _assemble(runs[0], name)
    _, want = runs[1][name]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **GRAD)


def test_fully_masked_ring_flash_hop_matches_jax():
    """Rank 0's second hop at n = 2: every key of the visiting block lies in
    the future. The port's flash call gives zeros and an lse at the
    kernel's −1e20 floor (weight exp(−1e20 − lse) = 0 in the merge), as the
    JAX kernel does, and its backward under any cotangent gives zero and
    finite gradients (p = exp(s − lse) = 0 on every masked row)."""
    from dsml_tpu.ops.flash import flash_attention_lse as jax_flash_lse

    q, k, v, w = _inputs()
    s = S // 2
    qs, ks, vs = q[:, :, :s], k[:, :, s:], v[:, :, s:]
    want_out, want_lse = jax_flash_lse(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), True,
                                       q_start=0, k_start=s)
    tq, tk, tv = (torch.from_numpy(t.copy()).requires_grad_(True) for t in (qs, ks, vs))
    out, lse = tflash.flash_attention_lse(tq, tk, tv, True, q_start=0, k_start=s)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD)
    assert (lse <= -1e19).all() and (np.asarray(want_lse) <= -1e19).all()
    ((out * torch.from_numpy(w[:, :, :s].copy())).sum() + lse.sum()).backward()
    for t in (tq, tk, tv):
        assert torch.isfinite(t.grad).all() and not t.grad.any()


class _Pair:
    """A ring group of two as the checks before any exchange see it."""

    size, rank = 2, 0


@pytest.mark.parametrize("fn", ["ulysses", "attention_2d"])
def test_head_split_raises_the_jax_error(devices8, fn):
    """Three heads over a group of two: the port raises the JAX package's
    ValueError, word for word, before any exchange."""
    from dsml_tpu.ops.attention import ulysses_attention

    q = jnp.zeros((1, 3, 8, 4))
    spec = P(None, None, "sp", None)
    mesh = JaxMesh(np.asarray(devices8[:2]), ("sp",))
    with pytest.raises(ValueError) as jax_err:
        jax.jit(jax.shard_map(lambda t: ulysses_attention(t, t, t, "sp"), mesh=mesh,
                              in_specs=(spec,), out_specs=spec, check_vma=False))(q)
    t = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError) as port_err:
        if fn == "ulysses":
            tattn.ulysses_attention(t, t, t, _Pair())
        else:
            tattn.attention_2d(t, t, t, _Pair(), _Pair())
    assert str(port_err.value) == str(jax_err.value) == "heads (3) not divisible by axis size 2"


def test_differentiable_ring_pass(port_runs):
    """``ring_pass`` of a tuple under autograd: rank r receives rank r − 1's
    tensors, and the cotangents ride one hop back (the transpose of
    ``ppermute``), so x on rank r gets (1 + 2)·w of rank r + 1 in its sp
    ring of two."""
    for rank in (0, 1):  # the dp = 0 ring: ranks 0 and 1 at sp coordinates 0 and 1
        assert rank_coords(MeshSpec(dp=2, sp=2), rank) == {**NO_AXES, "sp": rank}
        other = 1 - rank
        got = port_runs[rank]["ring_pass"]
        assert torch.equal(got["received"][0], torch.full((3,), float(other + 1)))
        assert torch.equal(got["received"][1], torch.full((3,), 2.0 * (other + 1)))
        assert torch.equal(got["grad"], torch.full((3,), 3.0 * (10 * other + 1)))


def test_ring_of_one_is_plain_attention():
    """A group of one (or None) is the single-device function, as a JAX
    axis of size one: plain attention, or flash for the flash variants."""
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs())

    class One:
        size, rank = 1, 0

    want = tattn.attention(q, k, v)
    for group in (None, One()):
        assert torch.equal(tattn.ring_attention(q, k, v, group), want)
        assert torch.equal(tattn.ulysses_attention(q, k, v, group), want)
        assert torch.equal(tattn.attention_2d(q, k, v, group, group), want)
        assert torch.equal(tflash.ring_flash_attention(q, k, v, group),
                           tflash.flash_attention(q, k, v))
