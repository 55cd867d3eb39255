"""The port's collectives (``dsml_tpu_torch.ops.collectives``) against the
JAX package's, on the CPU.

A module-scoped fixture spawns one gloo ring per world size (n = 2, 3, 4;
rendezvous through a file under ``tmp_path``) that runs every case once
and saves each rank's outputs; the JAX side runs the same numpy inputs
under ``shard_map`` on ``devices8[:n]``, as ``tests/test_collectives.py``
does. The ring schedules must equal the JAX ring bit for bit (the combine
order is the schedule's); the others are held to the JAX suite's
``rtol=2e-5`` against numpy."""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.ops import collectives as C
from dsml_tpu_torch.parallel.mesh import data_mesh
from dsml_tpu_torch.parallel.peer import RingGroup

WORLD_SIZES = (2, 3, 4)
SHAPES = {"33": (33,), "16x5": (16, 5)}  # padding in both ring directions
OPS = list(C.ReduceOp)
RINGS = ("ring", "ring2")
OTHERS = ("naive", "xla", "auto")
# name -> (numpy dtype, torch dtype, low, high): the JAX suite's _stack
# (integers in [1, 5), floats near 1 so PROD stays well-conditioned), and
# two integer sets (SUM and AVG, size 33) that wrap on the final cast
# (uint8) and truncate a negative AVG toward zero (int32)
DTYPES = {
    "float32": (np.float32, torch.float32, None, None),
    "int32": (np.int32, torch.int32, 1, 5),
    "uint8": (np.uint8, torch.uint8, 1, 5),
    "bfloat16": ("bfloat16", torch.bfloat16, None, None),
    "uint8_wrap": (np.uint8, torch.uint8, 100, 255),
    "int32_signed": (np.int32, torch.int32, -100, 100),
}
WIDE = ("uint8_wrap", "int32_signed")
# the "xla" route's two faults (ROADMAP queue 3, faults 2 and 3): an integer
# AVG (three rows of the fault's report and a fourth for n = 4) and bf16
# rows of 4096 values, first n rows at world size n
FAULT_INT_ROWS = np.array([[1, 2, 7], [2, 2, 1], [4, 3, 5], [6, 0, 9]], np.int32)
FAULT_INT_ALGS = ("xla", "ring", "naive")


def _fault_bf16_rows(n):
    return (np.random.default_rng(0).random((4, 4096)) * 2 - 1)[:n]


def _fault4_rows(n):
    """ROADMAP queue 3, fault 4's inputs: f32 rows of 3000 values over
    sixteen binades, which make the summation order visible."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((n, 3000)) * np.exp(rng.uniform(-8, 8, (n, 3000)))).astype(
        np.float32)


def _cases(name):
    """(shape name, op) pairs of one input set."""
    if name in WIDE:
        return [("33", op) for op in (C.ReduceOp.SUM, C.ReduceOp.AVG)]
    return [(s, op) for s in SHAPES for op in OPS]


def _stack(n, shape, name, seed=0):
    """[n, *shape] per-rank inputs, as float64 or int64 numpy (cast on each
    side)."""
    _, _, lo, hi = DTYPES[name]
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.integers(lo, hi, size=(n, *shape))
    return rng.random((n, *shape)) * 0.5 + 0.75


def _port_input(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Floats through f32, as ``jnp.asarray`` of a float64 array then
    ``astype`` rounds them."""
    t = torch.from_numpy(a)
    return (t.float() if t.dtype.is_floating_point else t).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _rank_worker(rank, n, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(n, rank, os.path.join(tmp, "rendezvous"), "cpu")
    group = mesh.group("dp")
    out = {}
    for name, (_, tdt, _, _) in DTYPES.items():
        for sname, op in _cases(name):
            x = _port_input(_stack(n, SHAPES[sname], name)[rank], tdt)
            for alg in RINGS:
                out[f"{alg}/{name}/{sname}/{op.name}"] = C.all_reduce(x, group, op, alg)
    f32 = _port_input(_stack(n, (33,), "float32", seed=1)[rank], torch.float32)
    for alg in OTHERS:
        for op in OPS:
            out[f"{alg}/{op.name}"] = C.all_reduce(f32, group, op, alg)
    big = _port_input(_stack(n, (12, 3), "float32", seed=2)[rank], torch.float32)
    out["rs_roundtrip"] = C.all_gather(C.reduce_scatter(big, group), group)
    for op in (C.ReduceOp.MIN, C.ReduceOp.MAX, C.ReduceOp.PROD, C.ReduceOp.AVG):
        shard = C.reduce_scatter(big, group, op)
        out[f"rs/{op.name}"] = shard
        out[f"rs_gather/{op.name}"] = C.all_gather(shard, group)
    out["all_gather_untiled"] = C.all_gather(big, group, axis=1, tiled=False)
    ints = torch.from_numpy(FAULT_INT_ROWS[rank])
    for alg in FAULT_INT_ALGS:
        out[f"fault2/{alg}"] = C.all_reduce(ints, group, C.ReduceOp.AVG, alg)
    bf16 = _port_input(_fault_bf16_rows(n)[rank], torch.bfloat16)
    for op in (C.ReduceOp.SUM, C.ReduceOp.AVG):
        out[f"fault3/{op.name}"] = C.all_reduce(bf16, group, op, "xla")
    f4 = torch.from_numpy(_fault4_rows(n)[rank])
    for op in (C.ReduceOp.SUM, C.ReduceOp.AVG):
        out[f"fault4/rs/{op.name}"] = C.reduce_scatter(f4, group, op)
        out[f"fault4/xla/{op.name}"] = C.all_reduce(f4, group, op, "xla")
    for op in (C.ReduceOp.SUM, C.ReduceOp.MAX):
        shard, padded = C.flat_reduce_scatter(f32, group, op)
        out[f"flat/{op.name}"] = C.flat_all_gather(shard, group, f32.numel())
        out[f"flat_padded/{op.name}"] = torch.tensor(padded)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{n: [rank outputs]} from one spawn per world size."""
    runs = {}
    for n in WORLD_SIZES:
        tmp = tmp_path_factory.mktemp(f"collectives{n}")
        mp.spawn(_rank_worker, args=(n, str(tmp)), nprocs=n, join=True)
        runs[n] = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n)]
    return runs


@pytest.fixture(scope="module")
def jax_rings(devices8):
    """{(n, dtype name): {key: [n, ...] numpy}} from the JAX ring and ring2,
    every op and shape of one dtype in one program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.ops import collectives as JC

    out = {}
    for n in WORLD_SIZES:
        mesh = Mesh(np.asarray(devices8[:n]), ("dev",))
        for name, (ndt, _, _, _) in DTYPES.items():
            dtype = jnp.bfloat16 if ndt == "bfloat16" else ndt
            inputs = {s: jnp.asarray(_stack(n, shape, name)).astype(dtype)
                      for s, shape in SHAPES.items()}

            def fn(xs):
                res = {}
                for s, op in _cases(name):
                    for alg in RINGS:
                        res[f"{alg}/{name}/{s}/{op.name}"] = JC.all_reduce(
                            xs[s][0], "dev", JC.ReduceOp(int(op)), alg)[None]
                return res

            res = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("dev"), out_specs=P("dev"),
                                        check_vma=False))(inputs)
            out[(n, name)] = {k: np.asarray(v) for k, v in res.items()}
    return out


def _jax_xla(devices8, n, x, op):
    """The JAX package's ``all_reduce(..., "xla")`` of the rows ``x`` [n, ...]
    under ``shard_map`` on ``devices8[:n]`` → [n, ...] numpy."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.ops import collectives as JC

    mesh = Mesh(np.asarray(devices8[:n]), ("dev",))
    fn = jax.jit(jax.shard_map(lambda s: JC.all_reduce(s[0], "dev", JC.ReduceOp(int(op)), "xla")[None],
                               mesh=mesh, in_specs=P("dev"), out_specs=P("dev"), check_vma=False))
    return np.asarray(fn(x))


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_xla_integer_avg_is_float32_as_jax(port_runs, devices8, n):
    """Queue 3 fault 2: an integer AVG through ``"xla"`` returns float32,
    as ``lax.pmean`` does, bit for bit with the JAX package (its mean is
    the int sum times the f32 reciprocal of n: at n = 3 the rows [1, 2, 7],
    [2, 2, 1], [4, 3, 5] give [2.3333335, 2.3333335, 4.3333335]); the ring
    and naive routes keep int32 (truncating), as the JAX rings do."""
    want = _jax_xla(devices8, n, FAULT_INT_ROWS[:n], C.ReduceOp.AVG)
    assert want.dtype == np.float32
    for r, ranks in enumerate(port_runs[n]):
        got = ranks["fault2/xla"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want[r])
        for alg in ("ring", "naive"):
            got = ranks[f"fault2/{alg}"]
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), (FAULT_INT_ROWS[:n].sum(0) // n))
    if n == 3:
        np.testing.assert_array_equal(port_runs[3][0]["fault2/xla"].numpy(),
                                      np.float32([7, 7, 13]) * np.float32(1 / 3))


def test_xla_integer_avg_at_one_rank_is_float32_as_jax(devices8):
    """Fault 2 at n = 1: ``lax.pmean`` of an int32 row is float32 there too."""
    want = _jax_xla(devices8, 1, FAULT_INT_ROWS[:1], C.ReduceOp.AVG)[0]
    got = C.all_reduce(torch.from_numpy(FAULT_INT_ROWS[0]), RingGroup(None, [0], 0, "cpu"),
                       C.ReduceOp.AVG, "xla")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_xla_bf16_reduces_in_f32_as_jax(port_runs, devices8, n):
    """Queue 3 fault 3: a bf16 SUM or AVG through ``"xla"`` is reduced in
    f32 and rounded to bf16 once. It equals the JAX package's
    ``lax.psum``/``lax.pmean`` on CPU devices bit for bit, at n = 2, 3 and
    4 (before the repair gloo rounded every partial sum: 1273 of 4096
    elements differed at n = 4). The SUM lies within one bf16 rounding of
    the exact sum of the bf16 inputs; the AVG, as ``lax.pmean``, is that
    rounded sum times the f32 reciprocal of n, rounded once more."""
    x = _fault_bf16_rows(n)
    xb = torch.from_numpy(x).float().to(torch.bfloat16)
    import jax.numpy as jnp

    for op in (C.ReduceOp.SUM, C.ReduceOp.AVG):
        want = _jax_xla(devices8, n, jnp.asarray(x).astype(jnp.bfloat16), op)
        exact = xb.double().sum(0)  # exact in f32 too: four bf16 values in (-1, 1)
        if op == C.ReduceOp.AVG:
            exact = exact.float().to(torch.bfloat16).double() / n
        _, e = torch.frexp(exact.float())
        half_ulp = torch.ldexp(torch.ones_like(exact), e - 9)  # half of 2^-7 of the binade
        for r, ranks in enumerate(port_runs[n]):
            got = ranks[f"fault3/{op.name}"]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(got), _jax_bits(want[r]), err_msg=op.name)
            assert bool(((got.double() - exact).abs() <= half_ulp).all()), op.name


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_reduce_scatter_and_xla_sum_in_rank_order_as_jax(port_runs, devices8, n):
    """Queue 3 fault 4: ``reduce_scatter`` SUM/AVG and the ``"xla"``
    all-reduce of f32 CPU tensors equal the JAX package's (``lax.psum_scatter``
    and ``lax.psum``, which sum the ranks in rank order) bit for bit. Before
    the repair the ring's and gloo's orders left 1261 of 9000 elements
    different at n = 3 and 2818 (reduce-scatter) / 3195 (all-reduce) of
    12000 at n = 4."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.ops import collectives as JC

    x = _fault4_rows(n)
    mesh = Mesh(np.asarray(devices8[:n]), ("dev",))
    for op in (C.ReduceOp.SUM, C.ReduceOp.AVG):
        rs = jax.jit(jax.shard_map(
            lambda s, op=op: JC.reduce_scatter(s[0], "dev", JC.ReduceOp(int(op)))[None],
            mesh=mesh, in_specs=P("dev"), out_specs=P("dev"), check_vma=False))
        want_rs = np.asarray(rs(x))
        want_xla = _jax_xla(devices8, n, x, op)
        for r, ranks in enumerate(port_runs[n]):
            np.testing.assert_array_equal(ranks[f"fault4/rs/{op.name}"].numpy(), want_rs[r],
                                          err_msg=f"reduce_scatter {op.name}")
            np.testing.assert_array_equal(ranks[f"fault4/xla/{op.name}"].numpy(), want_xla[r],
                                          err_msg=f"xla {op.name}")


def _jax_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("alg", RINGS)
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ring_bit_identical_to_jax(port_runs, jax_rings, n, name, alg):
    """ring and ring2 on every rank equal the JAX ring bit for bit, for
    every ReduceOp at sizes 33 and (16, 5): integers accumulate in int32
    (uint8 wraps only on the cast back; an int AVG truncates toward zero),
    floats and bf16 in their own type."""
    want = jax_rings[(n, name)]
    for r, ranks in enumerate(port_runs[n]):
        for sname, op in _cases(name):
            key = f"{alg}/{name}/{sname}/{op.name}"
            got = ranks[key]
            assert got.dtype == DTYPES[name][1] and tuple(got.shape) == SHAPES[sname], key
            np.testing.assert_array_equal(_bits(got), _jax_bits(want[key][r]), err_msg=key)


def _np_reduce(xs, op):
    if op in (C.ReduceOp.SUM, C.ReduceOp.AVG):
        out = xs.sum(axis=0)
        return out / xs.shape[0] if op == C.ReduceOp.AVG else out
    if op == C.ReduceOp.PROD:
        return np.prod(xs, axis=0)
    return xs.min(axis=0) if op == C.ReduceOp.MIN else xs.max(axis=0)


@pytest.mark.parametrize("alg", OTHERS)
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_naive_xla_auto_all_ops(port_runs, n, alg):
    """The JAX suite's ``test_all_reduce_all_ops`` bound (rtol 2e-5 against
    numpy) for every ReduceOp, size 33."""
    xs = _stack(n, (33,), "float32", seed=1).astype(np.float32)
    for ranks in port_runs[n]:
        for op in OPS:
            np.testing.assert_allclose(ranks[f"{alg}/{op.name}"].numpy(), _np_reduce(xs, op),
                                       rtol=2e-5, err_msg=f"{alg}/{op.name}")


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_reduce_scatter_then_gather_roundtrip(port_runs, n):
    xs = _stack(n, (12, 3), "float32", seed=2).astype(np.float32)
    for r, ranks in enumerate(port_runs[n]):
        np.testing.assert_allclose(ranks["rs_roundtrip"].numpy(), xs.sum(0), rtol=1e-5)
        rows = 12 // n
        for op in (C.ReduceOp.MIN, C.ReduceOp.MAX, C.ReduceOp.PROD, C.ReduceOp.AVG):
            want = _np_reduce(xs, op)
            np.testing.assert_allclose(ranks[f"rs/{op.name}"].numpy(),
                                       want[r * rows:(r + 1) * rows], rtol=1e-6, err_msg=op.name)
            np.testing.assert_allclose(ranks[f"rs_gather/{op.name}"].numpy(), want, rtol=1e-6)
        np.testing.assert_array_equal(ranks["all_gather_untiled"].numpy(),
                                      np.moveaxis(xs, 0, 1))


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_flat_reduce_scatter_pads_with_the_identity(port_runs, n):
    """33 elements over n ranks: the padded tail holds the op's identity,
    so MAX of near-1 values is untouched by it; the gather drops it."""
    xs = _stack(n, (33,), "float32", seed=1).astype(np.float32)
    for ranks in port_runs[n]:
        for op in (C.ReduceOp.SUM, C.ReduceOp.MAX):
            np.testing.assert_allclose(ranks[f"flat/{op.name}"].numpy(), _np_reduce(xs, op),
                                       rtol=1e-6)
            assert int(ranks[f"flat_padded/{op.name}"]) == -(-33 // n) * n


def test_single_rank_is_the_identity():
    """n = 1: every all-reduce returns its input (the reference's early
    out), as the JAX ``test_single_device_early_out``."""
    group = RingGroup(None, [0], 0, "cpu")
    x = torch.from_numpy(_stack(1, (7,), "float32")[0]).float()
    for alg in RINGS + OTHERS:
        for op in OPS:
            assert torch.equal(C.all_reduce(x, group, op, alg), x), (alg, op)
    assert torch.equal(C.reduce_scatter(x, group), x)
    assert torch.equal(C.all_gather(x, group), x)


def test_ring_wire_bytes_and_auto_match_jax():
    from dsml_tpu.ops import collectives as JC

    for n_elems in (1, 33, 1000, 101770, 1 << 20):
        for n in (1, 2, 3, 4, 8, 64):
            for itemsize in (2, 4):
                for bidir in (False, True):
                    assert C.ring_wire_bytes(n_elems, n, itemsize, bidir) == \
                        JC.ring_wire_bytes(n_elems, n, itemsize, bidir)
    for nbytes in (1024, 32 * 1024, 64 * 1024, 90 * 1024, 128 * 1024, 1 << 20, 1 << 30):
        for n in (2, 3, 4, 8, 64):
            assert C.auto_all_reduce_algorithm(nbytes, n) == JC.auto_all_reduce_algorithm(nbytes, n)


def _profile(tmp_path, name, constants):
    path = tmp_path / name
    path.write_text(constants if isinstance(constants, str) else json.dumps(
        {"constants": {k: {"median": v} for k, v in constants.items()}}))
    return str(path)


def test_auto_profile_and_fallbacks_match_jax(tmp_path, monkeypatch):
    """``DSML_COLLECTIVE_PROFILE``: a measured profile moves the crossover
    (the JAX suite's constants), a missing, malformed or non-physical one
    keeps the analytic rule; both packages choose alike over a grid."""
    from dsml_tpu.ops import collectives as JC

    keys = ("allreduce_naive_p50_ms", "allreduce_ring_p50_ms", "allreduce_payload_mb",
            "allreduce_devices")
    profiles = {
        "measured": _profile(tmp_path, "measured.json", dict(zip(keys, (8.42, 9.463, 1.0, 8.0)))),
        "missing": str(tmp_path / "nope.json"),
        "malformed": _profile(tmp_path, "bad.json", "not json"),
        "nonphysical": _profile(tmp_path, "weird.json", dict(zip(keys, (10.0, 200.0, 1.0, 8.0)))),
        "no_constant": _profile(tmp_path, "short.json", dict(zip(keys[:3], (8.42, 9.463, 1.0)))),
    }
    for label, path in profiles.items():
        monkeypatch.setenv("DSML_COLLECTIVE_PROFILE", path)
        C._measured_alpha_beta.cache_clear()
        JC._measured_alpha_beta.cache_clear()
        try:
            assert C._measured_alpha_beta(path) == JC._measured_alpha_beta(path), label
            for nbytes in (1024, 64 * 1024, 128 * 1024, 1 << 20, 16 << 20, 1 << 30):
                for n in (2, 4, 8, 64):
                    assert C.auto_all_reduce_algorithm(nbytes, n) == \
                        JC.auto_all_reduce_algorithm(nbytes, n), (label, nbytes, n)
        finally:
            C._measured_alpha_beta.cache_clear()
            JC._measured_alpha_beta.cache_clear()
    monkeypatch.setenv("DSML_COLLECTIVE_PROFILE", profiles["measured"])
    assert C.auto_all_reduce_algorithm(128 * 1024, 8) == "naive"  # the prior says ring
    assert C._measured_alpha_beta(profiles["nonphysical"]) is None
    C._measured_alpha_beta.cache_clear()


def test_all_reduce_rejects_unknown_algorithm():
    group = RingGroup(None, [0], 0, "cpu")
    with pytest.raises(ValueError, match="unknown all-reduce algorithm"):
        C.all_reduce(torch.ones(3), group, C.ReduceOp.SUM, "bogus")
    with pytest.raises(ValueError, match="not divisible"):
        C.reduce_scatter(torch.ones(3), RingGroup(None, [0, 1], 0, "cpu"))
