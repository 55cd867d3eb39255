"""The port's compressed gradient communication (``ops.quantization``'s
quantized ring all-reduce, quantized reduce-scatter and int8 gather;
``parallel.bucketing``'s quantized and error-feedback sync; the dp step,
the hybrid step's ``dp_sync`` and the ``Trainer`` on them) against the JAX
package's, on the CPU.

A module-scoped fixture spawns one gloo ring per world size (n = 2, 3, 4;
rendezvous through a file under ``tmp_path``) that runs every case once and
saves each rank's outputs; at n = 2 it also trains (the dp step, the hybrid
step and the ``Trainer`` under quantized syncs). The JAX side runs the same
numpy inputs under ``jax.jit(jax.shard_map(...))`` on ``devices8[:n]``, as
``tests/test_quantization.py`` does.

Deterministic rounding (the ring, the reduce-scatter, ``quantize_roundtrip``
and the error-feedback sync) must equal the JAX package bit for bit, and so
must the int32 seeds. The stochastic paths draw their noise from a counter
hash where JAX draws it from ``jax.random``, so they are held to the JAX
suite's own properties instead: close to the exact mean, identical on every
rank, determined by the seed, unbiased over seeds."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.ops import quantization as Q
from dsml_tpu_torch.ops.collectives import ReduceOp
from dsml_tpu_torch.parallel import bucketing as B
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.dp import make_dp_train_step, named_params
from dsml_tpu_torch.parallel.mesh import data_mesh
from dsml_tpu_torch.parallel.peer import RingGroup
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata

WORLD_SIZES = (2, 3, 4)
SIZES = (17, 1000, 4096)  # one block, a padded tail, whole blocks
RING_CASES = (("int8", False), ("int8", True), ("int4", False), ("int4", True))
RS_SIZES = (63, 1000, 4099)  # none divides 2, 3 and 4 alike
EF_CASES = (("q8_ring", 4.0), ("q4_ring2", 1e-3))  # (algorithm, bucket MiB)
EF_STEPS = 3
SUB_QUANTUM_STEPS = 10  # tests/test_quantization.py::test_error_feedback_recovers_sub_quantum_gradients
UNBIASED_SEEDS = 32
# a row whose absmax (1.0) puts the other entries between quanta: 0.35 is
# 44.45 int8 quanta and 2.45 int4 quanta, so rounding to nearest is off by
# 0.45 of a quantum in every hop (a constant row would be vacuous: it
# quantizes exactly)
BETWEEN_QUANTA = 0.35
# tests/test_bucketing.py::test_dp_step_quant_ring_matches_xla_trajectory
TRAJECTORY_DEV = 0.06
DP_STEPS = 5
HYBRID_STEPS = 3


def _stack(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size)).astype(np.float32)


def _ef_stack(n, step):
    """Per-rank gradient trees of one EF step: two f32 leaves, a bf16 leaf
    and an int32 leaf, as numpy [n, ...] (the bf16 leaf as f32 values)."""
    rng = np.random.default_rng(100 + step)
    return {"b": rng.standard_normal((n, 70)).astype(np.float32),
            "h": rng.standard_normal((n, 64)).astype(np.float32),
            "i": rng.integers(-5, 5, (n, 6)).astype(np.int32),
            "w": rng.standard_normal((n, 5, 300)).astype(np.float32)}


def _rank_tree(stack, rank):
    tree = {k: torch.from_numpy(np.array(v[rank])) for k, v in stack.items()}
    tree["h"] = tree["h"].to(torch.bfloat16)
    return tree


def _between_quanta_row():
    row = torch.full((512,), BETWEEN_QUANTA)
    row[0] = 1.0
    return row


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---- rank workers (spawned; module level so the children import them) --------


def _collective_cases(n, rank, group, out):
    for size in SIZES:
        x = torch.from_numpy(_stack(n, size)[rank])
        for scheme, bidir in RING_CASES:
            key = f"{size}/{scheme}/{bidir}"
            for mean in (True, False):
                out[f"det/{key}/{mean}"] = Q.quantized_ring_all_reduce(
                    x, group, scheme, bidir, mean, stochastic=False)
            for tag, seed in (("a", 7), ("b", 7), ("c", 8)):
                out[f"sto/{key}/{tag}"] = Q.quantized_ring_all_reduce(x, group, scheme, bidir,
                                                                       seed=seed)
            out[f"ones/{key}"] = Q.quantized_ring_all_reduce(torch.ones(size), group, scheme,
                                                             bidir, seed=3)
        for tag, seed in (("a", 7), ("b", 7), ("c", 8)):
            out[f"q8/{size}/{tag}"] = Q.compressed_all_reduce(x, group, seed)
    for size in RS_SIZES:
        x = torch.from_numpy(_stack(n, size, seed=5)[rank])
        for scheme in ("int8", "int4"):
            out[f"rs/{size}/{scheme}"], out[f"rs_padded/{size}"] = \
                Q.quantized_flat_reduce_scatter(x, group, scheme, stochastic=False)
        out[f"rs_sto/{size}"], _ = Q.quantized_flat_reduce_scatter(x, group, "int8", seed=5)


def _feedback_cases(n, rank, group, out):
    for alg, mb in EF_CASES:
        ef = B.init_error_feedback(_rank_tree(_ef_stack(n, 0), rank))
        for step in range(EF_STEPS):
            res, ef = B.bucketed_all_reduce(_rank_tree(_ef_stack(n, step), rank), group,
                                            ReduceOp.AVG, alg, mb, error_feedback=ef)
            out[f"ef/{alg}/{step}"], out[f"ef_res/{alg}/{step}"] = res, ef
    # one element pins the block scale; the rest sit below half a quantum
    base = torch.zeros(512)
    base[0], base[1:] = 1.0, 0.003
    for use_ef in (False, True):
        ef = {"g": torch.zeros(512)}
        delivered = torch.zeros(512, dtype=torch.float64)
        for _ in range(SUB_QUANTUM_STEPS):
            if use_ef:
                got, ef = B.bucketed_all_reduce({"g": base}, group, ReduceOp.AVG, "q8_ring", 4.0,
                                                error_feedback=ef)
                got = got["g"]
            else:
                got = Q.quantized_ring_all_reduce(base, group, "int8", stochastic=False)
            delivered += got.double()
        out[f"sub_quantum/{use_ef}"] = delivered


def _property_cases(n, rank, group, out):
    row = _between_quanta_row()
    for scheme, bidir in RING_CASES:
        acc = torch.zeros(512, dtype=torch.float64)
        for s in range(UNBIASED_SEEDS):
            acc += Q.quantized_ring_all_reduce(row, group, scheme, bidir, seed=s).double()
        out[f"unbiased/{scheme}/{bidir}"] = acc / UNBIASED_SEEDS
        out[f"nearest/{scheme}/{bidir}"] = Q.quantized_ring_all_reduce(row, group, scheme, bidir,
                                                                       stochastic=False)
    acc = torch.zeros(512, dtype=torch.float64)
    for s in range(UNBIASED_SEEDS):
        acc += Q.compressed_all_reduce(row, group, s).double()
    out["unbiased/q8"] = acc / UNBIASED_SEEDS
    # integer buckets ride the full-precision ring, exact
    mixed = {"f": torch.from_numpy(_stack(n, 100, seed=9)[rank]),
             "i": torch.arange(6, dtype=torch.int32) + 6 * rank}
    for alg in ("q8_ring", "q8", "quant"):
        out[f"mixed/{alg}"] = B.bucketed_all_reduce(mixed, group, ReduceOp.SUM, alg, 1e-3)
    # DSML_QUANT=none: "quant" is the full-precision ring2, and under error
    # feedback the exact exchange delivers the residual and zeroes it
    os.environ["DSML_QUANT"] = "none"
    try:
        out["none/quant"] = B.bucketed_all_reduce(mixed, group, ReduceOp.AVG, "quant", 1e-3)
        out["none/ring2"] = B.bucketed_all_reduce(mixed, group, ReduceOp.AVG, "ring2", 1e-3)
        ef = {"f": torch.full((100,), 0.25), "i": torch.zeros(6)}
        out["none/ef"] = B.bucketed_all_reduce(mixed, group, ReduceOp.AVG, "quant", 1e-3,
                                               error_feedback=ef)
    finally:
        del os.environ["DSML_QUANT"]


def _mlp_batch():
    data = tdata.synthetic_classification(256, features=32, classes=4, seed=0)
    return torch.from_numpy(data.train_x[:64]), torch.from_numpy(data.train_y[:64])


def _dp_cases(mesh, out):
    """The dp step on the JAX suite's MLP setting, the hybrid step with a
    quantized dp_sync and grad_accum 2, and the Trainer with error
    feedback."""
    x, y = _mlp_batch()
    for alg, ef_on in (("xla", False), ("q8_ring", False), ("q8_ring2", True), ("q8", False),
                       ("q4_ring2", True)):
        model = MLP((32, 64, 4), device="cpu").init(0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
        step = make_dp_train_step(model, opt, mesh, alg, bucket_size_mb=1e-3,
                                  error_feedback=ef_on)
        key = f"dp/{alg}/{ef_on}"
        out[key] = [float(step(x, y)) for _ in range(DP_STEPS)]
        out[f"{key}/state"] = {k: t.clone() for k, t in model.state_dict().items()}
        out[f"{key}/wire"] = step.quant_wire_bytes
        out[f"{key}/ef"] = step.error_feedback
    hx = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (16, 128)))
    hy = torch.roll(hx, -1, 1)
    for sync in ("xla", "q8_ring2", "quant"):
        model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu").init(0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = thybrid.make_hybrid_train_step(model, opt, mesh, attn_impl="ring", grad_accum=2,
                                              dp_sync=sync, bucket_size_mb=1e-3)
        out[f"hybrid/{sync}"] = [float(step(hx, hy)) for _ in range(HYBRID_STEPS)]
        out[f"hybrid/{sync}/state"] = {k: t.clone() for k, t in model.state_dict().items()}
    data = tdata.synthetic_classification(1024, features=16, classes=4, seed=1)
    for alg, ef_on in (("ring", False), ("q8_ring2", True)):
        trainer = Trainer(MLP((16, 32, 4), device="cpu"),
                          TrainConfig(algorithm=alg, error_feedback=ef_on, epochs=2, batch_size=32,
                                      lr=0.05, seed=7), mesh=mesh)
        state, history, acc = trainer.train(data)
        out[f"trainer/{alg}"] = {"state": state, "history": history, "acc": acc}


def _rank_worker(rank, n, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(n, rank, os.path.join(tmp, "rendezvous"), "cpu")
    group = mesh.group("dp")
    out = {}
    _collective_cases(n, rank, group, out)
    _feedback_cases(n, rank, group, out)
    _property_cases(n, rank, group, out)
    if n == 2:
        _dp_cases(mesh, out)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{n: [rank outputs]} from one spawn per world size."""
    runs = {}
    for n in WORLD_SIZES:
        tmp = tmp_path_factory.mktemp(f"quant_sync{n}")
        mp.spawn(_rank_worker, args=(n, str(tmp)), nprocs=n, join=True)
        runs[n] = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in range(n)]
    return runs


def _jax_mesh(devices8, n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(devices8[:n]), ("dev",))


@pytest.fixture(scope="module")
def jax_runs(devices8):
    """{n: {key: [n, ...] numpy}}: the JAX package's deterministic ring and
    reduce-scatter (one program per world size) and three error-feedback
    syncs per EF case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.ops import quantization as JQ
    from dsml_tpu.parallel import bucketing as JB

    out = {}
    for n in WORLD_SIZES:
        mesh = _jax_mesh(devices8, n)
        xs = {str(s): jnp.asarray(_stack(n, s)) for s in SIZES}
        rxs = {str(s): jnp.asarray(_stack(n, s, seed=5)) for s in RS_SIZES}

        def fn(xs, rxs):
            res = {}
            for size in SIZES:
                for scheme, bidir in RING_CASES:
                    for mean in (True, False):
                        res[f"det/{size}/{scheme}/{bidir}/{mean}"] = JQ.quantized_ring_all_reduce(
                            xs[str(size)][0], "dev", scheme, bidirectional=bidir, mean=mean,
                            stochastic=False)[None]
            for size in RS_SIZES:
                for scheme in ("int8", "int4"):
                    shard, _ = JQ.quantized_flat_reduce_scatter(rxs[str(size)][0], "dev", scheme,
                                                                stochastic=False)
                    res[f"rs/{size}/{scheme}"] = shard[None]
            return res

        res = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("dev"), P("dev")),
                                    out_specs=P("dev"), check_vma=False))(xs, rxs)
        out[n] = {k: np.asarray(v) for k, v in res.items()}
        for alg, mb in EF_CASES:
            def sync(stacked, ef_stacked, alg=alg, mb=mb):
                tree = jax.tree.map(lambda l: l[0], stacked)
                ef = jax.tree.map(lambda l: l[0], ef_stacked)
                got, new_ef = JB.bucketed_all_reduce(tree, "dev", ReduceOp.AVG, alg, mb,
                                                     error_feedback=ef)
                return jax.tree.map(lambda l: l[None], (got, new_ef))

            run = jax.jit(jax.shard_map(sync, mesh=mesh, in_specs=(P("dev"), P("dev")),
                                        out_specs=P("dev"), check_vma=False))
            ef = None
            for step in range(EF_STEPS):
                stack = {k: jnp.asarray(v) for k, v in _ef_stack(n, step).items()}
                stack["h"] = stack["h"].astype(jnp.bfloat16)
                if ef is None:
                    ef = jax.tree.map(lambda l: jnp.zeros(l.shape, jnp.float32), stack)
                got, ef = run(stack, ef)
                out[n][f"ef/{alg}/{step}"] = jax.tree.map(np.asarray, got)
                out[n][f"ef_res/{alg}/{step}"] = jax.tree.map(np.asarray, ef)
    return out


# ---- bit for bit against the JAX package -----------------------------------------------


@pytest.mark.parametrize("scheme,bidir", RING_CASES)
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_deterministic_quantized_ring_bit_identical_to_jax(port_runs, jax_runs, n, scheme, bidir):
    """``quantized_ring_all_reduce(stochastic=False)`` on every rank equals
    the JAX package's bit for bit, under mean and sum, at sizes 17, 1000
    and 4096 (padded tails in one and two directions): the f32-reciprocal
    scale, the fused dequantize-and-add, rounding half to even and the
    owner's wire bytes in the gather all match."""
    for r, ranks in enumerate(port_runs[n]):
        for size in SIZES:
            for mean in (True, False):
                key = f"det/{size}/{scheme}/{bidir}/{mean}"
                got = ranks[key]
                assert got.dtype == torch.float32 and tuple(got.shape) == (size,), key
                np.testing.assert_array_equal(got.numpy(), jax_runs[n][key][r], err_msg=key)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_deterministic_quantized_reduce_scatter_bit_identical_to_jax(port_runs, jax_runs, n):
    """``quantized_flat_reduce_scatter(stochastic=False)`` equals the JAX
    package's shards bit for bit (int8 and int4, sizes that do not divide
    n); rank i holds segment i, and ``padded`` rounds to a multiple of n
    only (the JAX suite's ``test_quantized_reduce_scatter_layout_matches_
    flat`` bound against the exact mean holds too)."""
    for r, ranks in enumerate(port_runs[n]):
        for size in RS_SIZES:
            padded = -(-size // n) * n
            assert ranks[f"rs_padded/{size}"] == padded
            for scheme in ("int8", "int4"):
                key = f"rs/{size}/{scheme}"
                assert tuple(ranks[key].shape) == (padded // n,)
                np.testing.assert_array_equal(ranks[key].numpy(), jax_runs[n][key][r], err_msg=key)
            x = _stack(n, size, seed=5)
            exact = np.zeros(padded, np.float32)
            exact[:size] = x.mean(0)
            seg = exact[r * padded // n:(r + 1) * padded // n]
            bound = n * np.abs(x).max() / 127
            assert np.abs(ranks[f"rs/{size}/int8"].numpy() - seg).max() < bound
            assert np.abs(ranks[f"rs_sto/{size}"].numpy() - seg).max() < bound


@pytest.mark.parametrize("alg,mb", EF_CASES)
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_error_feedback_sync_bit_identical_to_jax(port_runs, jax_runs, n, alg, mb):
    """Three repeated error-feedback syncs of a tree with f32, bf16 and
    int32 leaves (``bucketed_all_reduce(..., error_feedback=)``): every
    step's result and new residual equal the JAX package's bit for bit,
    on every rank (the residual carries the fused ``adjusted − q·s``)."""
    for r, ranks in enumerate(port_runs[n]):
        for step in range(EF_STEPS):
            for what in ("ef", "ef_res"):
                key = f"{what}/{alg}/{step}"
                for leaf, t in ranks[key].items():
                    want = jax_runs[n][key][leaf][r]
                    want_dtype = "float32" if what == "ef_res" else want.dtype.name
                    assert str(t.dtype).removeprefix("torch.") == want_dtype, (key, leaf)
                    np.testing.assert_array_equal(_bits(t), _jax_bits(want), err_msg=f"{key}/{leaf}")
        res = ranks[f"ef_res/{alg}/{EF_STEPS - 1}"]
        assert float(res["w"].abs().max()) > 0 and float(res["i"].abs().max()) == 0


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantize_roundtrip_bit_identical_to_jax(scheme):
    """``quantize_roundtrip`` and the error-feedback residual ``x −
    roundtrip(x)`` equal the JAX package's (jitted, as the EF sync runs
    them) bit for bit at sizes 17, 1000 and 4096, within half a quantum of
    the input (the JAX suite's bound)."""
    import jax
    import jax.numpy as jnp

    from dsml_tpu.ops import quantization as JQ

    jit_rt = jax.jit(lambda x: JQ.quantize_roundtrip(x, scheme))
    jit_res = jax.jit(lambda x: x - JQ.quantize_roundtrip(x, scheme))
    qmax = Q.get_scheme(scheme).qmax
    for size in SIZES:
        x = np.random.default_rng(size).standard_normal(size).astype(np.float32) * 3
        got = Q.quantize_roundtrip(torch.from_numpy(x), scheme)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jit_rt(jnp.asarray(x))))
        res = Q._roundtrip_residual(torch.from_numpy(x), scheme)
        np.testing.assert_array_equal(res.numpy(), np.asarray(jit_res(jnp.asarray(x))))
        assert np.abs(got.numpy() - x).max() <= np.abs(x).max() / qmax / 2 + 1e-6


def test_seeds_bit_identical_to_jax():
    """The int32 seeds equal the JAX package's, wraps included: the hop
    dither (``_dither_seed``: the chunk's bitcast sum + seed · 1_000_003 +
    rank · 7919 + salt), the bucket seed (``_q8_bucket_seed``, f32 and bf16
    buckets) and ``compressed_all_reduce``'s ``seed · 1_000_003 + rank``."""
    import jax.numpy as jnp

    from dsml_tpu.ops import quantization as JQ
    from dsml_tpu.parallel import bucketing as JB

    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal((4, 512)) * 1e4).astype(np.float32)
    for seed in (0, 7, -5, 123456789, 2**31 - 1, -2**31):
        jbase = jnp.asarray(seed, jnp.int32) * jnp.int32(1_000_003)
        for rank in (0, 1, 3):
            for salt in (0, 3, 1_000, 1_001):
                want = int(JQ._dither_seed(jnp.asarray(blocks), jbase, jnp.int32(rank), salt))
                got = Q._dither_seed(torch.from_numpy(blocks), Q._seed_base(seed, "cpu"), rank, salt)
                assert got.dtype == torch.int32 and int(got) == want, (seed, rank, salt)
            want = int(jbase + jnp.int32(rank))
            assert int(Q._wrap_i32(Q._seed_base(seed, "cpu") + rank)) == want, (seed, rank)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.from_numpy(rng.standard_normal(5000).astype(np.float32) * 1e3).to(dtype)
        jflat = jnp.asarray(flat.float().numpy())
        if dtype == torch.bfloat16:
            jflat = jflat.astype(jnp.bfloat16)
        for b in (0, 1, 49, 271_000):
            got = B._q8_bucket_seed(flat, b)
            assert got.dtype == torch.int32 and int(got) == int(JB._q8_bucket_seed(jflat, b)), b


QUANT_ENV = (None, "", "int8", "int4", "int4:ring", "int8:ring2", "int8:ring", "none", "none:ring",
             "none:bogus", "int2:ring", "int8:ring3", "garbage:value",
             "float32=int8:ring,bfloat16=int4:ring2", "bfloat16=int4,default=int8:ring2",
             "bfloat16=none,default=int4:ring", "float32=", "=,", ",,", "default=none:ring2",
             " int4 : ring ")


def test_quant_algorithm_for_equals_jax(monkeypatch):
    """``DSML_QUANT`` resolves alike for every dtype, keyed by the JAX
    dtype name (a torch dtype or its name), malformed values and ``none``
    included."""
    import jax.numpy as jnp

    from dsml_tpu.ops import quantization as JQ

    dtypes = {torch.float32: "float32", torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
              torch.float64: "float64", "float32": "float32", "bfloat16": "bfloat16"}
    for value in QUANT_ENV:
        if value is None:
            monkeypatch.delenv("DSML_QUANT", raising=False)
        else:
            monkeypatch.setenv("DSML_QUANT", value)
        for tdt, jdt in dtypes.items():
            assert Q.quant_algorithm_for(tdt) == JQ.quant_algorithm_for(jdt), (value, tdt)


def test_wire_bytes_equal_jax():
    """``quantized_ring_wire_bytes``, ``compressed_gather_wire_bytes`` and
    ``wire_bytes_per_block`` over a grid, and the GPT-2-small gradient's
    numbers (124,439,808 elements at n = 2)."""
    from dsml_tpu.ops import quantization as JQ

    for n_elems in (1, 17, 1000, 4096, 101770, 1 << 20, 124_439_808):
        for n in (1, 2, 3, 4, 8):
            assert Q.compressed_gather_wire_bytes(n_elems, n) == \
                JQ.compressed_gather_wire_bytes(n_elems, n)
            for scheme in ("int8", "int4"):
                for bidir in (False, True):
                    assert Q.quantized_ring_wire_bytes(n_elems, n, scheme, bidir) == \
                        JQ.quantized_ring_wire_bytes(n_elems, n, scheme, bidir)
    for name, block in (("int8", 512), ("int4", 512), ("int8", 128), ("int4", 6)):
        assert Q.get_scheme(name, block).wire_bytes_per_block == \
            JQ.get_scheme(name, block).wire_bytes_per_block
    grad = 124_439_808
    assert Q.quantized_ring_wire_bytes(grad, 2, "int8") == 125_412_768
    assert Q.quantized_ring_wire_bytes(grad, 2, "int8", True) == 125_412_768
    assert Q.quantized_ring_wire_bytes(grad, 2, "int4", True) == 63_192_480
    assert Q.compressed_gather_wire_bytes(grad, 2) == 125_412_252
    assert Q.quantized_ring_wire_bytes(2_097_152, 2, "int8") == 2_113_536
    assert Q.quantized_ring_wire_bytes(2_097_152, 2, "int4") == 1_064_960


@pytest.mark.parametrize("bucket_mb", [1e-3, 4.0])
def test_plan_quant_wire_bytes_equals_jax_on_gpt2_tiny(bucket_mb, monkeypatch):
    """``plan_quant_wire_bytes`` over GPT-2-tiny's parameters equals the
    JAX package's for every quantized algorithm at n = 2, 3, 4 and 8, with
    ``DSML_QUANT`` per dtype too."""
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.parallel import bucketing as JB

    jplan = JB.plan_buckets(GPT2(GPT2Config.tiny()).init(0), bucket_mb)
    plan = B.plan_buckets(dict(tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
                               .named_parameters()), bucket_mb)
    assert plan.buckets == jplan.buckets
    for env in (None, "int4:ring", "float32=none"):
        if env is None:
            monkeypatch.delenv("DSML_QUANT", raising=False)
        else:
            monkeypatch.setenv("DSML_QUANT", env)
        for alg in ("q8", "q8_ring", "q8_ring2", "q4_ring", "q4_ring2", "quant"):
            for n in (2, 3, 4, 8):
                assert B.plan_quant_wire_bytes(plan, n, alg) == \
                    JB.plan_quant_wire_bytes(jplan, n, alg), (env, alg, n)


# ---- the JAX suite's properties where bits cannot match ---------------------------------


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_stochastic_ring_close_identical_across_ranks_and_seeded(port_runs, n):
    """Stochastic rounding (``test_quantized_ring_close_and_identical_
    across_ranks``): within n·max|x|/qmax of the exact mean, bit-identical
    on every rank, the same bits for the same seed and other bits for
    another."""
    runs = port_runs[n]
    for size in SIZES:
        x = _stack(n, size)
        for scheme, bidir in RING_CASES:
            key = f"sto/{size}/{scheme}/{bidir}"
            a = runs[0][f"{key}/a"]
            for ranks in runs:
                assert torch.equal(ranks[f"{key}/a"], a) and torch.equal(ranks[f"{key}/b"], a), key
                assert torch.equal(ranks[f"{key}/c"], runs[0][f"{key}/c"]), key
            assert not torch.equal(runs[0][f"{key}/c"], a), key
            bound = n * np.abs(x).max() / Q.get_scheme(scheme).qmax
            assert np.abs(a.numpy() - x.mean(0)).max() < bound, key


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_q8_gather_close_identical_across_ranks_and_seeded(port_runs, n):
    """``compressed_all_reduce`` (``test_compressed_all_reduce_close_to_
    exact``): within max|x|/127 of the exact mean, the same on every rank,
    determined by the seed."""
    runs = port_runs[n]
    for size in SIZES:
        x = _stack(n, size)
        a = runs[0][f"q8/{size}/a"]
        for ranks in runs:
            assert torch.equal(ranks[f"q8/{size}/a"], a) and torch.equal(ranks[f"q8/{size}/b"], a)
        assert not torch.equal(runs[0][f"q8/{size}/c"], a)
        assert np.abs(a.numpy() - x.mean(0)).max() < np.abs(x).max() / 127


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_stochastic_rounding_unbiased_over_seeds(port_runs, n):
    """Averaged over 32 seeds, the stochastic ring (every scheme and
    direction) and the q8 gather land on the exact mean of a row whose
    entries sit 0.45 of a quantum off the grid, within 0.15 of a quantum,
    where rounding to nearest stays 0.45 off (so the check is not
    vacuous)."""
    row = _between_quanta_row().double().numpy()
    for ranks in port_runs[n]:
        for scheme, bidir in RING_CASES:
            quantum = 1.0 / Q.get_scheme(scheme).qmax
            err = (ranks[f"unbiased/{scheme}/{bidir}"].numpy() - row)[1:].mean()
            nearest = (ranks[f"nearest/{scheme}/{bidir}"].double().numpy() - row)[1:].mean()
            assert abs(err) < 0.15 * quantum, (scheme, bidir, err / quantum)
            assert abs(nearest) > 0.3 * quantum, (scheme, bidir, nearest / quantum)
        err = (ranks["unbiased/q8"].numpy() - row)[1:].mean()
        assert abs(err) < 0.15 / 127, err * 127


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_quantized_ring_pad_never_leaks(port_runs, n):
    """``test_quantized_ring_pad_never_leaks`` at sizes 17, 1000 and 4096:
    an all-ones payload comes back as exact ones (a constant block
    quantizes exactly; a pad lane leaking in would move it a quantum)."""
    for ranks in port_runs[n]:
        for size in SIZES:
            for scheme, bidir in RING_CASES:
                np.testing.assert_allclose(ranks[f"ones/{size}/{scheme}/{bidir}"].numpy(),
                                           np.ones(size, np.float32), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_error_feedback_recovers_sub_quantum_gradients(port_runs, n):
    """The JAX suite's EF property: entries below half a quantum vanish
    under deterministic rounding without error feedback, and with it the
    delivered mass over 10 steps is within 1.5 quanta of the true total."""
    for ranks in port_runs[n]:
        want = SUB_QUANTUM_STEPS * 0.003
        assert ranks["sub_quantum/False"][1:].mean().item() < want / 10
        assert abs(ranks["sub_quantum/True"][1:].mean().item() - want) < 1.5 / 127


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_integer_buckets_exact_and_quant_none(port_runs, n):
    """Integer buckets ride the full-precision ring under every quantized
    algorithm and stay exact; ``DSML_QUANT=none`` makes ``quant`` the
    full-precision ring2 (bit for bit), and under error feedback that
    exact exchange delivers the residual and zeroes it."""
    f = _stack(n, 100, seed=9)
    ints = sum(np.arange(6, dtype=np.int32) + 6 * r for r in range(n))
    for ranks in port_runs[n]:
        for alg in ("q8_ring", "q8", "quant"):
            got = ranks[f"mixed/{alg}"]
            assert got["i"].dtype == torch.int32
            np.testing.assert_array_equal(got["i"].numpy(), ints)
            assert np.abs(got["f"].numpy() - f.sum(0)).max() < n * n * np.abs(f).max() / 127
        for k in ("f", "i"):
            assert torch.equal(ranks["none/quant"][k], ranks["none/ring2"][k]), k
        got, ef = ranks["none/ef"]
        np.testing.assert_allclose(got["f"].numpy(), f.mean(0) + 0.25, rtol=1e-6, atol=1e-6)
        assert not ef["f"].any() and not ef["i"].any()


# ---- what raises ---------------------------------------------------------------------------


QUANTIZED = ("q8", "q8_ring", "q8_ring2", "q4_ring", "q4_ring2", "quant")


@pytest.mark.parametrize("algorithm", QUANTIZED)
def test_quantized_sync_rejects_non_linear_ops(algorithm):
    """SUM/AVG only, bucketed and single-buffer alike, for every quantized
    algorithm (``test_quantized_rejects_non_linear_ops_single_buffer_too``)."""
    group = RingGroup(None, [0, 1], 0, "cpu")
    for op in (ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PROD):
        for mb in (None, 4.0):
            with pytest.raises(ValueError, match="SUM/AVG"):
                B.bucketed_all_reduce({"w": torch.zeros(4)}, group, op, algorithm, mb)


def test_quantized_collectives_reject_integer_payloads():
    group = RingGroup(None, [0, 1], 0, "cpu")
    with pytest.raises(ValueError, match="float"):
        Q.quantized_ring_all_reduce(torch.zeros(64, dtype=torch.int32), group)
    with pytest.raises(ValueError, match="float"):
        Q.quantized_flat_reduce_scatter(torch.zeros(64, dtype=torch.int32), group)
    with pytest.raises(ValueError, match="float"):
        B.bucketed_all_reduce([torch.zeros(8, dtype=torch.int32)], group, ReduceOp.SUM, "q8_ring")


def test_error_feedback_requires_a_quantized_ring():
    """``error_feedback`` with a full-precision algorithm or the q8 gather
    raises ``ValueError`` in the dp step and the bucketed sync
    (``test_dp_error_feedback_requires_quantized_ring``), and so does the
    ``Trainer``'s."""
    model = MLP((4, 2), device="cpu").init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    group = RingGroup(None, [0], 0, "cpu")
    for algorithm in ("ring", "q8", "xla", "naive"):
        with pytest.raises(ValueError, match="error_feedback"):
            make_dp_train_step(model, opt, None, algorithm=algorithm, error_feedback=True)
        with pytest.raises(ValueError, match="error_feedback"):
            B.bucketed_all_reduce([torch.ones(3)], group, ReduceOp.AVG, algorithm, 1.0,
                                  error_feedback=[torch.zeros(3)])
    data = tdata.synthetic_classification(64, 4, 2)
    with pytest.raises(ValueError, match="error_feedback"):
        Trainer(model, TrainConfig(epochs=1, batch_size=8, error_feedback=True)).train(data)


def test_single_buffer_q8_of_a_bf16_tree_raises_as_in_jax(devices8):
    """The JAX package's single-buffer q8 sync bitcasts the raveled vector
    to int32 for its seed, which a bf16 vector cannot be: it raises
    ``ValueError``, and so does the port. The bucketed q8 sync casts to
    f32 first and runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.parallel import bucketing as JB

    def fn(s):
        return JB.bucketed_all_reduce({"w": s[0]}, "dev", ReduceOp.AVG, "q8", None)["w"][None]

    with pytest.raises(ValueError):
        jax.jit(jax.shard_map(fn, mesh=_jax_mesh(devices8, 2), in_specs=P("dev"),
                              out_specs=P("dev"), check_vma=False))(jnp.zeros((2, 64), jnp.bfloat16))
    group = RingGroup(None, [0, 1], 0, "cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        B.bucketed_all_reduce({"w": torch.zeros(64, dtype=torch.bfloat16)}, group, ReduceOp.AVG,
                              "q8", None)
    one = RingGroup(None, [0], 0, "cpu")
    got = B.bucketed_all_reduce({"w": torch.ones(64, dtype=torch.bfloat16)}, one, ReduceOp.AVG,
                                "q8", 4.0)
    assert torch.equal(got["w"], torch.ones(64, dtype=torch.bfloat16))


# ---- the dp step, the hybrid step and the Trainer (dp = 2) ---------------------------------


def _dev(got, ref):
    return max(abs(a - b) / max(abs(b), 1e-2) for a, b in zip(got, ref))


@pytest.mark.parametrize("alg,ef_on", [("q8_ring", False), ("q8_ring2", True), ("q8", False)])
def test_dp_step_quantized_tracks_the_xla_trajectory(port_runs, alg, ef_on):
    """``test_dp_step_quant_ring_matches_xla_trajectory``'s setting and bar
    (MLP 32-64-4, AdamW 1e-2, 1 KiB buckets, 5 steps, dev < 0.06) at dp =
    2, against the port's own ``xla`` run: quantized syncs, with and
    without error feedback, and the q8 gather (its loss also falls)."""
    for ranks in port_runs[2]:
        ref = ranks["dp/xla/False"]
        got = ranks[f"dp/{alg}/{ef_on}"]
        assert all(np.isfinite(got)) and got[-1] < got[0], (alg, got)
        assert _dev(got, ref) < TRAJECTORY_DEV, (alg, ef_on, got, ref)


def test_dp_quantized_replicas_identical_and_step_state(port_runs):
    """Every rank receives the same dequantized bytes, so the replicas stay
    identical; ``step.error_feedback`` holds this rank's f32 residuals (one
    per parameter in ``named_params`` order, nonzero after a step, their
    own per rank) and ``step.quant_wire_bytes`` the plan's wire bytes."""
    a, b = port_runs[2]
    model = MLP((32, 64, 4), device="cpu")
    params = [p for _, p in named_params(model)]
    for key in ("dp/q8_ring/False", "dp/q8_ring2/True", "dp/q8/False", "dp/q4_ring2/True",
                "hybrid/q8_ring2", "hybrid/quant"):
        assert a[key] == b[key] and a[key][-1] < a[key][0], key
        for name, t in a[f"{key}/state"].items():
            assert torch.equal(t, b[f"{key}/state"][name]), (key, name)
    plan = B.plan_buckets(params, 1e-3)
    for alg, ef_on in (("q8_ring", False), ("q8_ring2", True), ("q8", False)):
        assert a[f"dp/{alg}/{ef_on}/wire"] == B.plan_quant_wire_bytes(plan, 2, alg)
    assert a["dp/xla/False/wire"] == {} and a["dp/q8_ring/False/ef"] is None
    ef_a, ef_b = a["dp/q8_ring2/True/ef"], b["dp/q8_ring2/True/ef"]
    assert [tuple(t.shape) for t in ef_a] == [tuple(p.shape) for p in params]
    assert all(t.dtype == torch.float32 for t in ef_a) and any(t.abs().max() > 0 for t in ef_a)
    assert any(not torch.equal(x, y) for x, y in zip(ef_a, ef_b))


def test_dp_step_error_feedback_is_settable():
    """The residuals live in the step and a caller may replace them (what
    checkpoint restore needs): on one rank of a group of one the sync is
    the identity and the residuals stay as set."""
    model = MLP((4, 3), device="cpu").init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_dp_train_step(model, opt, None, "q8_ring2", error_feedback=True)
    assert [t.shape for t in step.error_feedback] == [p.shape for _, p in named_params(model)]
    assert not any(t.any() for t in step.error_feedback)
    step.error_feedback = [torch.full_like(t, 0.5) for t in step.error_feedback]
    loss = step(torch.ones(2, 4), torch.zeros(2, dtype=torch.long))
    assert torch.isfinite(loss) and all(bool((t == 0.5).all()) for t in step.error_feedback)


def test_hybrid_quantized_dp_sync_with_grad_accum(port_runs):
    """The hybrid step on a dp = 2 mesh with grad_accum 2 and a quantized
    ``dp_sync`` (``q8_ring2``, ``quant``), synced once per step through
    ``bucketed_all_reduce``: the loss tracks the ``xla`` sync's within the
    JAX suite's quantized bar (dev < 0.06) and falls."""
    for ranks in port_runs[2]:
        ref = ranks["hybrid/xla"]
        for sync in ("q8_ring2", "quant"):
            got = ranks[f"hybrid/{sync}"]
            assert got[-1] < got[0] and _dev(got, ref) < TRAJECTORY_DEV, (sync, got, ref)


def test_trainer_q8_ring2_error_feedback_at_dp2(port_runs):
    """The dp = 2 ``Trainer`` with ``algorithm="q8_ring2",
    error_feedback=True``: two epochs whose losses track the ``ring`` run
    within dev < 0.06, a test accuracy within 2% of it, and identical
    replicas."""
    a, b = port_runs[2]
    ref, got = a["trainer/ring"], a["trainer/q8_ring2"]
    losses = [h["avg_loss"] for h in got["history"]]
    assert _dev(losses, [h["avg_loss"] for h in ref["history"]]) < TRAJECTORY_DEV
    assert abs(got["acc"] - ref["acc"]) <= 0.02 and got["acc"] > 0.5
    assert [h["avg_loss"] for h in b["trainer/q8_ring2"]["history"]] == losses
    assert all(torch.equal(t, b["trainer/q8_ring2"]["state"][k]) for k, t in got["state"].items())

