"""The port's expert layer (``models/gpt2.py::GPT2._moe_block``, Mixtral in
``models/llama.py``) and ``ops.collectives.all_to_all`` against the JAX
package, on the CPU.

Single-process tests hold the block on one device to the JAX block
(routing exactly, outputs and gradients to 1e-5 relative), the routing's
memory, the Llama experts, decode, the batcher and the weight plumbing.
Module-scoped fixtures spawn gloo meshes once (n = 2 and 4 ranks, as
``tests/test_torch_tp.py`` does): every rank exchanges the all_to_all cases
(at n = 3 over three of the four ranks); both run the expert-parallel
GPT-2 tiny at tp = n (the a2a branch and the fallback), and the 4-rank
one also Llama tiny with experts at dp 2 × tp 2 and fsdp 2 × tp 2 and
GPT-2 tiny with experts under 1F1B at pp 2 × tp 2. Each rank
takes its shard of the JAX ``init`` weights through ``params_from_jax(tree,
model=rank_model)``."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models import model_by_family
from dsml_tpu_torch.models.common import quantize_weights_blocked, quantize_weights_int8
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.ops import collectives as C
from dsml_tpu_torch.parallel import hybrid as thybrid
from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from dsml_tpu_torch.parallel.peer import RingGroup
from dsml_tpu_torch.serving import ContinuousBatcher

SEED = 31
BLOCK_RTOL = 1e-5  # the block on one device against the JAX block
LOSS_RTOL = 5e-4  # tests/test_gpt2.py::test_moe_spmd_matches_single_device
GRAD_TOL = dict(rtol=1e-3, atol=1e-7)  # tests/test_gpt2.py::test_moe_gradients_match_single_device
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_generate.py::test_moe_decode_matches_full_forward
A2A_PAIRS = ((0, 1), (0, 0))  # (split, concat) of _moe_block's dispatch and return
A2A_SHAPE = (12, 5, 3)  # dim 0 splits over 2, 3 and 4 ranks
FALLBACK_TOKENS = 3  # a [1, 3, d] block input: 3 tokens split over neither 2 nor 4 ranks


def _batch(seed=32, batch=4, seq=64, vocab=512):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _a2a_inputs(n, split, concat):
    """Per-rank inputs [n, *A2A_SHAPE] of an all_to_all case and cotangents
    [n, *its output's shape]."""
    rng = np.random.default_rng(40 + 10 * n + 3 * split + concat)
    out = list(A2A_SHAPE)
    out[split] //= n
    out[concat] *= n
    return (rng.standard_normal((n, *A2A_SHAPE)).astype(np.float32),
            rng.standard_normal((n, *out)).astype(np.float32))


def _llama_cfgs():
    """(port, JAX) Llama tiny with 4 experts and no overflow (capacity 8):
    dp and pp route per replica and microbatch, which equals one device
    only when nothing is dropped."""
    from dsml_tpu.models.llama import LlamaConfig

    return (dataclasses.replace(tllama.LlamaConfig.tiny(n_experts=4), capacity_factor=8.0),
            dataclasses.replace(LlamaConfig.tiny(n_experts=4), capacity_factor=8.0))


@pytest.fixture(scope="module")
def jax_side(devices8):
    """The JAX references: GPT-2 tiny (4 experts) weights, loss and
    gradients; the fallback block's output; Llama tiny (4 experts) weights,
    loss and gradients; ``lax.all_to_all`` outputs and input cotangents."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import Llama

    x, y = _batch()
    out = {}
    model = GPT2(GPT2Config.tiny(n_experts=4))
    params = model.init(SEED)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, x, y)
    xf = np.random.default_rng(33).standard_normal((1, FALLBACK_TOKENS, 64)).astype(np.float32)
    out["gpt2"] = {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
                   "grads": params_from_jax(jax.tree.map(np.asarray, grads)), "fallback_x": xf,
                   "fallback_out": np.asarray(model._moe_block(params["layers"][0]["moe"],
                                                               jnp.asarray(xf), None))}
    lmodel = Llama(_llama_cfgs()[1])
    lparams = lmodel.init(SEED)
    loss, grads = jax.jit(jax.value_and_grad(lmodel.loss))(lparams, x, y)
    out["llama"] = {"params": jax.tree.map(np.asarray, lparams), "loss": float(loss),
                    "grads": params_from_jax(jax.tree.map(np.asarray, grads))}
    out["a2a"] = {}
    for n in (2, 3, 4):
        mesh = Mesh(np.asarray(devices8[:n]), ("dev",))
        for split, concat in A2A_PAIRS:
            xs, cts = _a2a_inputs(n, split, concat)

            def f(a, split=split, concat=concat):
                return lax.all_to_all(a[0], "dev", split, concat, tiled=True)[None]

            sharded = jax.shard_map(f, mesh=mesh, in_specs=P("dev"), out_specs=P("dev"),
                                    check_vma=False)
            fwd, vjp = jax.vjp(sharded, jnp.asarray(xs))
            (back,) = vjp(jnp.asarray(cts))
            out["a2a"][(n, split, concat)] = (np.asarray(fwd), np.asarray(back))
    return out


# ---- the spawned meshes ------------------------------------------------------


class _Sorts(TorchDispatchMode):
    """Records the length of every 1-D integer sort (the routing's argsort
    of expert ids)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.sort and args[0].ndim == 1 \
                and not args[0].dtype.is_floating_point:
            self.sizes.append(int(args[0].shape[0]))
        return func(*args, **(kwargs or {}))


def _a2a_cases(group, n):
    out = {}
    for split, concat in A2A_PAIRS:
        xs, cts = _a2a_inputs(n, split, concat)
        x = torch.from_numpy(xs[group.rank]).requires_grad_()
        y = C.all_to_all(x, group, split, concat)
        y.backward(torch.from_numpy(cts[group.rank]))
        out[(split, concat)] = (y.detach(), x.grad)
    return out


def _ep_cases(mesh, trees, fallback_x):
    """GPT-2 tiny with 4 experts on this tp rank: loss, gradients, the
    all_to_all count and the routing sorts' sizes of one forward and
    backward; then the fallback block on 3 tokens."""
    group = mesh.group("tp")
    x, y = (torch.from_numpy(t).long() for t in _batch())
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="cpu", tp_group=group)
    model.load_state_dict(params_from_jax(trees["gpt2"], model=model))
    C.reset_stats()
    with _Sorts() as sorts:
        loss = model.loss(x, y)
    fwd_a2a = C.STATS["all_to_all"]
    loss.backward()
    res = {"loss": float(loss.detach()), "sorts": sorts.sizes, "a2a_forward": fwd_a2a,
           "a2a_step": C.STATS["all_to_all"],
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            out = model._moe_block(model.layers[0]["moe"], torch.from_numpy(fallback_x))
    res["fallback"] = {"out": out, "warnings": [str(w.message) for w in caught]}
    return res


def _dp_tp_cases(tmp, trees):
    """Llama tiny with 4 experts on a dp 2 × tp 2 mesh: the step's loss and
    synced gradients from the JAX weights (SGD at lr 0), then six Adam
    steps."""
    mesh = build_mesh(MeshSpec(dp=2, tp=2), dist.get_rank(), 4,
                      os.path.join(tmp, "dp_tp", "rendezvous"), "cpu")
    x, y = (torch.from_numpy(t) for t in _batch())
    cfg = _llama_cfgs()[0]
    model = thybrid.hybrid_model(tllama.Llama, cfg, mesh)
    model.load_state_dict(params_from_jax(trees["llama"], model=model))
    step = thybrid.make_hybrid_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                          mesh, attn_impl="xla")
    res = {"coords": mesh.coords, "loss": float(step(x, y)),
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = thybrid.make_hybrid_train_step(model, opt, mesh, attn_impl="xla")
    res["losses"] = [float(step(x, y)) for _ in range(6)]
    mesh.close()
    return res


def _fsdp_tp_cases(tmp):
    """Llama tiny with 4 experts at fsdp 2 × tp 2: ZeRO-3 shards of the
    seed's weights (``init_hybrid``: the expert specs take fsdp on their
    first free divisible dim), the step's loss, then six Adam steps."""
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), dist.get_rank(), 4,
                      os.path.join(tmp, "fsdp_tp", "rendezvous"), "cpu")
    x, y = (torch.from_numpy(t) for t in _batch())
    model = thybrid.hybrid_model(tllama.Llama, _llama_cfgs()[0], mesh)
    model, opt = thybrid.init_hybrid(model, torch.optim.Adam(model.parameters(), lr=1e-2), mesh,
                                     SEED)
    step = thybrid.make_hybrid_train_step(model, opt, mesh, attn_impl="xla")
    res = {"coords": mesh.coords, "losses": [float(step(x, y)) for _ in range(6)],
           "expert_shard": tuple(model.fsdp.shard_of["layers.0.moe.w_in"].shape)}
    mesh.close()
    return res


def _pp_tp_cases(tmp, trees):
    """GPT-2 tiny with 4 experts at pp 2 × tp 2 under 1F1B (2
    microbatches), six Adam(1e-3) steps (``tests/test_pipeline.py::
    test_1f1b_converges_with_moe``)."""
    mesh = build_mesh(MeshSpec(pp=2, tp=2), dist.get_rank(), 4,
                      os.path.join(tmp, "pp_tp", "rendezvous"), "cpu")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 512, (8, 128)))
    y = torch.roll(x, -1, 1)
    model = thybrid.hybrid_model(tgpt2.GPT2, tgpt2.GPT2Config.tiny(n_experts=4), mesh)
    model.load_state_dict(params_from_jax(trees["gpt2"], model=model))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = thybrid.make_hybrid_train_step(model, opt, mesh, n_microbatches=2, schedule="1f1b")
    res = {"coords": mesh.coords, "losses": [float(step(x, y)) for _ in range(6)]}
    mesh.close()
    return res


def _worker(rank, tmp, n, trees, fallback_x):
    torch.set_num_threads(1)
    os.makedirs(os.path.join(tmp, "tp"), exist_ok=True)
    mesh = build_mesh(MeshSpec(tp=n), rank, n, os.path.join(tmp, "tp", "rendezvous"), "cpu")
    res = {"a2a": {n: _a2a_cases(mesh.group("tp"), n)}, "ep": _ep_cases(mesh, trees, fallback_x)}
    mesh.close()
    if n == 4:
        # the n = 3 exchange: a gloo group of ranks 0-2 (every rank creates it)
        pg = dist.new_group([0, 1, 2])
        if rank < 3:
            res["a2a"][3] = _a2a_cases(RingGroup(pg, [0, 1, 2], rank, "cpu"), 3)
        for sub in ("dp_tp", "fsdp_tp", "pp_tp"):
            os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        res["dp_tp"] = _dp_tp_cases(tmp, trees)
        res["fsdp_tp"] = _fsdp_tp_cases(tmp)
        res["pp_tp"] = _pp_tp_cases(tmp, trees)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_side):
    """{n: [rank outputs]} from one spawn per world size (the 4-rank one
    also exchanges over three of its ranks)."""
    trees = {fam: jax_side[fam]["params"] for fam in ("gpt2", "llama")}
    out = {}
    for n in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"moe{n}"))
        mp.spawn(_worker, args=(tmp, n, trees, jax_side["gpt2"]["fallback_x"]), nprocs=n,
                 join=True)
        out[n] = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                  for r in range(n)]
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_to_all_matches_lax(runs, jax_side, n):
    """Forward and backward of both axis pairs equal ``lax.all_to_all``
    (tiled) and its transpose exactly: the exchange moves values only."""
    for r, ranks in enumerate(runs[4 if n == 3 else n][:n]):
        for pair in A2A_PAIRS:
            fwd, back = jax_side["a2a"][(n, *pair)]
            got_fwd, got_back = ranks["a2a"][n][pair]
            np.testing.assert_array_equal(got_fwd.numpy(), fwd[r], err_msg=str(pair))
            np.testing.assert_array_equal(got_back.numpy(), back[r], err_msg=str(pair))


@pytest.mark.parametrize("n", [2, 4])
def test_ep_loss_and_gradients_match_jax(runs, jax_side, n):
    """Expert parallelism at tp = n (the a2a branch: 256 tokens split over
    n): the loss equals the JAX single-device loss and every gradient,
    gathered over the ranks, the JAX gradient — the experts their slices,
    the gate and every replicated leaf whole and bit-identical on every
    rank (no ep× mis-scale: ``test_moe_gradients_match_single_device``)."""
    ranks = runs[n]
    specs = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="meta").param_specs()
    want = jax_side["gpt2"]["grads"]
    for r in ranks:
        assert np.isclose(r["ep"]["loss"], jax_side["gpt2"]["loss"], rtol=LOSS_RTOL)
    assert set(ranks[0]["ep"]["grads"]) == set(want)
    for name, spec in specs.items():
        parts = [r["ep"]["grads"][name] for r in ranks]
        got = torch.cat(parts, spec.index("tp")) if "tp" in spec else parts[0]
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
        if "tp" not in spec:
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), name


@pytest.mark.parametrize("n", [2, 4])
def test_ep_dispatch_rides_all_to_all_and_routes_the_local_slice(runs, n):
    """Two all_to_all calls a MoE layer forward (dispatch and return), two
    more in its backward; every routing sort handles the rank's N/ep
    assignments and none the full N (``test_moe_routing_scales_with_local_
    slice_under_ep``)."""
    layers, n_assign = 2, 4 * 64 * 2
    for r in runs[n]:
        assert r["ep"]["a2a_forward"] == 2 * layers
        assert r["ep"]["a2a_step"] == 4 * layers
        assert r["ep"]["sorts"] and set(r["ep"]["sorts"]) == {n_assign // n}


@pytest.mark.parametrize("n", [2, 4])
def test_ep_fallback_warns_and_equals_one_device(runs, jax_side, n):
    """3 tokens split over neither 2 nor 4 ranks: the JAX warning, and the
    replicated dispatch + all-reduce equals the JAX single-device block."""
    for r in runs[n]:
        fb = r["ep"]["fallback"]
        assert any("a2a dispatch disabled" in w for w in fb["warnings"]), fb["warnings"]
        np.testing.assert_allclose(fb["out"].numpy(), jax_side["gpt2"]["fallback_out"],
                                   rtol=BLOCK_RTOL, atol=1e-7)


def test_dp_tp_hybrid_step_matches_one_device_and_trains(runs, jax_side):
    """Llama tiny with 4 experts through the hybrid step at dp 2 × tp 2:
    the loss and the synced gradients (gathered over tp) equal the JAX
    single-device ones; Adam then lowers the loss, the same on every rank."""
    ranks = [r["dp_tp"] for r in runs[4]]
    want = jax_side["llama"]["grads"]
    specs = tllama.Llama(_llama_cfgs()[0], device="meta").param_specs()
    for r in ranks:
        assert np.isclose(r["loss"], jax_side["llama"]["loss"], rtol=LOSS_RTOL)
        assert r["losses"] == ranks[0]["losses"]
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses
    replica = sorted((r for r in ranks if r["coords"]["dp"] == 0), key=lambda r: r["coords"]["tp"])
    for name, spec in specs.items():
        parts = [r["grads"][name] for r in replica]
        got = torch.cat(parts, spec.index("tp")) if "tp" in spec else parts[0]
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_fsdp_tp_zero3_with_experts_matches_one_device_and_trains(runs, jax_side):
    """ZeRO-3 over fsdp 2 composed with ep = tp 2 (Llama tiny, 4 experts):
    each rank holds a quarter of every expert weight (2 of the 4 experts,
    half of d_model), the first loss equals the JAX single-device loss and
    Adam lowers it, the same on every rank."""
    ranks = [r["fsdp_tp"] for r in runs[4]]
    for r in ranks:
        assert r["expert_shard"] == (2, 32, 128)
        assert np.isclose(r["losses"][0], jax_side["llama"]["loss"], rtol=LOSS_RTOL)
        assert r["losses"] == ranks[0]["losses"]
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses


def test_1f1b_pp_tp_with_experts_trains(runs):
    """1F1B at pp 2 × tp 2 over GPT-2 tiny with 4 experts: the all_to_all
    inside every stage's ticks; six Adam steps lower the loss, equal on
    every rank."""
    losses = [r["pp_tp"]["losses"] for r in runs[4]]
    assert all(lo == losses[0] for lo in losses)
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0] - 0.2, losses[0]


# ---- one device --------------------------------------------------------------


def _jax_routing(jmodel, moe, x):
    """The JAX block's routing of ``x`` [T, d] on one device — the ``route``
    of ``dsml_tpu/models/gpt2.py::GPT2._moe_block`` step by step (its
    ``lax.top_k``, the stable argsort and the segment starts): (expert ids,
    positions, kept)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    cfg = jmodel.config
    probs = jax.nn.softmax((x @ moe["gate"]).astype(jnp.float32), axis=-1)
    _, top_e = lax.top_k(probs, cfg.expert_top_k)
    flat_e = top_e.reshape(-1)
    n = flat_e.shape[0]
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.zeros(cfg.n_experts, jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = (jnp.arange(n, dtype=jnp.int32) - starts[flat_e[order]])[
        jnp.zeros_like(order).at[order].set(jnp.arange(n))]
    capacity = int(cfg.capacity_factor * x.shape[0] * cfg.expert_top_k / cfg.n_experts) + 1
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos < capacity)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("n_experts", [4, 8])
def test_moe_block_matches_jax_single_device(n_experts, capacity_factor):
    """The block on one device against the JAX block in f32: expert ids,
    positions and kept masks exactly; the output and the gradients of
    ``gate``, ``w_in``, ``b_in``, ``w_out``, ``b_out`` (and the input's)
    within 1e-5 relative. Capacity 1.25 drops assignments, 8.0 none."""
    import jax
    import jax.numpy as jnp

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config

    jmodel = GPT2(dataclasses.replace(GPT2Config.tiny(n_experts=n_experts),
                                      capacity_factor=capacity_factor))
    moe = jmodel.init(SEED)["layers"][0]["moe"]
    tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(n_experts=n_experts),
                                            capacity_factor=capacity_factor), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.init(SEED))))
    tmoe = tmodel.layers[0]["moe"]
    rng = np.random.default_rng(34)
    # a shared component tilts every token's gate the same way: experts overflow
    x = (rng.standard_normal((2, 64, 64)) + 4 * rng.standard_normal(64)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 64)).astype(np.float32)

    want_e, want_pos, want_kept = _jax_routing(jmodel, moe, jnp.asarray(x.reshape(-1, 64)))
    _, flat_e, pos, _ = tmodel._moe_route(tmoe["gate"], torch.from_numpy(x.reshape(-1, 64)),
                                          torch.float32)
    capacity = int(capacity_factor * 128 * 2 / n_experts) + 1
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal((pos < capacity).numpy(), want_kept)
    assert (not want_kept.all()) == (capacity_factor < 2)  # the drop case drops

    out, vjp = jax.vjp(lambda m, xx: jmodel._moe_block(m, xx, None), moe, jnp.asarray(x))
    gm, gx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = tmodel._moe_block(tmoe, xt)
    got.backward(torch.from_numpy(ct))

    def close(a, b, name):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= BLOCK_RTOL * np.abs(b).max(), name

    close(got.detach().numpy(), out, "out")
    close(xt.grad.numpy(), gx, "x")
    for name in ("gate", "w_in", "b_in", "w_out", "b_out"):
        close(tmoe[name].grad.numpy(), gm[name], name)


class _Largest(TorchDispatchMode):
    """The element count of the largest tensor any operation produces."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_moe_routing_memory_is_o_tk_not_dense():
    """At T = 8192 tokens and E = 8 the dense [T, E, C] dispatch tensor
    would hold ~167M elements; the sort/segment routing's largest tensor
    (forward and backward) stays under an eighth of that
    (``tests/test_gpt2.py::test_moe_routing_memory_is_o_tk_not_dense``)."""
    cfg = tgpt2.GPT2Config.tiny(n_experts=8)
    model = tgpt2.GPT2(cfg, device="cpu").init(0)
    t = 8192
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, t // 8, cfg.d_model))
                         .astype(np.float32)).requires_grad_()
    capacity = int(cfg.capacity_factor * t * cfg.expert_top_k / cfg.n_experts) + 1
    dense = t * cfg.n_experts * capacity
    with _Largest() as seen:
        out = model._moe_block(model.layers[0]["moe"], x)
        out.sum().backward()
    assert seen.largest < dense // 8, (seen.largest, dense)
    assert torch.isfinite(out).all()


def test_llama_experts_match_jax_single_device():
    """Llama tiny with 4 experts (GELU experts with biases in the SwiGLU
    MLP's place, the JAX init's draw slot): the same weights from one seed,
    the loss and every gradient against the JAX model's."""
    import jax

    from dsml_tpu.models.llama import Llama, LlamaConfig

    jmodel = Llama(LlamaConfig.tiny(n_experts=4))
    jparams = jmodel.init(SEED)
    tmodel = tllama.Llama(tllama.LlamaConfig.tiny(n_experts=4), device="cpu").init(SEED)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(want) == set(tmodel.state_dict())
    for name, t in tmodel.state_dict().items():
        assert torch.equal(t, want[name]), name
    x, y = _batch(seed=35)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, x, y)
    got = tmodel.loss(torch.from_numpy(x).long(), torch.from_numpy(y).long())
    got.backward()
    assert np.isclose(float(got.detach()), float(loss), rtol=1e-6)
    grads = params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_decode_matches_full_forward(family):
    """Capacity 8 (no drops): a 4-token prefill and five decode steps give
    the full forward's last logits, and those equal the JAX model's
    (``tests/test_generate.py::test_moe_decode_matches_full_forward``)."""
    import jax
    import jax.numpy as jnp

    if family == "gpt2":
        from dsml_tpu.models.gpt2 import GPT2 as J, GPT2Config as JC

        jcfg, tcls, tcfg = JC.tiny(n_experts=4), tgpt2.GPT2, tgpt2.GPT2Config.tiny(n_experts=4)
    else:
        from dsml_tpu.models.llama import Llama as J, LlamaConfig as JC

        jcfg, tcls, tcfg = JC.tiny(n_experts=4), tllama.Llama, tllama.LlamaConfig.tiny(n_experts=4)
    jmodel = J(dataclasses.replace(jcfg, capacity_factor=8.0))
    jparams = jmodel.init(2)
    model = tcls(dataclasses.replace(tcfg, capacity_factor=8.0), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 9)))
    with torch.no_grad():
        full = model.apply(toks)
    logits, cache = model.prefill(toks[:, :4])
    for pos in range(4, 9):
        logits, cache = model.decode_step(cache, toks[:, pos], pos)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **DECODE_TOL)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks.numpy(), jnp.int32)))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-4, atol=1e-5)


CLI_ARGS = {
    "train_gpt2": ["--steps", "2", "--batch_size", "2", "--seq_len", "32", "--log_every", "1",
                   "--attn", "flash", "--warmup_steps", "1"],
    "generate_text": ["--max_new_tokens", "3", "--n_samples", "2"],
    "serve_continuous": ["--requests", "3", "--max_new_max", "4", "--paged_kv", "int4",
                         "--prefill_chunk", "8"],
}


@pytest.mark.parametrize("cli", list(CLI_ARGS))
def test_entry_points_resolve_mixtral(cli, monkeypatch):
    """``--family llama --model mixtral_8x7b`` resolves in the three entry
    points and runs an expert model (the preset cut to one layer of width
    64 for the CPU), with no new flag."""
    import importlib

    preset = tllama.LlamaConfig.mixtral_8x7b
    # the preset's experts (8, top 2), vocabulary and GQA ratio; one layer of width 64
    monkeypatch.setattr(tllama.LlamaConfig, "mixtral_8x7b", staticmethod(
        lambda: dataclasses.replace(preset(), n_layer=1, n_head=8, n_kv_head=2, d_model=64,
                                    d_ff=128, max_seq=128)))
    mod = importlib.import_module(f"dsml_tpu_torch.cli.{cli}")
    out = mod.main(["--device", "cpu", "--family", "llama", "--model", "mixtral_8x7b",
                    *CLI_ARGS[cli]])
    if cli == "train_gpt2":
        assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    elif cli == "generate_text":
        assert len(out) == 2
    else:
        assert out["total_tokens"] > 0


SERVE = {"turbo": dict(decode_quantum=2, turbo_factor=2),
         "paged_int4": dict(prefill_chunk=8, paged_kv="int4", page_size=8, n_pages=40)}


@pytest.mark.parametrize("case", list(SERVE))
def test_moe_batcher_tokens_equal_jax(case):
    """GPT-2 tiny with 4 experts (top 2) through both batchers from the same
    weights: greedy tokens bit for bit, with turbo ticks on the dense cache
    and on int4 pages (every slot row routed, inactive ones included, so
    capacity is taken as in the JAX batcher;
    ``tests/test_serving.py::test_moe_model_through_batcher``)."""
    import jax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.serving.batcher import ContinuousBatcher as JaxBatcher

    jmodel = GPT2(GPT2Config.tiny(n_experts=4))
    jparams = jmodel.init(0)
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (5, 9, 12)]
    common = dict(n_slots=2, prompt_buckets=(16,), **SERVE[case])

    def serve(srv, cast):
        rids = [srv.submit(cast(p), 8) for p in prompts]
        out = srv.run()
        return [[int(t) for t in out[r]] for r in rids]

    want = serve(JaxBatcher(jmodel, jparams, **common), lambda p: p.astype(np.int32))
    tsrv = ContinuousBatcher(tmodel, **common)
    assert serve(tsrv, lambda p: p) == want
    if case == "turbo":
        assert tsrv.n_turbo_ticks > 0


def test_mixtral_preset_and_weight_plumbing():
    """``mixtral_8x7b`` resolves with the JAX preset's fields and builds
    (on the meta device: 31.7B parameters); ``params_from_jax`` carries the
    ``moe`` subtree, an EP rank taking its experts' slices; the quantized
    serving twins keep the experts and the gate full precision (the JAX
    ``quantize_weights_int8``); ``param_specs(fsdp=2)`` equals the JAX
    specs on every expert leaf."""
    import jax

    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import LlamaConfig

    assert dataclasses.asdict(tllama.LlamaConfig.by_name("mixtral_8x7b")) == \
        dataclasses.asdict(LlamaConfig.by_name("mixtral_8x7b"))
    model, cfg = model_by_family("llama", "mixtral_8x7b", device="meta")
    assert (cfg.n_experts, cfg.expert_top_k, cfg.d_ff) == (8, 2, 14336)
    assert model.layers[0]["moe"]["w_in"].shape == (8, 4096, 14336)
    assert 31.5e9 < model.n_params() < 31.8e9

    jmodel = GPT2(GPT2Config.tiny(n_experts=4))
    tree = jax.tree.map(np.asarray, jmodel.init(5))
    full = params_from_jax(tree)
    assert full["layers.1.moe.w_in"].shape == (4, 64, 128)
    shard = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="cpu",
                       tp_group=RingGroup(None, [0, 1], 1, "cpu"))
    cut = params_from_jax(tree, model=shard)
    assert torch.equal(cut["layers.1.moe.w_in"], full["layers.1.moe.w_in"][2:])
    assert torch.equal(cut["layers.1.moe.b_out"], full["layers.1.moe.b_out"][2:])
    assert torch.equal(cut["layers.1.moe.gate"], full["layers.1.moe.gate"])
    shard.load_state_dict(cut)

    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="cpu")
    tmodel.load_state_dict(full)
    for twin in (quantize_weights_blocked(tmodel, "int4", 32), quantize_weights_int8(tmodel)):
        for key in ("gate", "w_in", "b_in", "w_out", "b_out"):
            assert twin.layers[0]["moe"][key] is tmodel.layers[0]["moe"][key], key
        assert not isinstance(twin.layers[0]["attn"]["wo"], torch.Tensor)

    jspecs = jmodel.param_specs(fsdp=2)["layers"][0]["moe"]
    tspecs = tmodel.param_specs(fsdp=2)
    for key, spec in jspecs.items():
        assert tuple(spec) == tspecs[f"layers.0.moe.{key}"], key
    with pytest.raises(ValueError, match="n_experts=4 not divisible by tp=8"):
        tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(n_experts=4), n_head=8),
                   device="meta", tp_group=RingGroup(None, list(range(8)), 0, "cpu"))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_param_tree_paths_equal_the_jax_tree(family, tmp_path):
    """The checkpoint's parameter tree of an expert model is the JAX tree
    (the ``moe`` leaves named and ordered as ``jax.tree_util`` flattens
    them), and a native checkpoint the port writes restores in the JAX
    package bit for bit."""
    import jax

    from dsml_tpu.checkpoint import native as jnative
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.checkpoint import CheckpointManager, native
    from dsml_tpu_torch.checkpoint.optim_state import param_tree

    if family == "gpt2":
        jparams = GPT2(GPT2Config.tiny(n_experts=4)).init(0)
        model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(n_experts=4), device="cpu")
    else:
        jparams = Llama(LlamaConfig.tiny(n_experts=4)).init(0)
        model = tllama.Llama(tllama.LlamaConfig.tiny(n_experts=4), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    tree = param_tree(model)
    want = [p for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    got = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tree))[0]]
    assert got == want
    with CheckpointManager(str(tmp_path)) as m:
        m.save(1, {"params": tree})
    back = jnative.restore_tree(os.path.join(str(tmp_path), native.step_dirname(1)),
                                template={"params": jparams})["params"]
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                         jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(p))
