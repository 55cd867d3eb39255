"""The port's elastic re-plan (``dsml_tpu_torch/parallel/elastic.py``) and
its rank pool (``parallel/world.py``) against the JAX package's
``parallel/elastic.py``, on the CPU.

The planner runs on slot counts alone (one to eight, like the JAX suite's
``devices8``); the audit and the state motion run on one module-scoped
pool of four CPU worker processes (gloo), each world a subset of them. The
JAX functions run on ``devices8``. Slot ids stand where the JAX package
has device ids."""

import numpy as np
import optax
import pytest

from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.parallel import elastic as telastic
from dsml_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec
from dsml_tpu_torch.parallel.world import HostState, TrainRecipe, WorkerPool
from dsml_tpu_torch.runtime.controller import DeviceLost

RECIPE = TrainRecipe(tgpt2.GPT2Config.tiny(), lr=1e-2)
HBM = {"hbm_bytes": 16e9}  # the same capacity input to both planners


def _data(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (n, cfg.max_seq)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _host(world) -> dict:
    host = world.state()
    try:
        return host.tree()
    finally:
        host.remove()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with WorkerPool(4, RECIPE, device="cpu", workdir=str(tmp_path_factory.mktemp("pool")),
                    threads=1) as p:
        yield p


# ---- the JAX side -------------------------------------------------------------------


def _jax_model():
    from dsml_tpu.models.gpt2 import GPT2, GPT2Config

    return GPT2(GPT2Config.tiny())


def _jax_key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_torn_paths(state, lost) -> set:
    """Tree paths (the port's form) of the leaves JAX's audit tears."""
    import jax

    from dsml_tpu.parallel import elastic as jelastic

    torn = {id(leaf) for leaf, _ in jelastic._torn_leaves(state, lost)}
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if id(leaf) in torn:
            keys = [_jax_key(k) for k in path]
            keys[0] = ("params", "opt_state")[int(keys[0])]
            out.add("/".join(keys))
    return out


def _jax_pinned(model, opt, mesh):
    """``init_hybrid`` state with the moments re-pinned to the parameters'
    shardings (as the JAX elastic tests do before an audit)."""
    import jax
    import optax.tree_utils as otu
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsml_tpu.parallel.hybrid import init_hybrid

    params, opt_state = init_hybrid(model, opt, mesh, seed=0)
    sh = jax.tree.map(lambda leaf: leaf.sharding, params)
    repl = NamedSharding(mesh, P())
    opt_state = otu.tree_map_params(opt, lambda l, s: jax.device_put(l, s), opt_state, sh,
                                    transform_non_params=lambda l: jax.device_put(l, repl))
    return params, opt_state


# ---- the audit ----------------------------------------------------------------------


@pytest.mark.parametrize("layout,lost", [
    ("dp2_tp2", (1, 3)),    # every holder of tp shard 1
    ("dp2_tp2", (2, 3)),    # one whole dp replica: nothing torn
    ("dp2_tp2", (1,)),      # one holder of tp shard 1: its twin survives
    ("dp2_fsdp2", (1, 3)),  # fsdp coordinate 1 in both replicas
    ("dp2_fsdp2", (0, 1)),  # one whole replica: nothing torn
])
def test_check_recoverable_tears_the_jax_leaves(pool, devices8, layout, lost):
    """The audit over the layout a world's ranks report tears the leaves
    JAX's audit tears on the same mesh over the same devices."""
    from dsml_tpu.parallel.mesh import MeshSpec, build_mesh

    spec = {"dp2_tp2": dict(dp=2, tp=2), "dp2_fsdp2": dict(dp=2, fsdp=2)}[layout]
    mesh = build_mesh(MeshSpec(sp=1, **spec), devices8[:4])
    state = _jax_pinned(_jax_model(), optax.adam(1e-2), mesh)
    want = _jax_torn_paths(state, [devices8[i] for i in lost])
    world = pool.form([0, 1, 2, 3], TMeshSpec(**spec), seed=0)
    try:
        got = {d.split(" ")[0] for d in telastic.check_recoverable(world, lost)}
    finally:
        world.leave()
    assert got == want
    assert bool(got) == (lost == (1, 3))


@pytest.mark.parametrize("spec,slots", [(dict(dp=2, tp=2), [0, 1, 2, 3]), (dict(pp=2), [1, 3])])
def test_world_reports_the_computed_layout(pool, devices8, spec, slots):
    """The layout a world's ranks report (``mesh_state``) is the JAX
    ``init_hybrid`` state's, its moments pinned to the parameters'
    shardings as the JAX audit's are: every leaf's path, global shape and
    dtype, and rank r's block the one JAX's sharding puts on the device of
    slot r."""
    import jax

    from dsml_tpu.parallel.mesh import MeshSpec, build_mesh

    devices = [devices8[s] for s in slots]
    state = _jax_pinned(_jax_model(), optax.adam(1e-2), build_mesh(MeshSpec(sp=1, **spec), devices))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if leaf.ndim == 0:
            continue
        keys = [_jax_key(k) for k in path]
        keys[0] = ("params", "opt_state")[int(keys[0])]
        blocks = leaf.sharding.devices_indices_map(leaf.shape)
        want["/".join(keys)] = (tuple(leaf.shape), str(leaf.dtype),
                                [[list(sl.indices(n)[:2]) for sl, n in zip(blocks[d], leaf.shape)]
                                 for d in devices])
    world = pool.form(slots, TMeshSpec(**spec), seed=0)
    try:
        got = {path: (tuple(shape), dtype, [[list(ab) for ab in i] for i in idx])
               for path, (shape, dtype, idx) in world.layout.items()}
    finally:
        world.leave()
    assert got == want


# ---- the re-plan --------------------------------------------------------------------


@pytest.mark.parametrize("hbm", [16e9, 1.5e6])
def test_plan_for_survivors_matches_jax(devices8, hbm):
    from dsml_tpu.parallel import elastic as jelastic

    model = _jax_model()
    n_params = RECIPE.n_params()
    assert n_params == model.n_params(model.init(0))
    for n in range(1, 9):
        jp, jused = jelastic._plan_for_survivors(model, n_params, devices8[:n], 1, 8,
                                                 {"hbm_bytes": hbm})
        tp, tused = telastic._plan_for_survivors(RECIPE, n_params, list(range(n)), 1, 8,
                                                 {"hbm_bytes": hbm}, "cpu")
        assert tp.spec.sizes_dict() == {a: getattr(jp.spec, a) for a in tp.spec.sizes_dict()}
        assert tp.reasons == jp.reasons
        assert tused == [d.id for d in jused]


# ---- the state motion ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reconfigured(devices8):
    """JAX: init on dp=4 over devices 0..3, reconfigure onto {0, 2}."""
    import jax

    from dsml_tpu.parallel.elastic import reconfigure
    from dsml_tpu.parallel.hybrid import init_hybrid
    from dsml_tpu.parallel.mesh import MeshSpec, build_mesh

    model = _jax_model()
    opt = optax.adam(1e-2)
    mesh = build_mesh(MeshSpec(dp=4), devices8[:4])
    params, opt_state = init_hybrid(model, opt, mesh, seed=0)
    state = reconfigure(model, opt, params, opt_state,
                        surviving_devices=[devices8[0], devices8[2]],
                        lost_devices=[devices8[1], devices8[3]], global_batch=8,
                        planner_overrides=HBM)
    host = jax.tree.map(np.asarray, jax.device_get((state.params, state.opt_state[0])))
    return state.spec, host


def test_reconfigure_dp4_onto_two_survivors_is_a_pure_move(pool, jax_reconfigured):
    """The state moved onto {0, 2} is bit for bit the JAX package's (the
    same seed's init) and the port's own pre-failure state; the new world
    trains."""
    jspec, (jparams, jadam) = jax_reconfigured
    world = pool.form([0, 1, 2, 3], TMeshSpec(dp=4), seed=0)
    before = _host(world)
    state = telastic.reconfigure(world, [0, 2], [1, 3], global_batch=8, planner_overrides=HBM)
    try:
        assert state.spec.sizes_dict() == {a: getattr(jspec, a) for a in state.spec.sizes_dict()}
        assert state.world.slots == [0, 2]
        assert state.timings["pull_s"] > 0 and state.timings["push_s"] > 0
        after = _host(state.world)
        fa, fb = _flat(after), _flat(before)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
        for k, v in _flat(jparams).items():
            np.testing.assert_array_equal(fa[f"params/{k}"], v)
        for k in ("mu", "nu"):
            for p, v in _flat(getattr(jadam, k)).items():
                np.testing.assert_array_equal(fa[f"opt_state/0/{k}/{p}"], v)
        assert np.isfinite(state.world.step(*_data(RECIPE.config)))
    finally:
        state.world.leave()


def test_policy_no_shrink_fails_fast(pool):
    world = pool.form([0, 1], TMeshSpec(dp=2), seed=0)
    try:
        with pytest.raises(RuntimeError, match="allow_shrink=False"):
            telastic.reconfigure(world, [0], [1],
                                 policy=telastic.ElasticPolicy(allow_shrink=False))
        assert world.active  # nothing moved
    finally:
        world.leave()


def test_torn_state_refused_then_zero_filled(pool):
    """dp = 2 × tp = 2 loses both tp-1 holders: refused under
    require_full_state; with it off, tp shard 0 survives intact, shard 1 is
    zero-filled (never read from the dead), replicated leaves are whole,
    and the substitution is in the audit trail."""
    world = pool.form([0, 1, 2, 3], TMeshSpec(dp=2, tp=2), seed=0)
    world.step(*_data(RECIPE.config))
    ref = _flat(_host(world))
    with pytest.raises(telastic.StateNotRecoverable, match="not recoverable"):
        telastic.reconfigure(world, [0, 2], [1, 3], global_batch=8, planner_overrides=HBM)
    state = telastic.reconfigure(world, [0, 2], [1, 3], global_batch=8, planner_overrides=HBM,
                                 policy=telastic.ElasticPolicy(require_full_state=False))
    try:
        assert any("zero-filled" in r for r in state.reasons)
        got = _flat(_host(state.world))
        wqkv, half = "params/layers/0/attn/wqkv", RECIPE.config.d_model // 2
        np.testing.assert_array_equal(got[wqkv][..., :half], ref[wqkv][..., :half])
        assert np.all(got[wqkv][..., half:] == 0) and np.any(ref[wqkv][..., half:] != 0)
        np.testing.assert_array_equal(got["params/wpe"], ref["params/wpe"])
        assert np.isfinite(state.world.step(*_data(RECIPE.config)))
    finally:
        state.world.leave()


def test_awkward_survivor_count_idles_slots(pool):
    """Three survivors for a global batch of 8: the plan instantiates on
    two (Oobleck: n−1 busy slots beat a crash)."""
    world = pool.form([0, 1, 2, 3], TMeshSpec(dp=4), seed=0)
    state = telastic.reconfigure(world, [0, 1, 2], [3], global_batch=8, planner_overrides=HBM)
    try:
        assert state.world.slots == [0, 1] and state.spec.dp == 2
        assert any("idle" in r for r in state.reasons)
        assert np.isfinite(state.world.step(*_data(RECIPE.config)))
    finally:
        state.world.leave()


def test_pipeline_state_unstacks_onto_a_dp_plan(pool):
    """pp = 2 × dp = 2 loses one dp replica ({1, 3}): the survivors' plan is
    pure dp, the stacked layer axis unstacks to the per-layer list, and
    Adam's moments follow the same transform (nonzero after one step)."""
    world = pool.form([0, 1, 2, 3], TMeshSpec(pp=2, dp=2), seed=0)
    world.step(*_data(RECIPE.config))
    ref = _flat(_host(world))
    stacked = ref["params/layers/attn/wqkv"]
    state = telastic.reconfigure(world, [0, 2], [1, 3], global_batch=8, planner_overrides=HBM)
    try:
        assert state.spec.pp == 1 and state.world.slots == [0, 2]
        got = _host(state.world)
        assert isinstance(got["params"]["layers"], list)
        for i, layer in enumerate(got["params"]["layers"]):
            np.testing.assert_array_equal(layer["attn"]["wqkv"], stacked[i])
        mu = got["opt_state"][0]["mu"]["layers"][0]["attn"]["wqkv"]
        np.testing.assert_array_equal(mu, ref["opt_state/0/mu/layers/attn/wqkv"][0])
        assert np.abs(mu).max() > 0
        assert np.isfinite(state.world.step(*_data(RECIPE.config)))
    finally:
        state.world.leave()


def test_remap_error_feedback_matches_jax(devices8):
    """Residual mass carried across a width change, lost ranks dropped."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dsml_tpu.parallel.elastic import remap_error_feedback

    rng = np.random.default_rng(3)
    rows = {"w": rng.standard_normal((4, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}
    old = Mesh(np.asarray(devices8[:4]), ("dp",))
    new = Mesh(np.asarray(devices8[:2]), ("dp",))
    ef = {k: jax.device_put(v, NamedSharding(old, P("dp"))) for k, v in rows.items()}
    want = remap_error_feedback(ef, new, lost_devices=[devices8[1]])
    got = telastic.remap_error_feedback(rows, 2, lost_ranks=[1])
    for k in rows:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-7)
        # mass preserved: the new sum / new width is the survivors' sum / old width
        np.testing.assert_allclose(got[k].sum(0) / 2, np.delete(rows[k], 1, 0).sum(0) / 4,
                                   rtol=1e-6, atol=1e-7)


def test_host_state_round_trips_bf16(tmp_path):
    """bf16 leaves ride the host files as their 16 bits."""
    import torch

    vals = torch.randn(6, 4).to(torch.bfloat16)
    host = HostState.create(str(tmp_path / "a"), {"params/w": ((6, 4), "bfloat16")}, {})
    host.array("params/w", mode="r+")[...] = vals.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(host.arrays()["params/w"], vals.float().numpy())
    moved = host.write_arrays(str(tmp_path / "b"), host.arrays())
    np.testing.assert_array_equal(moved.arrays()["params/w"], vals.float().numpy())


def test_a_killed_rank_surfaces_as_device_lost(pool):
    """A worker that dies inside a step raises DeviceLost naming its slot;
    its world is aborted and the survivor keeps its pre-step state."""
    world = pool.form([0, 1], TMeshSpec(dp=2), seed=0)
    before = _flat(_host(world))
    with pytest.raises(DeviceLost) as info:
        world.step(*_data(RECIPE.config), die_before_sync=1)
    assert info.value.devices == (1,) and not pool.is_alive(1)
    state = telastic.reconfigure(world, [0], [1], global_batch=8, planner_overrides=HBM)
    try:
        after = _flat(_host(state.world))
        for k in before:
            np.testing.assert_array_equal(after[k], before[k])
    finally:
        state.world.leave()
        pool.restore(1)


def test_recipe_weights_file_gives_the_init_weights(pool, tmp_path):
    """A recipe's weights file (the whole model's init state_dict) fills a
    world's ranks as drawing them from the seed does, whole or tp-sharded."""
    import dataclasses

    import torch

    path = str(tmp_path / "w.pt")
    torch.save(tgpt2.GPT2(RECIPE.config, device="cpu").init(0).state_dict(), path)
    loaded = dataclasses.replace(RECIPE, weights=path)
    for spec in (TMeshSpec(dp=2), TMeshSpec(tp=2)):
        trees = []
        for recipe in (RECIPE, loaded):
            world = pool.form([0, 1], spec, seed=0, recipe=recipe)
            try:
                trees.append(_flat(_host(world)))
            finally:
                world.leave()
        assert trees[0].keys() == trees[1].keys()
        for k in trees[0]:
            np.testing.assert_array_equal(trees[0][k], trees[1][k])
