"""The port's checkpointing (``dsml_tpu_torch.checkpoint``,
``utils/checkpoint.py``) against itself and against the JAX package's, on
the CPU at tiny sizes.

One on-disk format for both packages: a checkpoint written by either
restores in the other, each leaf bit for bit, and the port's piece files
equal the JAX package's byte for byte for the same state. Within the port:
the format's atomicity, async safety, sticky write errors, GC and
iterator position (the properties ``tests/test_checkpoint.py`` pins for
the JAX package), and kill-and-resume bit-identical to the straight run in
the ``Trainer`` (one rank, and dp = 2 over gloo with q8_ring and error
feedback) and in ``train_gpt2``. Across packages: every optimizer's state
tree, ``Trainer`` and ``train_gpt2`` resumes, serving from a checkpoint,
and the checkpoint's observability hooks."""

from __future__ import annotations

import dataclasses
import filecmp
import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dsml_tpu import obs as jobs
from dsml_tpu.checkpoint import CheckpointManager as JaxManager
from dsml_tpu.checkpoint import ResumableIterator as JaxIterator
from dsml_tpu.checkpoint import native as jnative
from dsml_tpu.models import gpt2 as jgpt2
from dsml_tpu.models import llama as jllama
from dsml_tpu.models.mlp import MLP as JaxMLP
from dsml_tpu.serving import ContinuousBatcher as JaxBatcher
from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
from dsml_tpu.trainer import Trainer as JaxTrainer
from dsml_tpu.trainer import _make_optimizer as jax_make_optimizer
from dsml_tpu.utils import data as jdata
from dsml_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from dsml_tpu.utils.schedules import make_schedule as jax_make_schedule
from dsml_tpu_torch import obs as tobs
from dsml_tpu_torch.checkpoint import CheckpointManager, RankShard, ResumableIterator, native
from dsml_tpu_torch.checkpoint import optim_state
from dsml_tpu_torch.cli import generate_text, train_gpt2
from dsml_tpu_torch.models import MLP
from dsml_tpu_torch.models import gpt2 as tgpt2
from dsml_tpu_torch.models import llama as tllama
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.parallel.mesh import data_mesh
from dsml_tpu_torch.serving import ContinuousBatcher
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.trainer import _make_optimizer
from dsml_tpu_torch.utils import data as tdata
from dsml_tpu_torch.utils.checkpoint import Checkpointer
from dsml_tpu_torch.utils.schedules import make_schedule

# the optimizer-state kinds of optim_state, each with the JAX optimizer the
# JAX package builds for it; clip_adamw also in bf16 (bf16 moments on both sides)
KIND_CASES = [("sgd", "float32"), ("momentum", "float32"), ("adam", "float32"),
              ("adamw", "float32"), ("clip_adamw", "float32"), ("clip_adamw", "bfloat16")]
TRAIN_STEPS = 2  # updates before a save: every moment and count non-zero


@pytest.fixture(autouse=True)
def _obs_hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("DSML_POSTMORTEM_DIR", str(tmp_path))
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.get_registry().reset()
        pkg.get_flight_recorder().clear()
        pkg.get_memory_ledger().clear()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _bits(a):
    """A leaf's exact bits as numpy (bf16 of either package as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax_leaves(tree) -> dict:
    return {jnative._path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_leaves(jax_tree, torch_tree):
    """The same array paths in the same flatten order, each leaf bit for bit
    with the same dtype name (inline scalars are compared by the callers)."""
    want = {p: v for p, v in _jax_leaves(jax_tree).items() if hasattr(v, "dtype")}
    got = {p: v for p, v in native.tree_leaves_with_path(torch_tree)
           if isinstance(v, torch.Tensor)}
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert native._torch_dtype_name(g.dtype) == np.asarray(w).dtype.name, path
        assert tuple(g.shape) == np.shape(w), path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)


def _assert_same_files(dir_a: str, dir_b: str):
    """Two step directories with the same file names, every piece byte for
    byte, and the same manifest."""
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        if name.endswith(".bin"):
            assert filecmp.cmp(os.path.join(dir_a, name), os.path.join(dir_b, name),
                               shallow=False), name
    assert native.read_manifest(dir_a) == jnative.read_manifest(dir_b)


def _step_dir(directory, step):
    return os.path.join(directory, native.step_dirname(step))


# ---------------------------------------------------------------------------
# the format and the manager
# ---------------------------------------------------------------------------


def _mixed_trees():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    meta = {"epoch": 7, "name": "run-a", "done": False, "lr": 1e-3}
    jtree = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b).astype(jnp.bfloat16)},
             "opt": [jnp.arange(3, dtype=jnp.int32), jnp.int32(9), [jnp.float32(2.5)]],
             "meta": meta}
    ttree = {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b).to(torch.bfloat16)},
             "opt": [torch.arange(3, dtype=torch.int32), torch.tensor(9, dtype=torch.int32),
                     [torch.tensor(2.5)]],
             "meta": dict(meta)}
    return jtree, ttree


def test_roundtrip_mixed_tree_and_the_jax_package_reads_it(tmp_path):
    """Inline scalars, f32, bf16, int32, 0-d leaves and nested lists: the
    port's round trip, with and without a template; the JAX package's save
    of the same tree has the same files, byte for byte, and each package
    reads the other's."""
    jtree, ttree = _mixed_trees()
    with CheckpointManager(str(tmp_path / "t")) as m:
        m.save(7, ttree)
        got = m.restore(7)
        back = m.restore(template=ttree)
    assert got["meta"] == ttree["meta"] and isinstance(got["opt"], list)
    assert got["params"]["b"].dtype == torch.bfloat16 and got["opt"][1].shape == ()
    _assert_same_leaves(jtree, back)
    assert back["meta"] == ttree["meta"]
    with JaxManager(str(tmp_path / "j")) as m:
        m.save(7, jtree)
    _assert_same_files(_step_dir(str(tmp_path / "t"), 7), _step_dir(str(tmp_path / "j"), 7))
    from_port = jnative.restore_tree(_step_dir(str(tmp_path / "t"), 7), template=jtree)
    _assert_same_leaves(from_port, back)
    assert from_port["meta"] == ttree["meta"]
    from_jax = native.restore_tree(_step_dir(str(tmp_path / "j"), 7), template=ttree)
    _assert_same_leaves(jtree, from_jax)
    assert from_jax["meta"] == ttree["meta"]


def test_latest_step_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert m.latest_step() is None
    for s in (1, 5, 9):
        m.save(s, {"x": torch.ones(4)})
    assert m.latest_step() == 9
    assert m.all_steps() == [5, 9]  # step 1 garbage-collected
    assert m.latest_step(where=lambda meta: False) is None
    m.delete_steps([5])
    assert m.all_steps() == [9]
    m.close()
    assert CheckpointManager.newest_common_step([[1, 5, 9], [5, 9], [9, 12]]) == 9


def test_interrupted_save_invisible_and_recoverable(tmp_path, monkeypatch):
    """A writer killed mid-files (before the manifest and the rename): the
    previous step stays the latest and intact, and a retry of the same step
    clears the debris and commits."""
    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(1, {"w": torch.arange(64.0)})
    real_commit = native.commit
    crashed = {}

    def crashing_commit(directory, snap, barrier=None):
        tmp = os.path.join(directory, ".tmp." + native.step_dirname(snap.manifest["step"]))
        os.makedirs(tmp, exist_ok=True)
        fn, arr = snap.blobs[0]
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(arr.tobytes()[: max(1, arr.nbytes // 2)])  # truncated!
        crashed["tmp"] = tmp
        raise RuntimeError("simulated preemption mid-write")

    monkeypatch.setattr(native, "commit", crashing_commit)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        m.save(2, {"w": torch.arange(64.0) * 2})
    monkeypatch.setattr(native, "commit", real_commit)
    assert m.latest_step() == 1
    assert torch.equal(m.restore()["w"], torch.arange(64.0))
    assert os.path.isdir(crashed["tmp"])
    m.save(2, {"w": torch.arange(64.0) * 2})
    assert m.latest_step() == 2
    assert torch.equal(m.restore()["w"], torch.arange(64.0) * 2)
    m.close()


def test_truncated_piece_detected(tmp_path):
    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(3, {"w": torch.arange(64.0)})
    step_dir = _step_dir(m.directory, 3)
    victim = os.path.join(step_dir, native.read_manifest(step_dir)["leaves"][0]["pieces"][0]["file"])
    with open(victim, "r+b") as f:
        f.truncate(16)
    with pytest.raises(ValueError, match="truncated"):
        m.restore(3)
    m.close()


def test_async_save_immune_to_in_place_updates(tmp_path):
    """save(wait=False) returns before the commit; the optimizer's in-place
    update right after it (here: zeroing the tensors) cannot reach the
    checkpoint — the snapshot is a real copy, also of CPU tensors."""
    params = {"w": torch.arange(1 << 16, dtype=torch.float32),
              "b": torch.ones(8, dtype=torch.bfloat16)}
    m = CheckpointManager(str(tmp_path / "ck"))
    m.save(1, {"params": params}, wait=False)
    for t in params.values():
        t.mul_(0)
    m.wait_until_finished()
    got = m.restore(1)["params"]
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(got["b"], torch.ones(8, dtype=torch.bfloat16))
    m.close()


def test_async_write_error_surfaces_on_next_save(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path / "ck"))

    def boom(directory, snap, barrier=None):
        raise OSError("disk full")

    monkeypatch.setattr(native, "commit", boom)
    m.save(1, {"w": torch.ones(8)}, wait=False)
    with pytest.raises(OSError, match="disk full"):
        m.save(2, {"w": torch.ones(8)}, wait=True)
    m.close()


def test_resumable_iterator_bit_identical_to_the_jax_one():
    toks = np.arange(5000, dtype=np.int32)
    factory = lambda: tdata.lm_window_batches(toks, seq_len=16, batch_size=4, seed=9)  # noqa: E731
    jfactory = lambda: jdata.lm_window_batches(toks, seq_len=16, batch_size=4, seed=9)  # noqa: E731
    it = ResumableIterator(factory)
    for _ in range(10):
        next(it)
    assert it.state() == {"consumed": 10}
    it2 = ResumableIterator(factory, state=it.state())
    jit2 = JaxIterator(jfactory, state=it.state())
    for want_x, want_y in [next(it) for _ in range(5)]:
        for got_x, got_y in (next(it2), next(jit2)):
            np.testing.assert_array_equal(got_x, want_x)
            np.testing.assert_array_equal(got_y, want_y)
    it.reset()
    assert it.consumed == 0


def test_iterator_state_and_meta_ride_the_manifest(tmp_path):
    with CheckpointManager(str(tmp_path / "ck")) as m:
        m.save(4, {"w": torch.ones(2)}, iterator_state={"consumed": 37, "epoch": 2},
               meta={"note": "mid-epoch"})
        assert m.iterator_state() == {"consumed": 37, "epoch": 2}
        assert m.meta()["note"] == "mid-epoch"
        assert m.latest_step(where=lambda meta: meta.get("note") == "mid-epoch") == 4
    with JaxManager(str(tmp_path / "ck")) as jm:  # the JAX package reads the same manifest
        assert jm.iterator_state(4) == {"consumed": 37, "epoch": 2}


def test_resize_flat_trims_zeros_pads_and_refuses_data(tmp_path):
    """``_resize_flat`` as the JAX package's, and through a restore of a
    1-D leaf the JAX package saved sharded over dp (the ZeRO-2 bucket
    padding): a smaller template trims the verified-zero tail, a larger one
    pads, a non-zero tail refuses."""
    arr = np.concatenate([np.arange(1, 13, dtype=np.float32), np.zeros(4, np.float32)])
    for target in (12, 16, 20):
        np.testing.assert_array_equal(native._resize_flat(arr, target, "x"),
                                      jnative._resize_flat(arr, target, "x"))
    with pytest.raises(ValueError, match="non-zero"):
        native._resize_flat(arr, 8, "x")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh

    mesh = jax_data_mesh(devices=jax.devices()[:4])
    leaf = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("dp")))
    with JaxManager(str(tmp_path / "ck")) as m:
        m.save(1, {"flat": leaf})
    with CheckpointManager(str(tmp_path / "ck")) as m:
        assert len(native.read_manifest(_step_dir(m.directory, 1))["leaves"][0]["pieces"]) == 4
        for target in (12, 20):
            got = m.restore(template={"flat": torch.zeros(target)})["flat"]
            assert torch.equal(got, torch.from_numpy(native._resize_flat(arr, target, "x")))
        with pytest.raises(ValueError, match="non-zero"):
            m.restore(template={"flat": torch.zeros(8)})
        with pytest.raises(ValueError, match="template shape"):
            m.restore(template={"flat": torch.zeros(4, 4)})


def test_rank_shards_each_rank_writes_its_own_row(tmp_path):
    """Two ranks (threads with a barrier) commit one step: the manifest has
    the ``[2, *shape]`` sharded leaf with two pieces and the replicated leaf
    with one; rank 1 wrote its row only, rank 0 its row and the rest. The
    JAX package restores the leaf sharded over a dp = 2 mesh; the port's
    rank r reads row r."""
    rows = [torch.full((3, 2), float(r + 1)) for r in range(2)]
    shared = torch.arange(4.0)
    barrier = threading.Barrier(2, timeout=30)
    snaps = [native.snapshot({"ef": {"w": RankShard(rows[r], r, 2)}, "w": shared}, step=5,
                             rank=r, world=2) for r in range(2)]
    errors = []

    def commit(r):
        try:
            native.commit(str(tmp_path), snaps[r], barrier.wait)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=commit, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert [sorted(fn for fn, _ in s.blobs) for s in snaps] == [
        ["L00000_P000.bin", "L00001_P000.bin"], ["L00000_P001.bin"]]
    step_dir = _step_dir(str(tmp_path), 5)
    (ef, w) = native.read_manifest(step_dir)["leaves"]
    assert ef["shape"] == [2, 3, 2] and ef["sharding"]["spec"] == [["dp"]]
    assert [p["index"] for p in ef["pieces"]] == [[[0, 1], [0, 3], [0, 2]], [[1, 2], [0, 3], [0, 2]]]
    assert w["sharding"] is None and len(w["pieces"]) == 1
    for r in range(2):
        got = native.restore_tree(step_dir, {"ef": {"w": RankShard(torch.zeros(3, 2), r, 2)},
                                             "w": torch.zeros(4)})
        assert torch.equal(got["ef"]["w"], rows[r]) and torch.equal(got["w"], shared)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh

    mesh = jax_data_mesh(devices=jax.devices()[:2])
    tmpl = {"ef": {"w": jax.device_put(jnp.zeros((2, 3, 2)), NamedSharding(mesh, P("dp")))},
            "w": jnp.zeros(4)}
    got = jnative.restore_tree(step_dir, tmpl)
    np.testing.assert_array_equal(np.asarray(got["ef"]["w"]), torch.stack(rows).numpy())
    with pytest.raises(ValueError, match="rank 0 of 4"):
        native.restore_tree(step_dir, {"ef": {"w": RankShard(torch.zeros(3, 2), 0, 4)},
                                       "w": torch.zeros(4)})


def test_restore_template_rules(tmp_path):
    """A template leaf missing from the checkpoint is a KeyError; one that
    drops saved leaves needs partial=True; leaves come back in the
    template's dtype and numpy/scalar templates get their own types."""
    with CheckpointManager(str(tmp_path / "ck")) as m:
        m.save(1, {"a": torch.ones(2, dtype=torch.bfloat16), "b": np.arange(3), "c": 4})
        with pytest.raises(KeyError, match="'z'"):
            m.restore(template={"z": torch.zeros(1)}, partial=True)
        with pytest.raises(ValueError, match="partial=True"):
            m.restore(template={"a": torch.zeros(2)})
        got = m.restore(template={"a": torch.zeros(2)}, partial=True)["a"]
        assert got.dtype == torch.float32 and torch.equal(got, torch.ones(2))
        got = m.restore(template={"a": np.zeros(2, np.float32), "b": np.zeros(3, np.int64), "c": 0})
        assert got["a"].dtype == np.float32 and got["b"].tolist() == [0, 1, 2] and got["c"] == 4


def test_checkpointer_layout_and_orbax_is_jax_only(tmp_path, monkeypatch):
    """The compat front-end writes the JAX native Checkpointer's
    {params, opt_state, meta} tree (the same files for the same state);
    orbax, explicit or through the env knob, raises."""
    jtree, ttree = _mixed_trees()
    c = Checkpointer(str(tmp_path / "t"))
    assert c.backend == "native"
    c.save(3, ttree["params"], ttree["opt"], meta={"epoch": 3})
    assert c.latest_step() == 3
    got = c.restore(template={"params": ttree["params"]}, partial=True)
    assert torch.equal(got["params"]["w"], ttree["params"]["w"])
    c.close()
    jc = JaxCheckpointer(str(tmp_path / "j"))
    jc.save(3, jtree["params"], jtree["opt"], meta={"epoch": 3})
    jc.close()
    _assert_same_files(_step_dir(str(tmp_path / "t"), 3), _step_dir(str(tmp_path / "j"), 3))
    with pytest.raises(NotImplementedError, match="JAX-only"):
        Checkpointer(str(tmp_path / "o"), backend="orbax")
    monkeypatch.setenv("DSML_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="JAX-only"):
        Checkpointer(str(tmp_path / "o"))
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        Checkpointer(str(tmp_path / "o"), backend="tar")


# ---------------------------------------------------------------------------
# the parameter and optimizer trees across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mlp", "gpt2", "llama"])
def test_param_tree_paths_equal_the_jax_tree(family):
    """The port's ``params`` leaves are the JAX model's tree exactly: the
    same paths in the same order (no tied duplicate, no buffer)."""
    if family == "mlp":
        jparams, model = JaxMLP((16, 32, 4)).init(0), MLP((16, 32, 4), device="cpu")
    elif family == "gpt2":
        jparams = jgpt2.GPT2(jgpt2.GPT2Config.tiny()).init(0)
        model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    else:
        jparams = jllama.Llama(jllama.LlamaConfig.tiny()).init(0)
        model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    _assert_same_leaves(jparams, optim_state.param_tree(model))


def _kind_case(kind, dtype):
    """(JAX model, JAX optimizer, port model, port optimizer, batches): the
    Trainer's MLP and optimizers for its kinds, train_gpt2's GPT-2 tiny and
    chain(clip, adamw) for clip_adamw."""
    rng = np.random.default_rng(4)
    if kind == "clip_adamw":
        jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=dtype)
        jmodel = jgpt2.GPT2(jcfg)
        tmodel = tgpt2.GPT2(dataclasses.replace(tgpt2.GPT2Config.tiny(), dtype=dtype),
                            device="cpu")
        jopt = optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(jax_make_schedule("cosine", 1e-2, 10, 1)))
        topt = torch.optim.AdamW(tmodel.parameters(), lr=0.0, weight_decay=1e-4)
        sched = make_schedule("cosine", 1e-2, 10, 1)
        batches = [(x, np.roll(x, -1, 1)) for x in
                   (rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
                    for _ in range(TRAIN_STEPS))]
    else:
        jmodel, tmodel = JaxMLP((16, 32, 4)), MLP((16, 32, 4), device="cpu")
        cfg = dict(optimizer=kind, lr=0.05, lr_schedule="cosine", warmup_steps=1, epochs=1)
        jopt = jax_make_optimizer(JaxTrainConfig(**cfg), 10)
        topt, sched = _make_optimizer(TrainConfig(**cfg), tmodel.parameters(), 10)
        batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                    rng.integers(0, 4, 8).astype(np.int32)) for _ in range(TRAIN_STEPS)]
    return jmodel, jopt, tmodel, topt, sched, batches


def _jax_trained(jmodel, jopt, batches):
    params = jmodel.init(0)
    state = jopt.init(params)
    for x, y in batches:
        g = jax.grad(jmodel.loss)(params, jnp.asarray(x), jnp.asarray(y))
        upd, state = jopt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _torch_trained(tmodel, topt, sched, batches):
    tmodel.init(0)
    for i, (x, y) in enumerate(batches):
        topt.zero_grad(set_to_none=True)
        tmodel.loss(torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x),
                    torch.from_numpy(y).long()).backward()
        for g in topt.param_groups:
            g["lr"] = sched(i)
        topt.step()


@pytest.mark.parametrize("kind,dtype", KIND_CASES)
def test_jax_checkpoint_restores_into_torch_optim(kind, dtype, tmp_path):
    """The JAX package saves {params, opt_state} after two updates; the
    port restores every leaf bit for bit into its module and torch.optim
    state (mu → exp_avg, nu → exp_avg_sq, count → step, trace →
    momentum_buffer), and saving that state again writes the JAX files,
    byte for byte."""
    jmodel, jopt, tmodel, topt, _, batches = _kind_case(kind, dtype)
    jparams, jstate = _jax_trained(jmodel, jopt, batches)
    with JaxManager(str(tmp_path / "j")) as m:
        m.save(TRAIN_STEPS, {"params": jparams, "opt_state": jstate})
    template = {"params": optim_state.param_tree(tmodel),
                "opt_state": optim_state.optax_state(topt, tmodel, kind, 0)}
    with CheckpointManager(str(tmp_path / "j")) as m:
        state = m.restore(template=template)
    optim_state.load_param_tree(tmodel, state["params"])
    assert optim_state.load_optax_state(topt, tmodel, kind, state["opt_state"]) == TRAIN_STEPS
    _assert_same_leaves(jparams, optim_state.param_tree(tmodel))
    _assert_same_leaves(jstate, optim_state.optax_state(topt, tmodel, kind, TRAIN_STEPS))
    for p in tmodel.parameters():
        st = topt.state.get(p, {})
        if kind in ("adam", "adamw", "clip_adamw"):
            assert st["step"].item() == TRAIN_STEPS and st["exp_avg"].dtype == p.dtype
        assert kind != "momentum" or st["momentum_buffer"].dtype == p.dtype
    with CheckpointManager(str(tmp_path / "t")) as m:
        m.save(TRAIN_STEPS, {"params": optim_state.param_tree(tmodel),
                             "opt_state": optim_state.optax_state(topt, tmodel, kind, TRAIN_STEPS)})
    _assert_same_files(_step_dir(str(tmp_path / "t"), TRAIN_STEPS),
                       _step_dir(str(tmp_path / "j"), TRAIN_STEPS))


@pytest.mark.parametrize("kind,dtype", KIND_CASES)
def test_torch_checkpoint_restores_in_jax(kind, dtype, tmp_path):
    """The port saves its module and torch.optim state after two updates;
    the JAX package's ``native.restore_tree`` with a JAX template (its
    model's init and its optimizer's init) restores every leaf bit for bit,
    and the JAX package's save of that state writes the port's files, byte
    for byte."""
    jmodel, jopt, tmodel, topt, sched, batches = _kind_case(kind, dtype)
    _torch_trained(tmodel, topt, sched, batches)
    tstate = {"params": optim_state.param_tree(tmodel),
              "opt_state": optim_state.optax_state(topt, tmodel, kind, TRAIN_STEPS)}
    with CheckpointManager(str(tmp_path / "t")) as m:
        m.save(TRAIN_STEPS, tstate)
    jparams = jmodel.init(0)
    template = {"params": jparams, "opt_state": jopt.init(jparams)}
    got = jnative.restore_tree(_step_dir(str(tmp_path / "t"), TRAIN_STEPS), template)
    _assert_same_leaves(got, tstate)
    with JaxManager(str(tmp_path / "j")) as m:
        m.save(TRAIN_STEPS, got)
    _assert_same_files(_step_dir(str(tmp_path / "t"), TRAIN_STEPS),
                       _step_dir(str(tmp_path / "j"), TRAIN_STEPS))
    # and the JAX optimizer continues from it: one more update is finite
    x, y = batches[0]
    g = jax.grad(jmodel.loss)(got["params"], jnp.asarray(x), jnp.asarray(y))
    upd, _ = jopt.update(g, got["opt_state"], got["params"])
    assert all(bool(jnp.isfinite(u.astype(jnp.float32)).all()) for u in jax.tree.leaves(upd))


def test_optimizer_must_cover_the_model():
    model = MLP((4, 3, 2), device="cpu")
    opt = torch.optim.SGD([model.w0], lr=0.1)
    with pytest.raises(ValueError, match="exactly the model's parameters"):
        optim_state.optax_state(opt, model, "sgd", 0)
    with pytest.raises(ValueError, match="unknown optimizer state kind"):
        optim_state.optax_state(torch.optim.SGD(model.parameters(), lr=0.1), model, "lion", 0)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

TRAIN_DATA = dict(n=512, features=16, classes=4, seed=0)


def _port_trainer(epochs, ckdir, resume=False, **kw):
    cfg = TrainConfig(epochs=epochs, batch_size=32, lr=0.05, checkpoint_dir=ckdir,
                      resume=resume, seed=3, **kw)
    return Trainer(MLP((16, 32, 4), device="cpu"), cfg).train(
        tdata.synthetic_classification(**TRAIN_DATA))


@pytest.mark.parametrize("granularity,optimizer", [("epoch", "adamw"), ("steps", "momentum")])
def test_trainer_kill_and_resume_bit_identical(granularity, optimizer, tmp_path):
    """Three epochs straight against one epoch, a kill and a resume: the
    weights bit for bit, and the resumed epochs' losses. ``steps``: saves
    every 5 updates; the run is killed after the save at update 10 (the
    epoch's later checkpoint deleted), so the resume fast-forwards the
    epoch's stream past 10 batches."""
    kw = dict(optimizer=optimizer, save_every_steps=5 if granularity == "steps" else 0)
    straight, shist, _ = _port_trainer(3, str(tmp_path / "a"), **kw)
    _port_trainer(1, str(tmp_path / "b"), **kw)
    with CheckpointManager(str(tmp_path / "b")) as m:
        if granularity == "steps":
            spe = m.latest_step()  # the epoch's end: id = the global step
            assert m.all_steps() == [5, 10, spe] and m.iterator_state(10) == {"epoch": 1,
                                                                               "consumed": 10}
            m.delete_steps([spe])
        else:
            assert m.all_steps() == [1] and m.iterator_state() == {"epoch": 1, "consumed": 0}
    resumed, rhist, _ = _port_trainer(3, str(tmp_path / "b"), resume=True, **kw)
    assert all(torch.equal(straight[k], resumed[k]) for k in straight)
    assert [h["epoch"] for h in rhist] == ([1, 2, 3] if granularity == "steps" else [2, 3])
    assert [h["avg_loss"] for h in rhist[-2:]] == [h["avg_loss"] for h in shist[-2:]]


def test_trainer_resume_that_cannot_restore_raises(tmp_path):
    """A resume never silently starts afresh: a torn piece raises, foreign
    (orbax) step directories raise, and a template that does not cover the
    checkpoint (error feedback saved, not asked for) raises."""
    _port_trainer(1, str(tmp_path / "a"))
    step_dir = _step_dir(str(tmp_path / "a"), 1)
    piece = native.read_manifest(step_dir)["leaves"][-1]["pieces"][0]["file"]
    with open(os.path.join(step_dir, piece), "r+b") as f:
        f.truncate(4)
    with pytest.raises(ValueError, match="truncated"):
        _port_trainer(2, str(tmp_path / "a"), resume=True)
    os.makedirs(tmp_path / "o" / "7")
    with pytest.raises(RuntimeError, match="orbax-format"):
        _port_trainer(2, str(tmp_path / "o"), resume=True)
    _port_trainer(1, str(tmp_path / "e"), algorithm="q8_ring", error_feedback=True)
    with pytest.raises(ValueError, match="partial=True"):
        _port_trainer(2, str(tmp_path / "e"), resume=True, algorithm="q8_ring")


@pytest.mark.parametrize("direction", ["jax_then_port", "port_then_jax"])
def test_trainer_resumes_across_packages(direction, tmp_path):
    """Two epochs in one package with a checkpoint, resumed to four in the
    other: the resumed epochs track the JAX package's straight four-epoch
    run at ``test_trainer_epochs_match_jax_trainer``'s tolerances."""
    jdata_ = jdata.synthetic_classification(900, 32, 10, seed=3)
    tdata_ = tdata.synthetic_classification(900, 32, 10, seed=3)
    jmlp = JaxMLP((32, 64, 10))
    jparams = jmlp.init(0)
    kw = dict(batch_size=64, lr=0.05, optimizer="adamw", seed=1)
    ck = str(tmp_path / "ck")
    _, jhist, jacc = JaxTrainer(jmlp, JaxTrainConfig(dp=1, epochs=4, **kw)).train(jdata_, jparams)
    port = lambda epochs, **c: Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(  # noqa: E731
        epochs=epochs, checkpoint_dir=ck, **kw, **c)).train(
            tdata_, params_from_jax(jax.tree.map(np.asarray, jparams)))
    jax_run = lambda epochs, **c: JaxTrainer(jmlp, JaxTrainConfig(  # noqa: E731
        dp=1, epochs=epochs, checkpoint_dir=ck, **kw, **c)).train(jdata_, jparams)
    if direction == "jax_then_port":
        jax_run(2)
        _, hist, acc = port(4, resume=True)
    else:
        port(2)
        _, hist, acc = jax_run(4, resume=True)
    assert [h["epoch"] for h in hist] == [3, 4]
    for g, w in zip(hist, jhist[2:]):
        np.testing.assert_allclose(g["avg_loss"], w["avg_loss"], rtol=1e-4, atol=1e-6)
        assert abs(g["train_accuracy"] - w["train_accuracy"]) <= 2 / 810
    assert abs(acc - jacc) <= 1 / 90


# ---- dp = 2 over gloo (spawned; module level so the children import it) ------------


def _dp_worker(rank, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"), "cpu")
    written = []
    real_snapshot = native.snapshot

    def spy(*args, **kwargs):
        snap = real_snapshot(*args, **kwargs)
        written.append(sorted(fn for fn, _ in snap.blobs))
        return snap

    native.snapshot = spy
    data = tdata.synthetic_classification(**TRAIN_DATA)

    def run(epochs, name, resume=False, **kw):
        cfg = TrainConfig(epochs=epochs, batch_size=32, lr=0.05, checkpoint_dir=os.path.join(
            tmp, name), resume=resume, seed=3, **kw)
        return Trainer(MLP((16, 32, 4), device="cpu"), cfg, mesh=mesh).train(data)

    ef = dict(optimizer="momentum", algorithm="q8_ring", error_feedback=True)
    out = {"straight": run(4, "a", **ef)[0]}
    written.clear()
    run(2, "b", **ef)
    out["written"] = list(written)
    out["resumed"] = run(4, "b", resume=True, **ef)[0]
    _, out["auto_hist1"], _ = run(2, "c")
    _, out["auto_hist2"], _ = run(4, "c", resume=True)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_dp2")
    mp.spawn(_dp_worker, args=(str(tmp),), nprocs=2, join=True)
    return str(tmp), [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                      for r in range(2)]


def test_dp2_q8_error_feedback_kill_and_resume_bit_identical(dp_runs):
    """The dp = 2 ``Trainer`` under q8_ring with error feedback: four epochs
    straight equal two, a kill and a resume to four, bit for bit on both
    ranks (the residuals ride the checkpoint); the manifest holds ``ef/<p>``
    leaves of shape [2, ...] in two pieces, and each rank wrote only its own
    row of them (rank 0 also the replicated state)."""
    tmp, ranks = dp_runs
    for out in ranks:
        assert all(torch.equal(out["straight"][k], out["resumed"][k]) for k in out["straight"])
    step_dir = _step_dir(os.path.join(tmp, "b"), 2)
    leaves = native.read_manifest(step_dir)["leaves"]
    ef = [e for e in leaves if e["path"].startswith("ef/")]
    assert [e["path"] for e in ef] == ["ef/b0", "ef/b1", "ef/w0", "ef/w1"]
    assert [e["shape"] for e in ef] == [[2, 32], [2, 4], [2, 16, 32], [2, 32, 4]]
    assert all(len(e["pieces"]) == 2 and e["dtype"] == "float32" for e in ef)
    ef_files = {p["file"] for e in ef for p in e["pieces"]}
    all_files = {p["file"] for e in leaves if "pieces" in e for p in e["pieces"]}
    for r, out in enumerate(ranks):
        for files in out["written"]:  # the epoch-1 and epoch-2 saves
            own_ef = {f for f in ef_files if f.endswith(f"_P{r:03d}.bin")}
            assert set(files) == (own_ef | (all_files - ef_files) if r == 0 else own_ef)
    assert len(ranks[0]["written"]) == len(ranks[1]["written"]) == 2


def test_dp2_trainer_auto_resume(dp_runs):
    """Mirror of the JAX package's ``test_trainer_auto_resume_native`` at
    dp = 2: the epoch-2 checkpoint with its loader position, then a resume
    that runs epochs 3 and 4 only, identically on both ranks."""
    tmp, ranks = dp_runs
    with CheckpointManager(os.path.join(tmp, "c")) as m:
        assert m.all_steps() == [2, 3, 4]
        assert m.iterator_state(2) == {"epoch": 2, "consumed": 0}
    losses = [[(h["epoch"], h["avg_loss"], h["train_accuracy"]) for h in out["auto_hist2"]]
              for out in ranks]
    assert [e for e, _, _ in losses[0]] == [3, 4] and losses[0] == losses[1]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--model", "tiny", "--seq_len", "32", "--batch_size", "4",
       "--grad_accum", "1", "--warmup_steps", "1", "--log_every", "1"]


def _one_window_corpus(path) -> str:
    """A corpus of exactly one window (seq + 1 bytes): every batch of every
    stream is the same, whatever its seed, so a resumed run (whose stream
    moves on to seed + start, as in the JAX example) sees the straight run's
    batches."""
    with open(path, "wb") as f:
        f.write(train_gpt2._generated_stories(64, 0)[:33])
    return str(path)


def _saved_tree(directory, step):
    return native.restore_tree(_step_dir(directory, step))


@pytest.mark.parametrize("extra", [[], ["--dp", "2"], ["--cp", "2"], ["--family", "llama"]],
                         ids=["single", "dp2", "cp2", "llama"])
def test_train_gpt2_resume_bit_identical(extra, tmp_path, monkeypatch):
    """Four steps straight against two, then two more resumed from the
    checkpoint: the same last loss and the same saved step-4 state (weights,
    AdamW moments and counts), bit for bit; the resumed stream is seeded
    seed + 2 and the cosine horizon covers 4 steps. Single device, two dp
    ranks, two cp ranks (replicated state: rank 0 writes it) and Llama."""
    args = CLI + ["--data", _one_window_corpus(tmp_path / "corpus.txt"), *extra]
    seeds = []
    real = tdata.lm_window_batches

    def spy(tokens, seq_len, batch_size, seed=0, steps=None):
        seeds.append(seed)
        return real(tokens, seq_len, batch_size, seed, steps)

    monkeypatch.setattr(tdata, "lm_window_batches", spy)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = train_gpt2.main(args + ["--steps", "4", "--checkpoint_dir", a])
    first = train_gpt2.main(args + ["--steps", "2", "--checkpoint_dir", b])
    resumed = train_gpt2.main(args + ["--steps", "2", "--checkpoint_dir", b])
    assert first["first_loss"] == straight["first_loss"]
    assert resumed["last_loss"] == straight["last_loss"]
    want, got = _saved_tree(a, 4), _saved_tree(b, 4)
    assert native.tree_leaves_with_path(want)[0][0] == "opt_state/1/0/count"
    for (pw, w), (pg, g) in zip(native.tree_leaves_with_path(want),
                                native.tree_leaves_with_path(got)):
        assert pw == pg and torch.equal(w, g), pw
    assert int(got["opt_state"]["1"]["2"]["count"]) == 4  # no template: dict levels
    if not extra or extra[0] == "--family":  # in this process: the streams' seeds
        assert seeds == [0, 0, 2]


def test_train_gpt2_resumes_a_jax_example_checkpoint(tmp_path):
    """The JAX example's two-step checkpoint, resumed for two more steps by
    the example and by the port's CLI: the same state tree at step 4, the
    weights within the AdamW trajectory test's bound."""
    import examples.train_gpt2 as jexample

    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(train_gpt2._generated_stories(20000, 0))
    common = ["--model", "tiny", "--seq_len", "32", "--batch_size", "4", "--grad_accum", "1",
              "--warmup_steps", "1", "--log_every", "2", "--data", str(corpus), "--steps", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jexample.main(common + ["--dp", "1", "--checkpoint_dir", a])
    shutil.copytree(a, b)
    jexample.main(common + ["--dp", "1", "--checkpoint_dir", a])
    train_gpt2.main(common + ["--device", "cpu", "--checkpoint_dir", b])
    want, got = _saved_tree(a, 4), _saved_tree(b, 4)
    assert [p for p, _ in native.tree_leaves_with_path(got)] == \
        [p for p, _ in native.tree_leaves_with_path(want)]
    assert int(got["opt_state"]["1"]["2"]["count"]) == 4
    for (path, w), (_, g) in zip(native.tree_leaves_with_path(want["params"]),
                                 native.tree_leaves_with_path(got["params"])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=path)


def test_generate_text_serves_a_jax_checkpoint(tmp_path):
    """``generate_text --checkpoint_dir`` on a checkpoint the JAX package's
    Checkpointer wrote ({params, opt_state}, as ``examples/train_gpt2.py``
    saves it; weights from seed 7 scaled by 5, so greedy decoding is
    decisive): the continuations equal ``examples/generate_text.py``'s on
    the same directory, and differ from the port's fresh weights."""
    import examples.generate_text as jgenerate

    jmodel = jgpt2.GPT2(jgpt2.GPT2Config.tiny(vocab_size=256))
    params = jax.tree.map(lambda a: a * 5, jmodel.init(7))
    ck = str(tmp_path / "ck")
    saver = JaxCheckpointer(ck)
    saver.save(3, params, optax.adamw(1e-3).init(params))
    saver.close()
    flags = ["--model", "tiny", "--checkpoint_dir", ck, "--temperature", "0", "--max_new_tokens",
             "12", "--n_samples", "1", "--prompt", "the dog "]
    want = jgenerate.main(flags)
    got = generate_text.main(flags + ["--device", "cpu"])
    fresh = generate_text.main(["--device", "cpu", *flags[:2], *flags[4:]])
    assert got == want and got != fresh


def test_batcher_from_a_jax_checkpoint_matches_the_jax_batcher(tmp_path):
    """``ContinuousBatcher.from_checkpoint`` on a checkpoint the JAX package
    wrote ({params, opt_state, meta}): the greedy tokens equal the JAX
    batcher's ``from_checkpoint`` on the same directory."""
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config.tiny())
    params = jmodel.init(11)
    with JaxManager(str(tmp_path / "ck")) as m:
        m.save(10, {"params": params, "opt_state": optax.adam(1e-3).init(params),
                    "meta": {"epoch": 10}})
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, n) for n in (5, 21, 12)]
    results = []
    for srv, cast in ((JaxBatcher.from_checkpoint(jmodel, str(tmp_path / "ck"), n_slots=2),
                       lambda p: p.astype(np.int32)),
                      (ContinuousBatcher.from_checkpoint(
                          tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"),
                          str(tmp_path / "ck"), n_slots=2), lambda p: p)):
        rids = [srv.submit(cast(p), 6) for p in prompts]
        done = srv.run()
        results.append([list(map(int, done[r])) for r in rids])
    assert results[1] == results[0]
    # restored onto a mesh (tests/test_torch_tp_serving.py), the weights stay
    # unquantized, as in the JAX batcher: a tp = 1 mesh stands in here
    one = types.SimpleNamespace(shape={"tp": 1}, group=lambda axis: None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="single-device replicas"):
        ContinuousBatcher.from_checkpoint(tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"),
                                          str(tmp_path / "ck"), mesh=one, weight_quant="int8")


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def _counter(pkg, name, **labels):
    reg = pkg.get_registry()
    return reg.counter(name, labels=tuple(sorted(labels))).value(**labels)


def test_manager_metrics_events_and_staging_source_equal_jax(tmp_path, monkeypatch):
    """The same saves through both managers with observability on: the
    ``checkpoint_saves_total{mode}`` and ``checkpoint_gc_total`` counters,
    the ``checkpoint_commit`` events and the commit histogram's count; and,
    while a commit is held back, the writer's ``checkpoint_staging`` ledger
    source claims the snapshot's bytes (the same in both), then 0."""
    for pkg in (jobs, tobs):
        pkg.enable(forensics=False)
    jtree, ttree = _mixed_trees()
    staged = []
    for pkg, manager, mod, tree, d in ((jobs, JaxManager, jnative, jtree, "j"),
                                       (tobs, CheckpointManager, native, ttree, "t")):
        gate = threading.Event()
        real = mod.commit

        def held(*args, real=real, gate=gate):
            assert gate.wait(30)
            return real(*args)

        monkeypatch.setattr(mod, "commit", held)
        with manager(str(tmp_path / d), max_to_keep=2) as m:
            m.save(1, tree, wait=False)
            staged.append(sum(pkg.get_memory_ledger().claimed()["checkpoint_staging"].values()))
            gate.set()
            m.wait_until_finished()
            assert sum(pkg.get_memory_ledger().claimed()["checkpoint_staging"].values()) == 0
            for s, wait in ((2, False), (3, False), (4, True)):
                m.save(s, tree, wait=wait)
        monkeypatch.setattr(mod, "commit", real)
    assert staged[1] == staged[0] == 4 * 12 + 2 * 5 + 4 * 3 + 4 + 4
    for mode, n in (("sync", 1), ("async", 3)):
        assert _counter(tobs, "checkpoint_saves_total", mode=mode) == n == \
            _counter(jobs, "checkpoint_saves_total", mode=mode)
    assert _counter(tobs, "checkpoint_gc_total") == _counter(jobs, "checkpoint_gc_total") == 2
    commits = [[e for e in pkg.get_flight_recorder().events() if e["kind"] == "checkpoint_commit"]
               for pkg in (jobs, tobs)]
    assert [(e["label"], e["ok"]) for e in commits[1]] == \
        [(e["label"], e["ok"]) for e in commits[0]] == [(f"step {s}", True) for s in (1, 2, 3, 4)]
    hist = [[r for r in pkg.get_registry().collect() if r["name"] == "checkpoint_commit_ms"]
            for pkg in (jobs, tobs)]
    assert [r["count"] for r in hist[1]] == [r["count"] for r in hist[0]] == [4]


def test_trainer_checkpoint_hooks_equal_jax(tmp_path):
    """The Trainer's checkpoint hooks against the JAX trainer's on the same
    runs (two epochs saved every epoch, then a resume to three): the
    ``checkpoint_save`` events (epoch, step), the ``checkpoint_stall``
    phase in the breakdown, and the goodput ``restore`` mark of the
    resume."""
    jdata_ = jdata.synthetic_classification(900, 32, 10, seed=3)
    tdata_ = tdata.synthetic_classification(900, 32, 10, seed=3)
    jmlp = JaxMLP((32, 64, 10))
    jparams = jmlp.init(0)
    kw = dict(batch_size=64, lr=0.05, seed=1)
    for pkg in (jobs, tobs):
        pkg.enable(forensics=False)
    jck, tck = str(tmp_path / "j"), str(tmp_path / "t")
    JaxTrainer(jmlp, JaxTrainConfig(dp=1, epochs=2, checkpoint_dir=jck, **kw)).train(jdata_,
                                                                                    jparams)
    jtrainer = JaxTrainer(jmlp, JaxTrainConfig(dp=1, epochs=3, checkpoint_dir=jck, resume=True,
                                               **kw))
    jtrainer.train(jdata_, jparams)
    jres = jtrainer.metrics.records[-1]
    start = params_from_jax(jax.tree.map(np.asarray, jparams))
    Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(epochs=2, checkpoint_dir=tck,
                                                         **kw)).train(tdata_, start)
    trainer = Trainer(MLP((32, 64, 10), device="cpu"), TrainConfig(
        epochs=3, checkpoint_dir=tck, resume=True, **kw))
    trainer.train(tdata_, start)
    saves = [[(e["epoch"], e["step"]) for e in pkg.get_flight_recorder().events()
              if e["kind"] == "checkpoint_save"] for pkg in (jobs, tobs)]
    assert saves[1] == saves[0] == [(1, 12), (2, 24), (3, 36)]
    starts = [[e["start_epoch"] for e in pkg.get_flight_recorder().events()
               if e["kind"] == "train_start"] for pkg in (jobs, tobs)]
    assert starts[1] == starts[0] == [1, 3]
    summary = trainer.metrics.records[-1]
    assert summary["obs_step_breakdown"]["phases"]["checkpoint_stall"]["count"] == 1
    marks = [(m["event"], m.get("epoch")) for m in summary["obs_goodput"]["events"]]
    jmarks = [(m["event"], m.get("epoch")) for m in jres["obs_goodput"]["events"]]
    assert marks == jmarks == [("restore", 2), ("checkpoint_save", 3)]
    assert _counter(tobs, "checkpoint_saves_total", mode="async") == \
        _counter(jobs, "checkpoint_saves_total", mode="async") == 3
