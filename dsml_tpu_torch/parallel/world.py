"""The rank pool: long-lived worker processes that join and leave process
meshes — the port's stand-in for the JAX package's single-process device
fleet (a port-only module, like ``parallel/peer.py``).

The JAX controller (``dsml_tpu/runtime/controller.py``) moves training state
between device sets inside one process: a mesh over ``devices[:4]``, then
one over the survivors. The port's state lives in rank processes
(``parallel/mesh.py``), so a device set becomes a set of *slots*:

- :class:`WorkerPool` keeps one process per slot, alive across meshes. A
  slot that is killed has its process terminated for real (SIGKILL): its
  state is gone. A slot that is restored gets a new worker process.
- :class:`World` is one mesh over a subset of the slots: rank r is the r-th
  slot of the list it was formed over (the JAX survivor mesh puts the
  survivors in device-id order, so the port gives rank r the slot JAX puts
  at mesh position r). A world joins through ``parallel.mesh.build_mesh``
  over a rendezvous file no earlier world used, in a directory of its own
  (the rings' notice boards live there), and leaves in two local phases
  ordered by the supervisor (every rank unmaps its neighbours' CUDA slots,
  then every rank frees its own and destroys its process group): no
  collective runs in a leave, so a world with a dead rank leaves too.
- The supervisor (the caller's process) talks to each worker over a pipe:
  join, step(k) → loss, export this rank's state blocks, load blocks,
  restore a checkpoint, save, leave, exit. It never trains.

State moves through files, once each way: an export writes each survivor's
blocks straight into one ``.npy`` per leaf of the JAX ``init_hybrid``
layout (``checkpoint.optim_state.mesh_state``) under a directory the
supervisor created zero-filled (so a piece no survivor holds stays zero),
and a load reads each new rank's blocks from them. That host tree
(:class:`HostState`) is the JAX package's host round-trip.

Failure is fast, never a hang. The supervisor waits on every worker's pipe
and process sentinel together; when a worker dies it writes the world's
abort file, which the CUDA rings' notice boards (``parallel/peer.py``) and
the checkpoint commits' file barriers (:class:`FileBarrier`) poll: they
raise within milliseconds. A gloo operation fails at once on a rank whose
peer died (gloo reports the closed connection), and within
:data:`COLLECTIVE_TIMEOUT_S` on a rank that waits on a live peer that
stopped (gloo closes a connection only when its process exits; on the card
that timeout is :data:`CUDA_COLLECTIVE_TIMEOUT_S`, the rings' abort file
doing the waking). The step's
error comes before
``optimizer.step`` (the gradient sync is the first cross-rank operation
after the backward), so a survivor keeps its pre-step state and the
controller retries the same step index.

On the card every slot's device is ``cuda:0`` (the slots share one card);
on the CPU it is ``cpu``, chosen explicitly. A worker that fails to spawn
or to join raises in the supervisor; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import shutil
import signal
import tempfile
import time
import traceback
from multiprocessing import connection

import numpy as np

from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["FileBarrier", "HostState", "TrainRecipe", "WorkerError", "WorkerPool", "World",
           "leaf_filename", "piece_holders", "read_block", "write_block"]

log = get_logger("world")

ABORT_FILE = "ABORT"
JOIN_TIMEOUT_S = 600.0   # a join or a step that takes longer than this raises
REPLY_GRACE_S = 30.0     # survivors of a dead rank must answer within this
# a CPU world's gloo operations raise after this wait: a rank blocked on a
# live peer that itself stopped (its neighbour died) cannot be woken
# otherwise — gloo closes a connection only when its process exits. On the
# card the rings poll the abort file, and the gloo timeout only bounds a
# hang (a loaded host must not trip it).
COLLECTIVE_TIMEOUT_S = 15.0
CUDA_COLLECTIVE_TIMEOUT_S = 120.0


class WorkerError(RuntimeError):
    """A worker's command failed (the worker is alive; its traceback is in
    the message)."""


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------


OPT_KIND = "adam"  # the optax kind of ``checkpoint.optim_state`` a recipe's optimizer is


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    """How a worker builds its rank of the training job: GPT-2 of ``config``
    under ``torch.optim.Adam(lr)`` (the optax ``adam(lr)`` of the JAX
    controller) and the step's options (``parallel.hybrid.
    make_hybrid_train_step``). ``weights`` names a file of the whole
    model's ``state_dict`` holding the init's weights (``torch.save``): a
    world formed with a seed loads its ranks' shards of it instead of
    drawing them again."""

    config: object
    lr: float = 1e-2
    attn_impl: str | None = None
    dp_sync: str = "xla"
    weights: str | None = None  # a state_dict file of the whole model's init weights

    def n_params(self) -> int:
        from dsml_tpu_torch.models.gpt2 import GPT2

        return GPT2(self.config, device="meta").n_params()

    def make_optimizer(self, params):
        import torch

        return torch.optim.Adam(params, lr=self.lr)


# ---------------------------------------------------------------------------
# the host tree
# ---------------------------------------------------------------------------


def leaf_filename(path: str) -> str:
    """The ``.npy`` file of a tree path in a host-state directory."""
    return path.replace("/", "__") + ".npy"


_BF16 = "bfloat16"


def _np_dtype(name: str) -> np.dtype:
    """numpy dtype a torch dtype name is stored as (bf16 as its 16 bits)."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


@dataclasses.dataclass
class HostState:
    """The training state on the host in the JAX ``init_hybrid`` layout: one
    ``.npy`` per array leaf under ``directory`` (``leaves``: tree path →
    (global shape, torch dtype name)) and the scalar leaves (the optimizer
    counts) in ``scalars``."""

    directory: str
    leaves: dict
    scalars: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, directory: str, leaves: dict, scalars: dict | None = None) -> "HostState":
        """Zero-filled files for ``leaves`` (sparse until written)."""
        os.makedirs(directory, exist_ok=True)
        for path, (shape, dtype) in leaves.items():
            np.lib.format.open_memmap(os.path.join(directory, leaf_filename(path)), mode="w+",
                                      dtype=_np_dtype(dtype), shape=tuple(shape))
        return cls(directory, dict(leaves), dict(scalars or {}))

    def array(self, path: str, mode: str = "r") -> np.ndarray:
        return np.load(os.path.join(self.directory, leaf_filename(path)), mmap_mode=mode)

    def arrays(self) -> dict:
        """``{path: numpy array}`` in memory (bf16 as float32 values)."""
        import torch

        out = {}
        for path, (_, dtype) in self.leaves.items():
            arr = np.array(self.array(path))
            if dtype == _BF16:
                arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).float().numpy()
            out[path] = arr
        return out

    def tree(self) -> dict:
        """``{"params", "opt_state"}`` as nested dicts and lists of numpy
        arrays and scalars (the JAX host tree's form)."""
        from dsml_tpu_torch.checkpoint.optim_state import _lists

        root: dict = {}
        for path, leaf in {**self.arrays(), **self.scalars}.items():
            *parents, last = path.split("/")
            node = root
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = leaf
        return _lists(root)

    def write_arrays(self, directory: str, arrays: dict) -> "HostState":
        """A new host state under ``directory`` holding ``arrays`` (``{path:
        numpy array}`` in this state's dtypes) and this state's scalars."""
        import torch

        leaves = {}
        os.makedirs(directory, exist_ok=True)
        for path, arr in arrays.items():
            dtype = self.dtype_of(path)
            if dtype == _BF16:
                arr = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
                    torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
            np.save(os.path.join(directory, leaf_filename(path)),
                    np.ascontiguousarray(arr, _np_dtype(dtype)))
            leaves[path] = (tuple(arr.shape), dtype)
        return HostState(directory, leaves, dict(self.scalars))

    def dtype_of(self, path: str) -> str:
        if path in self.leaves:
            return self.leaves[path][1]
        # a restacked or unstacked leaf keeps its source's dtype
        for p, (_, dt) in self.leaves.items():
            if p.split("/")[-1] == path.split("/")[-1]:
                return dt
        raise KeyError(path)

    def nbytes(self) -> int:
        return sum(int(np.prod(s)) * _np_dtype(d).itemsize for s, d in self.leaves.values())

    def remove(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)


def _span(shape, index):
    """(first element, count) when the block ``index`` of a row-major leaf
    of ``shape`` is one contiguous run (every dim after the last partial one
    whole, every dim before it one wide), else None."""
    partial = [d for d, (a, b) in enumerate(index) if (a, b) != (0, shape[d])]
    last = partial[-1] if partial else -1
    if any(index[d][1] - index[d][0] != 1 for d in range(last)):
        return None
    start, stride = 0, 1
    for d in range(len(shape) - 1, -1, -1):
        start += index[d][0] * stride
        stride *= shape[d]
    count = 1
    for a, b in index:
        count *= b - a
    return start, count


def write_block(path: str, index, block: np.ndarray) -> None:
    """Write ``block`` at ``index`` of the ``.npy`` leaf at ``path``: one
    positioned write when the block is contiguous there, else through a
    map of the file."""
    dst = np.load(path, mmap_mode="r")
    shape, itemsize, off = dst.shape, dst.dtype.itemsize, dst.offset
    del dst
    span = _span(shape, index)
    if span is not None:
        with open(path, "r+b") as f:
            os.pwrite(f.fileno(), np.ascontiguousarray(block).data.cast("B"),
                      off + span[0] * itemsize)
        return
    dst = np.load(path, mmap_mode="r+")
    dst[tuple(slice(a, b) for a, b in index)] = block.view(dst.dtype)
    dst.flush()


def read_block(path: str, index) -> np.ndarray:
    """The block at ``index`` of the ``.npy`` leaf at ``path``, as a fresh
    writable array (one positioned read when it is contiguous there)."""
    src = np.load(path, mmap_mode="r")
    shape, dtype, off = src.shape, src.dtype, src.offset
    span = _span(shape, index)
    if span is None:
        return np.array(src[tuple(slice(a, b) for a, b in index)])
    del src
    buf = bytearray(span[1] * dtype.itemsize)
    with open(path, "rb") as f:
        f.seek(off + span[0] * dtype.itemsize)
        f.readinto(buf)
    return np.frombuffer(buf, dtype).reshape([b - a for a, b in index])


def piece_holders(layout: dict, slots: list, path: str) -> dict:
    """``{piece: [slots holding it]}`` of leaf ``path`` of ``layout``
    (``{path: (shape, dtype, [block index of rank r])}``, rank r = slot
    ``slots[r]``); a piece is the ``((start, stop), ...)`` of a block, its
    slots in rank order."""
    out: dict = {}
    for r, idx in enumerate(layout[path][2]):
        out.setdefault(tuple(tuple(ab) for ab in idx), []).append(slots[r])
    return out


# ---------------------------------------------------------------------------
# the checkpoint commits' barrier
# ---------------------------------------------------------------------------


class FileBarrier:
    """A barrier over the ``world`` ranks of a world through files in
    ``directory``: call number k of rank r creates ``b<k>_<r>`` and waits
    for every rank's. It polls the world's abort file and raises when it
    appears, so a checkpoint commit in flight when a rank dies fails
    instead of waiting on a dead process."""

    def __init__(self, directory: str, rank: int, world: int, abort_path: str,
                 timeout_s: float = JOIN_TIMEOUT_S):
        self.directory, self.rank, self.world = directory, rank, world
        self.abort_path, self.timeout_s = abort_path, timeout_s
        self.calls = 0
        os.makedirs(directory, exist_ok=True)

    def __call__(self) -> None:
        k = self.calls
        self.calls += 1
        open(os.path.join(self.directory, f"b{k}_{self.rank}"), "w").close()
        deadline = time.monotonic() + self.timeout_s
        want = [os.path.join(self.directory, f"b{k}_{r}") for r in range(self.world)]
        while not all(os.path.exists(p) for p in want):
            if os.path.exists(self.abort_path):
                raise RuntimeError("checkpoint barrier: the world was aborted (a rank died)")
            if time.monotonic() > deadline:
                raise RuntimeError(f"checkpoint barrier {k}: not every rank arrived within "
                                   f"{self.timeout_s} s")
            time.sleep(0.002)


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------


def _map_tree(fn, node, prefix=""):
    """``fn(path, leaf)`` over a nested dict / list tree, same form out."""
    if isinstance(node, dict):
        return {k: _map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(node)]
    return fn(prefix, node)


class _Rank:
    """One worker's side of the protocol (see the module docstring)."""

    def __init__(self, slot: int, device: str):
        self.slot, self.device, self.recipe = slot, device, None
        self.mesh = self.model = self.optimizer = self.step_fn = self.manager = None
        self.count = 0
        self.abort_path = None
        self.broken = False

    # -- membership ------------------------------------------------------------

    def join(self, world_dir: str, rank: int, world_size: int, spec: dict, ckpt_dir: str,
             seed: int | None, recipe: TrainRecipe, slot: int, max_to_keep: int = 0,
             timeout_s: float = COLLECTIVE_TIMEOUT_S):
        """Join the world's mesh as ``rank``; build ``recipe``'s model (from
        ``seed``, or unfilled when a load follows: ``seed=None``), the
        optimizer, the step (an explicit ``dp_sync`` on a dp-only mesh, the
        process group's on any other, as the hybrid step requires) and the
        checkpoint manager. Returns this rank's layout."""
        from dsml_tpu_torch.checkpoint import CheckpointManager
        from dsml_tpu_torch.models.gpt2 import GPT2
        from dsml_tpu_torch.parallel.hybrid import (hybrid_model, init_hybrid,
                                                    make_hybrid_train_step, shard_fsdp)
        from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

        import torch

        r = self.recipe = recipe
        self.slot = slot
        self.abort_path = os.path.join(world_dir, ABORT_FILE)
        self.mesh = build_mesh(MeshSpec(**spec), rank, world_size,
                               os.path.join(world_dir, "rendezvous"), self.device,
                               timeout_s=timeout_s)
        model = hybrid_model(GPT2, r.config, self.mesh)
        optimizer = r.make_optimizer(model.parameters())
        if seed is not None and r.weights:
            with torch.no_grad():
                model.load_full(torch.load(r.weights, mmap=True))
        if seed is None or r.weights:
            model, optimizer = shard_fsdp(model, optimizer, self.mesh)
        else:
            model, optimizer = init_hybrid(model, optimizer, self.mesh, seed=seed)
        self.model, self.optimizer = model, optimizer
        dp_only = all(v == 1 for a, v in self.mesh.shape.items() if a != "dp")
        self.step_fn = make_hybrid_train_step(model, optimizer, self.mesh, attn_impl=r.attn_impl,
                                              dp_sync=r.dp_sync if dp_only else "xla",
                                              bucket_size_mb=None)
        self.manager = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep or None, mesh=self.mesh)
        if world_size > 1:  # commits barrier through files the abort reaches
            self.manager._barrier = FileBarrier(os.path.join(world_dir, "ckpt_barrier"), rank,
                                                world_size, self.abort_path)
        self.count = 0
        self.broken = False
        return self._layout()

    def _state(self):
        from dsml_tpu_torch.checkpoint.optim_state import mesh_state

        return mesh_state(self.model, self.optimizer, self.mesh, OPT_KIND, self.count)

    def _layout(self) -> dict:
        """``{path: (global shape, dtype, this rank's index)}`` of every
        array leaf, and the scalars' values."""
        from dsml_tpu_torch.checkpoint.native import MeshShard

        out, scalars = {}, {}

        def visit(path, leaf):
            if isinstance(leaf, MeshShard):
                out[path] = (tuple(int(g) for g in leaf.shape),
                             str(leaf.tensor.dtype).replace("torch.", ""), leaf.index)
            else:
                scalars[path] = int(leaf)
            return leaf

        _map_tree(visit, self._state())
        return {"leaves": out, "scalars": scalars}

    def unmap(self):
        """Leave, phase 1: drain the device, settle the checkpoint writer
        (a commit whose barrier the abort broke is dropped) and close this
        rank's mappings of its neighbours' CUDA slots."""
        import torch

        if self.mesh is None:
            return None
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        if self.manager is not None:
            try:
                self.manager.close()
            except Exception as e:  # noqa: BLE001 — an aborted commit stays invisible
                log.warning("slot %d: checkpoint commit dropped at leave: %s", self.slot, e)
            self.manager = None
        for g in self.mesh.groups.values():
            if g._ipc is not None:
                g._ipc.unmap_local()
        return None

    def free(self):
        """Leave, phase 2 (after every rank's phase 1): free this rank's
        slots and destroy its process group."""
        import torch
        import torch.distributed as dist

        if self.mesh is not None:
            for g in self.mesh.groups.values():
                if g._ipc is not None:
                    g._ipc.free_local()
                    g._ipc = None
        self.mesh = self.model = self.optimizer = self.step_fn = None
        if dist.is_initialized():
            dist.destroy_process_group()
        if torch.cuda.is_available() and self.device.startswith("cuda"):
            torch.cuda.empty_cache()
        return None

    # -- training --------------------------------------------------------------

    def step(self, x, y, die_before_sync: bool = False):
        """One training step on the global batch; returns the loss and the
        kernel launches it made. With ``die_before_sync`` the process
        SIGKILLs itself after its backward, before the gradient sync (the
        chaos harness's mid-step kill)."""
        import torch

        from dsml_tpu_torch.parallel import hybrid

        if self.broken:
            raise RuntimeError("this rank's world is broken; leave it first")
        before = _launch_counts()
        sync = hybrid.bucketed_all_reduce
        if die_before_sync:
            def dying(*args, **kwargs):
                os.kill(os.getpid(), signal.SIGKILL)

            hybrid.bucketed_all_reduce = dying
        try:
            loss = float(self.step_fn(torch.from_numpy(np.asarray(x)),
                                      torch.from_numpy(np.asarray(y))))
        except Exception:
            self.broken = True  # the world is dead: leave it, keep the state
            raise
        finally:
            hybrid.bucketed_all_reduce = sync
        self.count += 1
        after = _launch_counts()
        return {"loss": loss, "launches": {k: after[k] - before[k] for k in after
                                           if after[k] != before[k]}}

    # -- state motion ----------------------------------------------------------

    def export(self, directory: str, paths: list):
        """Write this rank's block of each leaf in ``paths`` into the host
        state's files under ``directory``; returns the scalars."""
        from dsml_tpu_torch.checkpoint.native import MeshShard, _host_array

        leaves = {}

        def visit(path, leaf):
            leaves[path] = leaf
            return leaf

        _map_tree(visit, self._state())
        for path in paths:
            leaf = leaves[path]
            write_block(os.path.join(directory, leaf_filename(path)), leaf.index,
                        _host_array(leaf.tensor))
        return {p: int(v) for p, v in leaves.items() if not isinstance(v, MeshShard)}

    def load(self, directory: str, scalars: dict):
        """Load this rank's blocks from a host state under ``directory``."""
        import torch

        from dsml_tpu_torch.checkpoint.native import MeshShard
        from dsml_tpu_torch.checkpoint.optim_state import load_mesh_state

        def block(path, leaf):
            if not isinstance(leaf, MeshShard):
                return torch.tensor(int(scalars[path]), dtype=torch.int32)
            # a fresh array: the optimizer updates its moments in place
            arr = read_block(os.path.join(directory, leaf_filename(path)), leaf.index)
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
                if leaf.tensor.dtype == torch.bfloat16 else torch.from_numpy(arr)
            return t.to(device=leaf.tensor.device, dtype=leaf.tensor.dtype)

        tree = _map_tree(block, self._state())
        self.count = load_mesh_state(self.model, self.optimizer, self.mesh, OPT_KIND, tree)
        return self.count

    def restore(self, step: int):
        """Load this rank's blocks of checkpoint ``step`` (any width of the
        same pp form, ``checkpoint.native``'s relayout)."""
        from dsml_tpu_torch.checkpoint.optim_state import load_mesh_state

        tree = self.manager.restore(step, template=self._state(), partial=True)
        self.count = load_mesh_state(self.model, self.optimizer, self.mesh, OPT_KIND, tree)
        return self.count

    def save(self, step: int, meta: dict, iterator_state: dict | None = None):
        self.manager.save(step, self._state(), meta=meta, iterator_state=iterator_state,
                          wait=False)
        return None

    def wait_saves(self):
        self.manager.wait_until_finished()
        return None


def _launch_counts() -> dict:
    """The hand-written kernels' launch counters of this process (each
    wrapper counts the launches of its kernel)."""
    import sys

    out = {}
    for mod in ("dsml_tpu_torch.ops.flash", "dsml_tpu_torch.ops.paged_attention",
                "dsml_tpu_torch.ops.quantization"):
        m = sys.modules.get(mod)
        if m is not None:
            out.update({k[:-len("_launches")]: v for k, v in vars(m).items()
                        if k.endswith("_launches") and isinstance(v, int)})
    return out


def _worker_main(slot: int, conn, device: str, threads: int) -> None:
    """A slot's process: serve the supervisor's commands until ``exit``."""
    import faulthandler

    import torch

    faulthandler.enable()  # a crash leaves its stack in the supervisor's log

    if threads:
        torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(torch.device(device))
        torch.empty(1, device=device)  # the context now, before the first join
    # the modules a join uses, now too: a restored slot's first join is then
    # as quick as any other's
    import dsml_tpu_torch.checkpoint  # noqa: F401
    import dsml_tpu_torch.models.gpt2  # noqa: F401
    import dsml_tpu_torch.parallel.hybrid  # noqa: F401
    rank = _Rank(slot, device)
    conn.send(("ready", os.getpid()))
    while True:
        try:
            op, kwargs = conn.recv()
        except EOFError:
            return
        if op == "exit":
            conn.send(("ok", None))
            return
        try:
            out = getattr(rank, op)(**kwargs)
            conn.send(("ok", out))
        except Exception as e:  # noqa: BLE001 — reported to the supervisor
            conn.send(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


# ---------------------------------------------------------------------------
# the supervisor's side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    process: object
    conn: object
    pid: int
    alive: bool = True
    world: "World | None" = None


class WorkerPool:
    """``n_slots`` long-lived worker processes running ``recipe``'s ranks on
    ``device`` (``"cuda"`` — every slot on ``cuda:0`` — or ``"cpu"``).
    ``recipe`` is what a world runs unless :meth:`form` is given another
    (``self.recipe`` may be replaced between worlds). ``threads`` is each
    worker's torch thread count (None = the host's cores over twice the
    slots, at least 1: with every core a rank, gloo's transport threads
    starve; 0 = torch's default). ``workdir``
    holds the worlds' rendezvous files and the host states (a fresh
    temporary directory by default, removed at close). ``launches`` sums
    the kernel launches of every step the pool's worlds ran (each rank's;
    a caller resets it around a path)."""

    def __init__(self, n_slots: int, recipe: TrainRecipe, device: str | None = None,
                 workdir: str | None = None, threads: int | None = None):
        import torch

        from dsml_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        self.device = str(dev)
        self.recipe = recipe
        if threads is None:
            threads = max(1, (os.cpu_count() or 2) // (2 * n_slots))
        self.threads = threads
        self._own_root = workdir is None
        self.root = os.path.abspath(workdir or tempfile.mkdtemp(prefix="dsml_world_"))
        os.makedirs(self.root, exist_ok=True)
        self._ctx = mp.get_context("spawn")
        self.slots: dict[int, _Slot] = {}
        self._worlds = 0
        self._states = 0
        self.launches: dict = {}
        try:
            self._start_all(range(n_slots))
        except BaseException:
            if self._own_root:
                shutil.rmtree(self.root, ignore_errors=True)
            raise

    # -- processes -------------------------------------------------------------

    def _start_all(self, slots) -> None:
        """Start a worker for each of ``slots`` (all at once) and wait until
        every one is ready; a worker that fails to start raises, and the
        others of this call are killed."""
        pending = {}
        try:
            for s in slots:
                parent, child = self._ctx.Pipe()
                proc = self._ctx.Process(target=_worker_main, name=f"dsml-slot{s}",
                                         args=(s, child, self.device, self.threads),
                                         daemon=True)
                proc.start()
                child.close()
                pending[s] = _Slot(proc, parent, 0)
            for s, slot in pending.items():
                ready = connection.wait([slot.conn, slot.process.sentinel],
                                        timeout=JOIN_TIMEOUT_S)
                if slot.conn not in ready:
                    raise RuntimeError(f"worker of slot {s} failed to start (exit code "
                                       f"{slot.process.exitcode})")
                tag, pid = slot.conn.recv()
                if tag != "ready":
                    raise RuntimeError(f"worker of slot {s} sent {tag!r} instead of ready")
                slot.pid = pid
        except BaseException:
            for slot in pending.values():
                slot.process.kill()
                slot.process.join()
            raise
        self.slots.update(pending)

    def alive(self) -> list[int]:
        return [s for s, slot in sorted(self.slots.items()) if slot.alive]

    def is_alive(self, s: int) -> bool:
        return self.slots[s].alive

    def pid(self, s: int) -> int:
        return self.slots[s].pid

    def kill(self, *slots: int, settle: bool = False) -> list[int]:
        """Terminate these slots' processes (SIGKILL): their state is gone.
        A world they belong to is aborted (its abort file written), and a
        checkpoint commit in flight there is dropped — unless ``settle``,
        which first lets the world's in-flight commits land (a kill between
        steps, after the last save committed: the chaos harness's)."""
        if settle:
            for world in {id(w): w for w in (self.slots[s].world for s in slots)
                          if w is not None and w.active}.values():
                try:
                    world.wait_saves()
                except Exception as e:  # noqa: BLE001 — the kill goes ahead
                    log.warning("world %d: saves did not settle before a kill: %s", world.wid, e)
        killed = []
        for s in slots:
            slot = self.slots[s]
            if not slot.alive:
                continue
            slot.process.kill()
            slot.process.join()
            self._mark_dead(s)
            killed.append(s)
        return killed

    def _mark_dead(self, s: int) -> None:
        slot = self.slots[s]
        slot.alive = False
        if slot.world is not None:
            slot.world.abort()
        try:
            slot.conn.close()
        except OSError:
            pass

    def restore(self, *slots: int) -> list[int]:
        """Fresh workers for these dead slots (started together)."""
        dead = [s for s in slots if not self.slots[s].alive]
        self._start_all(dead)
        return sorted(dead)

    def collect(self, commands: dict, timeout: float = JOIN_TIMEOUT_S) -> dict:
        """Send ``{slot: (op, kwargs)}`` and wait for every reply. A worker
        that dies meanwhile aborts its world, and the others must then
        answer within :data:`REPLY_GRACE_S`; dead slots (and survivors that
        did not answer, which are killed) raise :class:`DeviceLost` with
        the replies of the rest in ``.results``. A command that failed in
        a live worker raises :class:`WorkerError` after every reply is in."""
        for s, (op, kwargs) in commands.items():
            self.slots[s].conn.send((op, kwargs))
        results, errors, dead = {}, {}, []
        waiting = dict(commands)
        deadline = time.monotonic() + timeout
        while waiting:
            handles = {}
            for s in waiting:
                handles[self.slots[s].conn] = s
                handles[self.slots[s].process.sentinel] = s
            left = deadline - time.monotonic()
            ready = connection.wait(list(handles), timeout=max(left, 0))
            if not ready:
                for s in list(waiting):  # hung: it is lost to the run
                    log.error("slot %d did not answer %r in time: killing it", s, waiting[s][0])
                    self.kill(s)
                    dead.append(s)
                    waiting.pop(s)
                break
            for h in ready:
                s = handles[h]
                if s not in waiting:
                    continue
                slot = self.slots[s]
                if h is slot.conn:
                    try:
                        tag, out = slot.conn.recv()
                    except (EOFError, OSError):
                        continue  # the sentinel reports it
                    waiting.pop(s)
                    if tag == "ok":
                        results[s] = out
                    else:
                        errors[s] = out
                elif not slot.process.is_alive():
                    slot.process.join()
                    self._mark_dead(s)
                    dead.append(s)
                    waiting.pop(s)
                    deadline = min(deadline, time.monotonic() + REPLY_GRACE_S)
        if dead:
            from dsml_tpu_torch.runtime.controller import DeviceLost

            err = DeviceLost(sorted(dead), f"worker(s) of slot(s) {sorted(dead)} died during "
                             f"{sorted({op for op, _ in commands.values()})}")
            err.results = results
            err.errors = errors
            raise err
        if errors:
            s, msg = next(iter(sorted(errors.items())))
            raise WorkerError(f"slot {s}: {msg}")
        return results

    # -- worlds ----------------------------------------------------------------

    def form(self, slots, spec, seed: int | None = 0, ckpt_dir: str | None = None,
             max_to_keep: int = 0, recipe: TrainRecipe | None = None) -> "World":
        """A world over ``slots`` (rank r = ``slots[r]``) with the mesh
        ``spec`` (``parallel.mesh.MeshSpec``, resolved over ``len(slots)``).
        ``seed`` fills the weights from it; ``None`` leaves them for a load
        or a restore. ``ckpt_dir`` is where the ranks' checkpoint managers
        save (a directory of the world's by default), keeping ``max_to_keep``
        steps (0 = all)."""
        slots = list(slots)
        for s in slots:
            if not self.slots[s].alive:
                raise RuntimeError(f"slot {s} is dead: restore it before forming a world on it")
            if self.slots[s].world is not None:
                raise RuntimeError(f"slot {s} is still in world {self.slots[s].world.wid}")
        spec = spec.resolved(len(slots))
        self._worlds += 1
        wid = self._worlds
        wdir = os.path.join(self.root, f"world{wid:04d}")
        os.makedirs(wdir)
        world = World(self, wid, slots, spec, wdir, ckpt_dir or os.path.join(wdir, "ckpt"),
                      recipe or self.recipe)
        for s in slots:
            self.slots[s].world = world
        t0 = time.perf_counter()
        try:
            replies = self.collect({s: ("join", dict(
                world_dir=wdir, rank=r, world_size=len(slots), spec=spec.sizes_dict(),
                ckpt_dir=world.ckpt_dir, seed=seed, recipe=world.recipe, slot=s,
                max_to_keep=max_to_keep,
                timeout_s=COLLECTIVE_TIMEOUT_S if self.device == "cpu" else CUDA_COLLECTIVE_TIMEOUT_S))
                for r, s in enumerate(slots)})
        except BaseException:
            world.leave()
            raise
        world.join_s = time.perf_counter() - t0
        world.set_layout([replies[s] for s in slots])
        return world

    def new_state_dir(self) -> str:
        self._states += 1
        return os.path.join(self.root, f"state{self._states:04d}")

    def close(self) -> None:
        """Stop every worker (exit, or kill after a grace) and remove the
        pool's directory if it made it."""
        for slot in self.slots.values():
            if slot.alive:
                try:
                    slot.conn.send(("exit", {}))
                except OSError:  # a worker that died meanwhile
                    pass
        for s, slot in self.slots.items():
            if slot.alive:
                slot.process.join(timeout=10)
                if slot.process.is_alive():
                    slot.process.kill()
                    slot.process.join()
                slot.alive = False
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class World:
    """One mesh over ``slots`` of a :class:`WorkerPool` (rank r = ``slots[r]``);
    made by :meth:`WorkerPool.form`. ``layout`` is ``{path: (global shape,
    dtype, [index of rank r])}`` of the state's array leaves, ``scalars``
    its scalar leaves at the join."""

    def __init__(self, pool: WorkerPool, wid: int, slots: list, spec, directory: str,
                 ckpt_dir: str, recipe: TrainRecipe):
        self.pool, self.wid, self.slots, self.spec = pool, wid, list(slots), spec
        self.recipe = recipe
        self.directory, self.ckpt_dir = directory, ckpt_dir
        self.layout: dict = {}
        self.scalars: dict = {}
        self.active = True
        self.join_s = 0.0

    def set_layout(self, reports: list) -> None:
        first = reports[0]
        self.scalars = dict(first["scalars"])
        self.layout = {path: (shape, dtype, [rep["leaves"][path][2] for rep in reports])
                       for path, (shape, dtype, _) in first["leaves"].items()}

    def holders(self, path: str) -> dict:
        return piece_holders(self.layout, self.slots, path)

    def abort(self) -> None:
        """Write the abort file: rings and checkpoint barriers of this world
        raise instead of waiting."""
        open(os.path.join(self.directory, ABORT_FILE), "w").close()

    def live_slots(self) -> list:
        return [s for s in self.slots if self.pool.is_alive(s)]

    def _all(self, op: str, **kwargs) -> dict:
        return self.pool.collect({s: (op, kwargs) for s in self.live_slots()})

    def step(self, x, y, die_before_sync: int | None = None) -> float:
        """One step on every rank (``die_before_sync``: the slot that kills
        itself inside it). Raises ``DeviceLost`` when a rank died."""
        replies = self.pool.collect({s: ("step", dict(x=x, y=y,
                                                      die_before_sync=s == die_before_sync))
                                     for s in self.slots})
        for rep in replies.values():
            for k, v in rep["launches"].items():
                self.pool.launches[k] = self.pool.launches.get(k, 0) + v
        return replies[self.slots[0]]["loss"]

    def save(self, step: int, meta: dict, iterator_state: dict | None = None) -> None:
        self._all("save", step=step, meta=meta, iterator_state=iterator_state)

    def wait_saves(self) -> None:
        self._all("wait_saves")

    def restore(self, step: int) -> None:
        self._all("restore", step=step)

    def export(self, assignments: dict, state: HostState) -> dict:
        """Survivors write their assigned leaves (``{slot: [paths]}``) into
        ``state``'s files; returns the scalars of the first to answer."""
        replies = self.pool.collect({s: ("export", dict(directory=state.directory, paths=paths))
                                     for s, paths in assignments.items()})
        return next(iter(replies.values())) if replies else {}

    def load(self, state: HostState) -> None:
        self._all("load", directory=state.directory, scalars=state.scalars)

    def leave(self) -> None:
        """Every live rank leaves (two local phases, no collective)."""
        if not self.active:
            return
        self.active = False
        live = self.live_slots()
        try:
            for phase in ("unmap", "free"):
                try:
                    self.pool.collect({s: (phase, {}) for s in live if self.pool.is_alive(s)})
                except Exception as e:  # noqa: BLE001 — a leave never stops a recovery
                    log.warning("world %d: leave phase %s: %s", self.wid, phase, e)
        finally:
            for s in self.slots:
                if self.pool.slots[s].world is self:
                    self.pool.slots[s].world = None

    def state(self) -> HostState:
        """The whole state on the host (every piece from its lowest live
        holder: ``parallel.elastic``'s pull with nothing lost); the caller
        removes it."""
        from dsml_tpu_torch.parallel.elastic import _pull_host_state

        return _pull_host_state(self)
