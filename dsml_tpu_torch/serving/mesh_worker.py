"""A decode worker over several devices: one rank process a device, driven
in lockstep from the router's process — the port's counterpart of the JAX
fleet's multi-device decode workers (``dsml_tpu/serving/router.py::
build_fleet(devices=)``, ``ContinuousBatcher.for_devices``). A port-only
module, as ``parallel/world.py`` is for training.

The JAX package runs a tensor-parallel replica inside the router's
process: one SPMD program over a ``tp`` mesh, its KV cache or page pool
sharded over heads. The port runs one process per rank
(``ContinuousBatcher(mesh=)``), so :class:`MeshDecodeWorker` keeps one
long-lived rank process per device (started with the ``spawn`` context:
CUDA does not survive ``fork``) and offers the decode-worker interface
that ``serving/router.py::Router`` and ``runtime/controller.py::
DecodeFleet`` read:

- **Weights.** The caller holds the whole model. Each rank's tp shard is
  cut on the host through the model's own placement (``local_shards``,
  the JAX ``shard_params``) and written once to a file of its own; a rank
  reads only its shard (``torch.load(mmap=True)``). Workers serving the
  same weights share the files.
- **Ranks.** Each rank joins a ``MeshSpec(tp=len(devices))`` mesh over a
  rendezvous directory of the worker's (``parallel.mesh.build_mesh``),
  builds its shard of the model on its device and a
  ``ContinuousBatcher`` on that mesh: what ``ContinuousBatcher.
  for_devices(model, devices, rank=r, init_file=...)`` builds, from the
  shard instead of the whole model. :meth:`MeshDecodeWorker.rebuild`
  serves other weights or another batcher configuration from the same
  processes and mesh.
- **Lockstep.** Every call goes to every rank; the result is rank 0's.
  Every rank runs the same host scheduler on the same requests, so the
  requests' ids, the emitted tokens and the retired requests must agree:
  a rank that disagrees with rank 0 raises :class:`MeshWorkerError`.
  A handoff's pages or cache rows are cut here, each rank receiving only
  its block of heads (``batcher.head_block``, the JAX ``P(None, "tp")``);
  the sampler's key (``key_rid``) and the original submit time pass
  through unchanged, so every rank draws the same noise.
- **Counters.** Each reply carries rank 0's counters (active, queued,
  pending, injected and preempted requests, pool pages), its retired
  requests and its new decode gaps, and every rank's kernel launches and
  tick counts, so reading an attribute costs no round trip.
- **Failure.** The supervisor waits on every rank's pipe and process
  sentinel together (as ``parallel/world.py`` does): a rank that dies or
  raises where its peers did not surfaces as a :class:`MeshWorkerError`
  naming the rank and carrying its traceback or exit code, and the
  worker's other ranks are killed — never a hang. An error every rank
  raised alike (a ``QueueFull``, a rejected request) is re-raised as it
  is, and the worker stays up. Nothing falls back to one process: a rank
  that fails to start, join or load raises.
- **Shutdown.** :meth:`MeshDecodeWorker.close` ends the ranks;
  :meth:`MeshDecodeWorker.kill` SIGKILLs them. ``Router.
  kill_decode_worker`` and ``DecodeFleet.kill_replica`` kill.

The ranks see the supervisor's ``DSML_*`` settings as they stand at each
build, and an enabled observability registry turns on each rank's own
(its metrics carry the worker's ``obs_replica`` / ``obs_role``;
:meth:`MeshDecodeWorker.obs_snapshots` gathers them for
``obs/cluster.py``).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
import types
import weakref
from multiprocessing import connection

import numpy as np
import torch

from dsml_tpu_torch.parallel.mesh import MeshSpec
from dsml_tpu_torch.serving.batcher import head_block

__all__ = ["MeshDecodeWorker", "MeshView", "MeshWorkerError", "rank_shards"]

START_TIMEOUT_S = 600.0  # a rank that has not started, joined and loaded by then raises
REPLY_TIMEOUT_S = 600.0  # a call no rank answers in this time is a hang: the ranks die
EXIT_GRACE_S = 30.0      # close() waits this long for each rank before killing it


class MeshWorkerError(RuntimeError):
    """A rank of a :class:`MeshDecodeWorker` died, did not answer, raised
    where its peers did not, or disagreed with rank 0. The worker is dead:
    every rank has been killed. ``rank`` names the rank, ``detail`` holds
    its traceback or exit code."""

    def __init__(self, rank: int, detail: str):
        super().__init__(f"mesh decode worker rank {rank}: {detail}")
        self.rank = rank
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class MeshView:
    """The worker's mesh as the router's process sees it: its spec and the
    device of each rank (the mesh itself lives in the ranks)."""

    spec: MeshSpec
    devices: tuple

    @property
    def shape(self) -> dict:
        return self.spec.sizes_dict()


# ---------------------------------------------------------------------------
# weights: every rank's shard, cut on the host once
# ---------------------------------------------------------------------------


def rank_shards(model, tp: int) -> list[dict]:
    """Every rank's tp shard of the WHOLE ``model``'s weights, as CPU
    tensors of their own: ``model.local_shards`` (the JAX ``shard_params``
    placement) of a weightless model of each rank, leaf by leaf."""
    if model.is_partial:
        raise ValueError("rank_shards cuts a whole model; this one is already a shard or a stage")
    ranks = [type(model)(model.config, device="meta",
                         tp_group=types.SimpleNamespace(size=tp, rank=r)) for r in range(tp)]
    shards = [{} for _ in range(tp)]
    for name, leaf in model.state_dict().items():
        full = {name: leaf.detach().cpu()}
        for shard, meta in zip(shards, ranks):
            shard.update({k: v.clone() for k, v in meta.local_shards(full).items()})
    return shards


# {model: {(tp, weights version): [shard file of each rank]}}: workers serving
# the same weights share the files; a file lives until its model is collected
_SHARD_FILES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _weights_version(model) -> tuple:
    """Changes whenever a parameter is written in place (an optimizer step,
    a ``load_state_dict``) or replaced."""
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


def _shard_files(model, tp: int, root: str | None) -> list[str]:
    key = (tp, _weights_version(model))
    cached = _SHARD_FILES.setdefault(model, {})
    paths = cached.get(key)
    if paths and all(os.path.exists(p) for p in paths):
        return paths
    directory = tempfile.mkdtemp(prefix="dsml_shards_", dir=root)
    weakref.finalize(model, shutil.rmtree, directory, True)
    paths = []
    for r, shard in enumerate(rank_shards(model, tp)):
        paths.append(os.path.join(directory, f"rank{r}.pt"))
        torch.save(shard, paths[-1])
        del shard
    cached[key] = paths
    return paths


# ---------------------------------------------------------------------------
# what crosses a pipe
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Array:
    """A tensor crossing a pipe as a numpy array (bf16 as its 16 bits). A
    tensor pickled by ``multiprocessing`` itself would move through shared
    memory, whose size the host may cap."""

    data: np.ndarray
    bf16: bool

    @classmethod
    def of(cls, t: torch.Tensor) -> "_Array":
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return cls(t.view(torch.int16).numpy(), True)
        return cls(t.numpy(), False)

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.data)
        return t.view(torch.bfloat16) if self.bf16 else t


def _pack(tree):
    if isinstance(tree, torch.Tensor):
        return _Array.of(tree)
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_pack(v) for v in tree]
    return tree


def _unpack(tree):
    if isinstance(tree, _Array):
        return tree.tensor()
    if isinstance(tree, dict):
        return {k: _unpack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unpack(v) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


class _Rank:
    """A rank process's state: its mesh (joined at the first build and kept)
    and its batcher."""

    def __init__(self, rank: int, devices: list, init_file: str):
        self.rank = rank
        self.devices = devices
        self.init_file = init_file
        self.mesh = None
        self.batcher = None
        self._gaps_sent = 0

    def build(self, cls, config, shard: str, env: dict, obs_on: bool, kwargs: dict) -> dict:
        from dsml_tpu_torch import obs
        from dsml_tpu_torch.parallel.mesh import build_mesh
        from dsml_tpu_torch.serving.batcher import ContinuousBatcher

        for key in [k for k in os.environ if k.startswith("DSML_") and k not in env]:
            del os.environ[key]
        os.environ.update(env)
        if obs_on:
            obs.enable(forensics=False)
        else:
            obs.disable()
        self.batcher = None
        if self.mesh is None:
            n = len(self.devices)
            self.mesh = build_mesh(MeshSpec(tp=n), self.rank, n, self.init_file,
                                   self.devices[self.rank])
        model = cls(config, device=self.mesh.device, tp_group=self.mesh.group("tp"))
        weights = torch.load(shard, mmap=True, weights_only=True)
        params = dict(model.named_parameters())
        if set(weights) != set(params):
            raise ValueError(f"shard file {shard} holds {sorted(set(weights) ^ set(params))} "
                             "against the model's parameters")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        del weights
        if self.mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        self.batcher = ContinuousBatcher(model, mesh=self.mesh, **kwargs)
        self._gaps_sent = 0
        b = self.batcher
        return {"paged": b.paged, "page_size": b.page_size, "page_quant": b.page_quant,
                "n_slots": b.n_slots, "n_pages": b.n_pages, "max_queue": b.max_queue,
                "prefill_chunk": b.prefill_chunk, "pool_heads": (
                    b._pool[0]["k"].shape[1] if b.paged else b._cache[0]["k"].shape[1])}

    def call(self, name: str, args=(), kwargs=None):
        out = getattr(self.batcher, name)(*_unpack(list(args)), **_unpack(kwargs or {}))
        return _pack(out)

    def set(self, **attrs) -> None:
        for k, v in attrs.items():
            setattr(self.batcher, k, v)

    def ping(self) -> None:
        return None

    def reset_launches(self) -> None:
        import sys

        for mod in ("dsml_tpu_torch.ops.flash", "dsml_tpu_torch.ops.paged_attention",
                    "dsml_tpu_torch.ops.quantization"):
            m = sys.modules.get(mod)
            if m is not None:
                for k, v in list(vars(m).items()):
                    if k.endswith("_launches") and isinstance(v, int):
                        setattr(m, k, 0)

    def obs_snapshot(self, role: str, with_trace: bool) -> dict:
        from dsml_tpu_torch.obs.cluster import snapshot

        return snapshot(role=role, with_trace=with_trace)

    def state(self) -> dict:
        """What every reply carries: the counters, the requests retired
        since the last reply, the new decode gaps, launches and ticks."""
        from dsml_tpu_torch.parallel.world import _launch_counts

        b = self.batcher
        if b is None:
            return {"launches": _launch_counts()}
        if len(b._gaps) < self._gaps_sent:  # reset_latency_stats
            self._gaps_sent = 0
        gaps = b._gaps[self._gaps_sent:]
        self._gaps_sent = len(b._gaps)
        return {"n_active": b.n_active, "n_queued": b.n_queued, "n_pending": b.n_pending,
                "n_injected": b.n_injected, "n_preempted": b.n_preempted,
                "free_pages": b.free_pages, "used_pages": b.used_pages,
                "shared_pages": b.shared_pages, "predicted_tpot_s": b.predicted_tpot_s(),
                "done": b.collect_requests(), "gaps": gaps, "launches": _launch_counts(),
                "ticks": {k: getattr(b, k) for k in (
                    "n_plain_ticks", "n_turbo_ticks", "n_adaptive_ticks", "n_spec_ticks",
                    "n_prefill_dispatches", "n_insert_dispatches")}}

    def close(self) -> None:
        import torch.distributed as dist

        self.batcher = None
        if self.mesh is not None:
            self.mesh.close()
            if dist.is_initialized():
                dist.destroy_process_group()


def _exception_bytes(e: BaseException) -> bytes | None:
    try:
        blob = pickle.dumps(e)
        pickle.loads(blob)
        return blob
    except Exception:  # noqa: BLE001 — an exception that does not round-trip
        return None


def _rank_main(rank: int, conn, devices: list, init_file: str) -> None:
    """A rank's process: serve the supervisor's commands until ``exit``."""
    import faulthandler

    faulthandler.enable()  # a crash leaves its stack on the supervisor's stderr
    # one host thread: a rank's host work is its scheduler (its tensors are
    # on the card, or tiny test models on the CPU, whose matmuls then round
    # as a one-thread batcher's do), and many ranks share the host's cores
    torch.set_num_threads(1)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the context now, before the mesh
    import dsml_tpu_torch.serving.batcher  # noqa: F401 — the modules a build uses, now

    state = _Rank(rank, devices, init_file)
    conn.send(("ready", os.getpid(), None))
    while True:
        try:
            op, kwargs = conn.recv()
        except EOFError:
            return
        if op == "exit":
            try:
                state.close()
            finally:
                conn.send(("ok", None, None))
            return
        try:
            out = getattr(state, op)(**kwargs)
            conn.send(("ok", out, state.state()))
        except Exception as e:  # noqa: BLE001 — reported to the supervisor
            conn.send(("error", (type(e).__name__, _exception_bytes(e),
                                 f"{type(e).__name__}: {e}\n{traceback.format_exc()}"),
                       state.state()))


def _reap(procs: list, directory: str) -> None:
    """Kill every live rank process and remove the worker's directory."""
    for proc in procs:
        if proc.is_alive():
            proc.kill()
        proc.join()
    shutil.rmtree(directory, ignore_errors=True)


# ---------------------------------------------------------------------------
# the supervisor's side
# ---------------------------------------------------------------------------


def _normalise(devices) -> list[str]:
    """Device names, a CUDA one with its index; a card that is absent raises."""
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{dev} was asked for but torch.cuda.is_available() is False")
            index = torch.cuda.current_device() if dev.index is None else dev.index
            if index >= torch.cuda.device_count():
                raise ValueError(f"cuda:{index} is absent: {torch.cuda.device_count()} card(s)")
            dev = torch.device("cuda", index)
        out.append(str(dev))
    return out


class MeshDecodeWorker:
    """A decode worker spanning ``devices`` (one rank process each, at least
    two): a tensor-parallel ``ContinuousBatcher`` over a ``tp =
    len(devices)`` mesh serving ``model``'s weights (see the module
    docstring). ``batcher_kwargs`` go to every rank's batcher. ``workdir``
    holds the worker's rendezvous directory and the shard files (the
    system's temporary directory by default)."""

    def __init__(self, model, devices, workdir: str | None = None, **batcher_kwargs):
        self._start(devices, workdir)
        try:
            _shard_files(model, self.tp, workdir)  # while the ranks start
            self._await_ready()
            self._send_build(model, batcher_kwargs)
            self._finish_build()
        except BaseException:
            self.kill()
            raise

    @classmethod
    def spawn(cls, model, spans, workdir: str | None = None,
              **batcher_kwargs) -> list["MeshDecodeWorker"]:
        """One worker per device list of ``spans``, every rank process of
        every worker started at once (each takes seconds to reach its
        device). A worker that fails to start kills all of them."""
        workers = []
        try:
            for span in spans:
                w = cls.__new__(cls)
                w._start(span, workdir)
                workers.append(w)
            for tp in {w.tp for w in workers}:
                _shard_files(model, tp, workdir)  # while the ranks start
            for w in workers:
                w._await_ready()
            for w in workers:
                w._send_build(model, batcher_kwargs)
            for w in workers:
                w._finish_build()
        except BaseException:
            for w in workers:
                w.kill()
            raise
        return workers

    # -- processes -------------------------------------------------------------

    def _start(self, devices, workdir) -> None:
        self.devices = _normalise(devices)
        if len(self.devices) < 2:
            raise ValueError(f"a mesh decode worker spans at least two devices, got "
                             f"{self.devices}; one device is a ContinuousBatcher")
        self.tp = len(self.devices)
        self.mesh = MeshView(MeshSpec(tp=self.tp).resolved(self.tp), tuple(self.devices))
        self._root = workdir
        if workdir is not None:
            os.makedirs(workdir, exist_ok=True)
        self.directory = tempfile.mkdtemp(prefix="dsml_meshworker_", dir=workdir)
        self.alive = True
        self._obs_replica, self._obs_role = "0", "decode"
        self._state = {"n_active": 0, "n_queued": 0, "n_pending": 0, "n_injected": 0,
                       "n_preempted": 0, "free_pages": 0, "used_pages": 0, "shared_pages": 0,
                       "predicted_tpot_s": None}
        self._rank_states: list[dict] = [{} for _ in self.devices]
        self._done: dict = {}
        self._gaps: list = []
        self.pids: list[int] = []
        ctx = mp.get_context("spawn")
        init_file = os.path.join(self.directory, "rendezvous")
        self._procs, self._conns = [], []
        self._reaper = weakref.finalize(self, _reap, self._procs, self.directory)
        for r in range(self.tp):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, name=f"dsml-decode-rank{r}",
                               args=(r, child, self.devices, init_file), daemon=True)
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)

    def _await_ready(self) -> None:
        for r, msg in enumerate(self._wait("start", START_TIMEOUT_S)):
            tag, pid, _ = msg
            if tag != "ready":
                self._fail(r, f"sent {tag!r} instead of ready")
            self.pids.append(pid)

    def _send_build(self, model, batcher_kwargs) -> None:
        paths = _shard_files(model, self.tp, self._root)
        env = {k: v for k, v in os.environ.items() if k.startswith("DSML_")}
        from dsml_tpu_torch.obs import get_registry

        obs_on = get_registry().enabled
        self._send("build", [dict(cls=type(model), config=model.config, shard=paths[r], env=env,
                                  obs_on=obs_on, kwargs=dict(batcher_kwargs))
                             for r in range(self.tp)])

    def _finish_build(self) -> None:
        info = self._replies("build", self._wait("build", START_TIMEOUT_S))
        self._done.clear()
        self._gaps.clear()
        for key, value in info.items():
            setattr(self, key, value)
        self._set(obs_replica=self._obs_replica, obs_role=self._obs_role)

    def rebuild(self, model, **batcher_kwargs) -> "MeshDecodeWorker":
        """Serve ``model``'s weights with a new batcher of
        ``batcher_kwargs`` from the same rank processes and mesh (nothing
        of the old batcher survives: unfinished requests are dropped)."""
        self._check_alive()
        self._send_build(model, batcher_kwargs)
        self._finish_build()
        return self

    # -- calls -----------------------------------------------------------------

    def _check_alive(self) -> None:
        if not self.alive:
            raise MeshWorkerError(0, "the worker is dead (killed or failed)")

    def _send(self, op: str, kwargs_by_rank: list) -> None:
        self._check_alive()
        for r, (conn, kwargs) in enumerate(zip(self._conns, kwargs_by_rank)):
            try:
                conn.send((op, kwargs))
            except OSError:  # a dead rank: its sentinel reports it in _wait
                pass

    def _wait(self, op: str, timeout: float) -> list:
        """Every rank's reply; a rank that dies or does not answer kills the
        worker and raises."""
        replies = [None] * self.tp
        waiting = set(range(self.tp))
        deadline = time.monotonic() + timeout
        while waiting:
            handles = {}
            for r in waiting:
                handles[self._conns[r]] = r
                handles[self._procs[r].sentinel] = r
            ready = connection.wait(list(handles), timeout=max(deadline - time.monotonic(), 0))
            if not ready:
                self._fail(min(waiting), f"no answer to {op!r} within {timeout:.0f} s")
            for h in ready:
                r = handles[h]
                if r not in waiting:
                    continue
                if h is self._conns[r]:
                    try:
                        replies[r] = self._conns[r].recv()
                    except (EOFError, OSError):
                        continue  # the sentinel reports the death
                    waiting.discard(r)
                elif not self._procs[r].is_alive():
                    self._procs[r].join()
                    self._fail(r, f"died during {op!r} (exit code {self._procs[r].exitcode})")
        return replies

    def _fail(self, rank: int, detail: str):
        self.kill()
        raise MeshWorkerError(rank, detail)

    def _replies(self, op: str, replies: list):
        """Rank 0's result of a lockstep call, the ranks' states taken in.
        An error every rank raised alike is re-raised; any other error kills
        the worker."""
        for r, (_, _, state) in enumerate(replies):
            if state:
                self._rank_states[r] = state
        tags = [tag for tag, _, _ in replies]
        if "error" in tags:
            errors = [out for tag, out, _ in replies if tag == "error"]
            if len(errors) == self.tp and len({name for name, _, _ in errors}) == 1 \
                    and errors[0][1] is not None:
                self._take_state(replies[0][2])
                raise pickle.loads(errors[0][1])
            r = tags.index("error")
            self._fail(r, f"{op!r} raised on this rank only:\n{replies[r][1][2]}")
        self._take_state(replies[0][2])
        return replies[0][1]

    def _take_state(self, state) -> None:
        if not state or "done" not in state:
            return
        self._state.update({k: state[k] for k in self._state})
        self._done.update(state["done"])
        self._gaps.extend(state["gaps"])

    def _all(self, op: str, timeout: float = REPLY_TIMEOUT_S, **kwargs):
        self._send(op, [kwargs] * self.tp)
        replies = self._wait(op, timeout)
        return replies, self._replies(op, replies)

    def _call(self, name: str, *args, **kwargs):
        """``batcher.name(*args, **kwargs)`` on every rank; each returned
        value must equal rank 0's."""
        replies, out = self._all("call", name=name, args=args, kwargs=kwargs)
        self._agree(name, [o for _, o, _ in replies])
        return _unpack(out)

    def _agree(self, what: str, outs: list) -> None:
        for r, o in enumerate(outs[1:], 1):
            if not _same(o, outs[0]):
                self._fail(r, f"{what} returned {o!r} on this rank, {outs[0]!r} on rank 0: the "
                              "ranks left lockstep")

    def _set(self, **attrs) -> None:
        if self.alive:
            self._all("set", **attrs)

    # -- the decode-worker interface -------------------------------------------

    @property
    def obs_replica(self) -> str:
        return self._obs_replica

    @obs_replica.setter
    def obs_replica(self, value) -> None:
        self._obs_replica = value
        self._set(obs_replica=value)

    @property
    def obs_role(self) -> str:
        return self._obs_role

    @obs_role.setter
    def obs_role(self, value) -> None:
        self._obs_role = value
        self._set(obs_role=value)

    n_plain_ticks = property(lambda self: self._rank_states[0].get("ticks", {}).get(
        "n_plain_ticks", 0))
    n_prefill_dispatches = property(lambda self: self._rank_states[0].get("ticks", {}).get(
        "n_prefill_dispatches", 0))
    n_active = property(lambda self: self._state["n_active"])
    n_queued = property(lambda self: self._state["n_queued"])
    n_pending = property(lambda self: self._state["n_pending"])
    n_injected = property(lambda self: self._state["n_injected"])
    n_preempted = property(lambda self: self._state["n_preempted"])
    free_pages = property(lambda self: self._state["free_pages"])
    used_pages = property(lambda self: self._state["used_pages"])
    shared_pages = property(lambda self: self._state["shared_pages"])

    def predicted_tpot_s(self) -> float | None:
        return self._state["predicted_tpot_s"]

    def submit(self, prompt, max_new_tokens: int, key_rid: int | None = None,
               trace_id: str | None = None, priority: int = 0) -> int:
        return self._call("submit", np.asarray(prompt, np.int64).reshape(-1), max_new_tokens,
                          key_rid=key_rid, trace_id=trace_id, priority=priority)

    def inject(self, prompt, max_new_tokens: int, cache1=None, logits_row=None,
               key_rid: int | None = None, submitted_at: float | None = None, *,
               kv_pages=None, page_size: int | None = None, prefix_rows: int = 0,
               trace_id: str | None = None) -> int:
        """``ContinuousBatcher.inject`` on every rank, each receiving only
        its block of the handoff's heads."""
        payload = kv_pages if kv_pages is not None else cache1
        cuts = [None] * self.tp if payload is None else [
            _pack(head_block(payload, self.tp, r)) for r in range(self.tp)]
        common = dict(key_rid=key_rid, page_size=page_size, prefix_rows=prefix_rows,
                      trace_id=trace_id,
                      submitted_at=time.monotonic() if submitted_at is None else submitted_at)
        logits = None if logits_row is None else _pack(torch.as_tensor(logits_row))
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self._send("call", [dict(name="inject", args=(prompt, max_new_tokens), kwargs={
            **common, "logits_row": logits,
            ("kv_pages" if kv_pages is not None else "cache1"): cuts[r]}) for r in range(self.tp)])
        replies = self._wait("inject", REPLY_TIMEOUT_S)
        out = self._replies("inject", replies)
        self._agree("inject", [o for _, o, _ in replies])
        return out

    def register_prefix(self, tokens) -> None:
        self._call("register_prefix", np.asarray(tokens, np.int64).reshape(-1))

    def step(self) -> dict[int, list]:
        """One scheduler tick on every rank; rank 0's emitted tokens, which
        every other rank's must equal, as must the requests each retired."""
        replies, out = self._all("call", name="step")
        self._agree("step", [o for _, o, _ in replies])
        done = [{rid: req.tokens for rid, req in (s or {}).get("done", {}).items()}
                for _, _, s in replies]
        self._agree("the retired requests of step", done)
        return out

    def run(self, max_steps: int = 100_000) -> dict[int, list]:
        """Drain the queue and the slots (``ContinuousBatcher.run``)."""
        for _ in range(max_steps):
            if not (self.n_queued or self.n_injected or self.n_active or self.n_pending
                    or self.n_preempted):
                break
            self.step()
        else:
            raise RuntimeError(f"serving did not drain within {max_steps} steps")
        return self.collect()

    def collect_requests(self) -> dict:
        """Rank 0's requests retired since the last collect (whole
        ``Request``s), from the replies already in: no round trip."""
        done = dict(self._done)
        self._done.clear()
        return done

    def collect(self) -> dict[int, list]:
        return {rid: req.tokens for rid, req in self.collect_requests().items()}

    def abandon(self) -> list:
        """``ContinuousBatcher.abandon`` on every rank: rank 0's unfinished
        requests, oldest first."""
        return self._call("abandon")

    def reset_latency_stats(self) -> None:
        self._gaps.clear()
        self._call("reset_latency_stats")

    # -- ranks -----------------------------------------------------------------

    def rank_launches(self) -> list[dict]:
        """Each rank's kernel launch counters (``*_launches`` of the kernel
        wrappers), as of the last reply."""
        return [dict(s.get("launches", {})) for s in self._rank_states]

    def rank_ticks(self) -> list[dict]:
        """Each rank's batcher tick and dispatch counters, as of the last
        reply."""
        return [dict(s.get("ticks", {})) for s in self._rank_states]

    def reset_launches(self) -> None:
        """Set every rank's kernel launch counters to 0."""
        self._all("reset_launches")

    def ping(self) -> float:
        """Seconds of one lockstep round trip that does nothing on the
        ranks: what each call pays for the pipes and the processes."""
        t0 = time.perf_counter()
        self._all("ping")
        return time.perf_counter() - t0

    def obs_snapshots(self, with_trace: bool = False) -> list[dict]:
        """Each rank's ``obs.cluster.snapshot`` (role ``decode<replica>/
        rank<r>``), for ``obs.cluster.ClusterAggregator``."""
        self._send("obs_snapshot", [dict(role=f"{self._obs_role}{self._obs_replica}/rank{r}",
                                         with_trace=with_trace) for r in range(self.tp)])
        replies = self._wait("obs_snapshot", REPLY_TIMEOUT_S)
        self._replies("obs_snapshot", replies)
        return [out for _, out, _ in replies]

    # -- shutdown --------------------------------------------------------------

    def alive_pids(self) -> list[int]:
        return [p.pid for p in self._procs if p.is_alive()]

    def kill(self) -> None:
        """SIGKILL every rank process: the worker and its state are gone."""
        self.alive = False
        self._reaper()

    def close(self) -> None:
        """End every rank (each closes its mesh), killing a rank that has
        not exited within :data:`EXIT_GRACE_S`."""
        if self.alive:
            self.alive = False
            for conn in self._conns:
                try:
                    conn.send(("exit", {}))
                except OSError:
                    pass
            deadline = time.monotonic() + EXIT_GRACE_S
            for proc in self._procs:
                proc.join(max(deadline - time.monotonic(), 0))
        self._reaper()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _same(a, b) -> bool:
    """Lockstep equality of two ranks' returned values (Requests by their
    ids and tokens, arrays by value)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, _Array) and isinstance(b, _Array):
        return True  # a value of each rank's own shard (a get of a device tensor)
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return (getattr(a, "rid", None), getattr(a, "tokens", None)) == \
            (getattr(b, "rid", None), getattr(b, "tokens", None))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b
