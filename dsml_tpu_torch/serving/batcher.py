"""Continuous-batching serving on one device or on a tensor-parallel mesh
— the counterpart of ``dsml_tpu/serving/batcher.py``'s ``ContinuousBatcher``.

Requests arrive at different times with different prompt and output
lengths; a static batch would idle every slot until the longest request
finishes. The batcher retires each request the moment it completes and
admits a queued one into the freed slot:

- one decode step for all slots (``GPT2.decode_step_slots``, or its paged
  twin), per-slot depths carried as a ``pos`` vector, cache writes as a
  batched scatter in place, attention masked to ``s <= pos[b]`` per row;
- admission by whole-prompt prefill padded to a prompt bucket, or (with
  ``prefill_chunk``) by chunks with decode ticks between a long prompt's
  chunks;
- a host scheduler loop: admit → one decode QUANTUM of k steps (a Python
  loop, sampling on the card, one host fetch per tick) → emit / retire;
- three other ticks over the dense cache: ``turbo_factor`` escalates to a
  quantum ``turbo_factor`` times longer while nothing waits to admit,
  ``adaptive_quantum`` decodes until the step at which any active slot
  finishes (budget or EOS), and ``speculative_window`` (dense or paged)
  verifies a window of prompt-lookup drafts per slot in one
  ``verify_step`` call and commits 1..window tokens a slot.

``paged_kv`` replaces the dense per-slot cache with a page POOL (int4 rows
with per-row scales by default, "int8", or "fp" for unquantized pages), a
per-slot page table and the host allocator of ``serving/paging.py``:
registered prefixes become copy-on-write table entries, and
``preemption=True`` grows allocations page by page and evicts (swap to the
host or recompute) under pressure. On the card the paged attention runs the
hand-written CUDA kernels (``ops/paged_attention.py``).

``weight_quant`` ("int8"/"int4", or ``DSML_WEIGHT_QUANT`` by default)
serves from a twin of the model whose block projections are block-quantized
codes (``models.common.quantize_weights_blocked``); on the card every
projection then runs the hand-written dequant-fused matmul kernel
(``ops/quantization.py::quantized_matmul``).

The sampler. ``jax.random`` has no torch twin, so the JAX package's sampled
bits cannot be reproduced; its guarantee is kept instead: a request's
sampled tokens depend only on (seed, key_rid or rid, step), never on the
slot, ``n_slots``, ``decode_quantum``, or paged versus dense. The Gumbel
noise of row b at step s is a counter-based hash of (request key, s, token
id) (:func:`request_uniform`), computed on the device in int64 arithmetic,
so the CPU and the card draw the same noise.

Observability (``dsml_tpu_torch.obs``, off unless enabled; one branch a
call site when off), as the JAX batcher writes it: a ``decode_tick`` span
a tick (no fence: the tick already ends in its host fetch), admission
latency with the request's ``trace_id`` as exemplar, slot occupancy, queue
depth, tokens, shed requests, CoW copies, preemptions and page waits,
flight-recorder events per admission, retirement, preemption and resume,
the speculative acceptance gauge, and, refreshed at scrape time, the page
pool's gauges and ``serving_memory_pressure``. The memory ledger reads the
pool's bytes (``kv_pages``) and the quantized weights' (``weights_quant``)
as live sources. Metrics carry ``replica`` and ``role`` labels
(``obs_replica = "0"``, ``obs_role = "decode"``).

``mesh`` (a ``parallel.mesh.Mesh``, one process per rank) makes the
replica tensor-parallel, as the JAX batcher's ``mesh`` does: the model is
this rank's Megatron shard over the mesh's ``tp`` group (a whole model is
cut into it), the slot cache or the page pool holds the rank's heads, and
every rank runs the same host scheduler on the same requests, so only the
device work is split. Each tick's collectives (an all-reduce after every
row-parallel projection, the all-gather of the logits' vocab shards) run
inside the model's serving surfaces; every rank samples the same tokens
from bit-identical logits. The ranks stay in lockstep because every host
decision (admission, preemption victims, the adaptive stop, the
speculative window) is a function of tokens and counters only: the
wall-clock EWMA ``spec_tick_s_ewma`` is reported and steers nothing. Mesh
axes other than ``tp`` replicate. :meth:`ContinuousBatcher.for_devices`
builds such a replica over a list of devices.

:meth:`ContinuousBatcher.from_checkpoint` serves a training checkpoint of
either package (a weights-only partial restore), on a mesh into this
rank's shard.

The batcher is also the fleet's DECODE worker (``serving/router.py``):
:meth:`ContinuousBatcher.inject` admits a request whose prefill ran on a
``PrefillWorker``, from its handoff's cache rows or pages and first
logits, before any queued prompt.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from dsml_tpu_torch.models.common import quantize_weights_blocked
from dsml_tpu_torch.models.gpt2 import sample_token_logits
from dsml_tpu_torch.models.speculative import lookup_draft_host
from dsml_tpu_torch.obs import TraceContext, flight_recorder, get_registry, get_tracer
from dsml_tpu_torch.obs.memory import get_memory_ledger, tree_nbytes
from dsml_tpu_torch.ops.quantization import QuantizedWeight, weight_quant_mode
from dsml_tpu_torch.serving.paging import (
    PagePool,
    copy_page,
    export_pool_gauges,
    gather_pages,
    note_page_wait,
    pages_for,
    plan_admission,
    prefill_prefix_into_pages,
)
from dsml_tpu_torch.utils.hash32 import request_key, request_uniform

__all__ = ["ContinuousBatcher", "QueueFull", "Request", "head_block", "request_key",
           "request_uniform"]


class QueueFull(RuntimeError):
    """``submit`` rejected by the queue cap (``max_queue``): the batcher
    sheds load explicitly instead of letting the queue, and every queued
    request's latency, grow without bound."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [L] int
    max_new_tokens: int
    tokens: list = dataclasses.field(default_factory=list)  # emitted so far
    done: bool = False
    # wall-clock marks of the latency metrics (time.monotonic)
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None
    last_emit_at: float | None = None
    # the sampler's identity: noise derives from (seed, key_rid, step)
    # instead of the local rid when set
    key_rid: int | None = None
    # request-scoped trace identity (obs.TraceContext.trace_id): the
    # spans, flow events and the admission histogram's exemplar tag with it
    trace_id: str | None = None
    # preemption priority (paged ``preemption=True``): the lowest-priority
    # slot is evicted first, the youngest within a priority
    priority: int = 0

    def trace_ctx(self) -> TraceContext | None:
        """The request's TraceContext (its flow id derives from the
        trace_id alone); None when the request carries no trace."""
        return None if self.trace_id is None else TraceContext(trace_id=self.trace_id)


def head_block(tree, tp: int, index: int) -> list:
    """Block ``index`` of ``tp`` equal contiguous blocks of the head axis
    (axis 1) of every leaf of a KV payload (per-layer dicts: a 1-row cache
    or a page payload, scales included): what the JAX placement
    ``NamedSharding(mesh, P(None, "tp"))`` hands tp coordinate ``index``.
    A mesh batcher's share of a whole-head handoff."""
    out = []
    for layer in tree:
        cut = {}
        for key, arr in layer.items():
            heads = arr.shape[1]
            if heads % tp:
                raise ValueError(f"handoff entry {key!r} has {heads} heads, not divisible by "
                                 f"tp={tp}")
            step = heads // tp
            cut[key] = arr[:, index * step:(index + 1) * step]
        out.append(cut)
    return out


def _bucket(n: int, buckets: tuple) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket {buckets[-1]}")


# an adaptive tick with an EOS id reads its tokens back every this many
# steps to find the stop; steps decoded past the stop are dropped
ADAPTIVE_EOS_CHECK = 8


class ContinuousBatcher:
    """Slot-based continuous-batching decoder over one ``GPT2`` or ``Llama``
    (which holds its weights, on the device the batcher serves from).

    ``submit`` enqueues prompts; ``step`` admits queued requests into free
    slots, runs one decode quantum, emits new tokens and retires finished
    requests (EOS or token budget); ``run`` drains everything. Greedy by
    default; ``temperature > 0`` samples with noise per (request, step)
    (:func:`request_uniform`), so tokens do not depend on slot timing.

    ``decode_quantum`` — decode steps per scheduler tick; each tick costs
    one host fetch of the sampled tokens. Tokens are identical for any
    quantum; a request finishing mid-quantum wastes the rest of its lane.

    ``turbo_factor`` — 0 (off) or >= 2: a dense tick with nothing queued
    and no admission mid-flight runs ``decode_quantum * turbo_factor``
    steps when some active slot has that much budget left
    (``n_turbo_ticks``). Tokens are identical with turbo on or off.

    ``adaptive_quantum`` — 0 (off) or in [2, max_seq]: while no chunked
    admission is mid-flight, a dense tick decodes until the step at which
    any active slot reaches its budget or emits ``eos_id``, or
    ``adaptive_quantum`` steps (``n_adaptive_ticks``). The budget stop is
    known on the host; an EOS stop is found by reading the tokens back
    every :data:`ADAPTIVE_EOS_CHECK` steps (``n_adaptive_syncs`` counts the
    read-backs, ``n_adaptive_steps_dropped`` the steps decoded past an EOS
    stop). Exclusive with turbo and the speculative tick.

    ``speculative_window`` — when >= 2, each tick drafts ``window - 1``
    tokens per active slot by prompt lookup over its own history
    (``models.speculative.lookup_draft_host``, n-gram ``speculative_ngram``),
    scores every slot's window at its own depth in ONE ``verify_step`` (or
    ``verify_step_paged``) call and commits the longest draft prefix on the
    model's greedy chain plus the model's next token. Greedy only, with
    ``decode_quantum=1``; tokens equal the plain batcher's. Inactive slots
    carry a dummy window at position 0 that writes their own dead rows
    (dense) or the scratch page (paged). ``speculative_adaptive`` sizes the
    window per tick from the acceptance EWMA (:meth:`_spec_window_for_tick`);
    ``accept_ewma``, ``commit_ewma``, ``spec_tick_s_ewma`` and
    :meth:`predicted_tpot_s` report what the ticks measured.

    ``prefill_chunk`` — when > 0, admission prefills prompts in chunks of
    that many tokens (``GPT2.prefill_chunk``), at most one chunk per tick
    once a long admission is in flight, so decode ticks run between a long
    prompt's chunks. 0 keeps whole-prompt admission padded to a bucket.

    ``register_prefix(tokens)`` — the prefix's cache rows and next-token
    logits are computed once; a later prompt starting with it admits by
    copying (dense) or sharing (paged) those rows and prefilling only the
    suffix.

    ``paged_kv`` — False (dense cache), "fp", "int8" or "int4"/True: a pool
    of ``n_pages`` pages of ``page_size`` rows (0 = every slot can hold
    max_seq rows, plus the scratch page), a page table per slot and a
    refcounting allocator. Admission reserves every page a request can
    ever write (or, with ``preemption``, the prompt grid and then page by
    page, evicting the lowest-priority slot under pressure by
    ``preempt_policy`` "swap", "recompute" or "auto"). Requires
    ``prefill_chunk > 0``. Greedy tokens equal a dense batcher's at the
    same KV codec (``kv_quant``).

    ``weight_quant`` — "env" (default: ``DSML_WEIGHT_QUANT``, off unless
    set), "int8", "int4", or None/"off": the batcher serves from
    ``quantize_weights_blocked(model, weight_quant)`` (``self.model``),
    whose projections run the dequant-fused kernel. The caller's dense
    model stays resident; ``_wq_bytes`` holds the twin's packed and scale
    bytes. Single-device replicas only: with ``mesh`` it raises, as in the
    JAX package.

    ``mesh`` — a ``parallel.mesh.Mesh`` this process is a rank of: serving
    becomes tensor-parallel over its ``tp`` group (see the module
    docstring). ``model`` is the WHOLE model (cut into this rank's shard
    on ``mesh.device``) or already the shard of that group; the cache's
    (or pool's) head count must divide by tp. ``self.model`` is the shard.
    """

    def __init__(
        self,
        model,
        n_slots: int = 8,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        prompt_buckets: tuple = (32, 64, 128, 256, 512, 1024),
        decode_quantum: int = 1,
        turbo_factor: int = 0,
        prefill_chunk: int = 0,
        speculative_window: int = 0,
        speculative_ngram: int = 2,
        speculative_adaptive: bool = False,
        adaptive_quantum: int = 0,
        max_queue: int = 0,
        mesh=None,
        paged_kv=False,
        page_size: int = 16,
        n_pages: int = 0,
        preemption: bool = False,
        preempt_policy: str = "auto",
        weight_quant: str | None = "env",
    ):
        cfg = model.config
        self._obs = get_registry()  # no-op unless observability is enabled
        # serving metrics are labeled per replica and worker kind, as the
        # JAX batcher's: a standalone batcher is replica "0", role "decode"
        self.obs_replica = "0"
        self.obs_role = "decode"
        # dequant-fused serving weights: resolve the knob and quantize the
        # projections before any cache or pool is built from the model
        if weight_quant == "env":
            weight_quant = weight_quant_mode()
        if weight_quant in ("off", "none", "0", False):
            weight_quant = None
        self._wq_bytes = {}
        if weight_quant is not None:
            if weight_quant not in ("int8", "int4"):
                raise ValueError(
                    f"weight_quant must be 'int8', 'int4', or None, got {weight_quant!r}")
            if mesh is not None:
                raise ValueError(
                    "weight_quant serves single-device replicas; a mesh's tp shard runs its "
                    "projections unquantized")
            model = quantize_weights_blocked(model, weight_quant)
            leaves = [m for m in model.modules() if isinstance(m, QuantizedWeight)]
            self._wq_bytes = {"packed": sum(q.qw.nbytes for q in leaves),
                              "scales": sum(q.qs.nbytes for q in leaves)}
            get_memory_ledger(self._obs).register_source(
                "weights_quant", self._ledger_weight_quant_bytes, name=self._ledger_name())
        self.weight_quant = weight_quant
        self.mesh = mesh
        if mesh is not None:
            model = self._mesh_model(model, mesh, bool(paged_kv))
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        # sorted and deduplicated: _bucket takes the FIRST bucket >= len(prompt)
        self.prompt_buckets = tuple(sorted({b for b in prompt_buckets if b <= cfg.max_seq}))
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket fits max_seq={cfg.max_seq}")
        if prefill_chunk < 0 or prefill_chunk > cfg.max_seq:
            raise ValueError(
                f"prefill_chunk must be in [0, max_seq={cfg.max_seq}], got {prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk)
        # the in-flight chunked admission, at most one: dense (request, slot,
        # accumulating 1-row cache, next start); paged (request, slot, next
        # start, the rows being prefilled, resume state or None). Its slot
        # holds rid -2: neither decoding (>= 0) nor free (== -1).
        self._pending = None

        # "fp" = unquantized pages: mode None, paged True
        self.page_quant = None if paged_kv == "fp" else model._page_mode(paged_kv)
        self.paged = bool(paged_kv)
        self.page_size = int(page_size)
        if preemption and not self.paged:
            raise ValueError("preemption is a paged_kv eviction tier; set paged_kv=")
        if preempt_policy not in ("swap", "recompute", "auto"):
            raise ValueError(
                f"preempt_policy must be 'swap', 'recompute', or 'auto', got {preempt_policy!r}")
        self.preemption = bool(preemption)
        self.preempt_policy = preempt_policy
        if self.paged:
            if cfg.max_seq % self.page_size:
                raise ValueError(
                    f"page_size must divide max_seq={cfg.max_seq}, got {self.page_size}")
            self._n_pt = cfg.max_seq // self.page_size  # table entries per slot
            # 0 = every slot can hold max_seq rows, as in the dense cache
            self.n_pages = int(n_pages) or n_slots * self._n_pt + 1
            self._pages = PagePool(self.n_pages)
            # host page table, a row per slot, scratch page 0 where unallocated
            self._page_table = np.zeros((n_slots, self._n_pt), np.int32)
            self._slot_pages: list[list] = [[] for _ in range(n_slots)]
            # the first _slot_shared[s] pages of a slot are shared prefix pages
            # (never swapped; eviction only drops the reference)
            self._slot_shared = np.zeros(n_slots, np.int32)
            self._slot_prio = np.zeros(n_slots, np.int64)
            self._preempted: deque = deque()  # evicted requests awaiting resume, FIFO
            self.n_preemptions = 0
            self.n_swap_evictions = 0
            self.n_recompute_evictions = 0
            self.n_cow_copies = 0
            # pages the prefix registry holds for good: the never-fits checks
            # take them off the reservable ceiling
            self._registry_pages = 0
            self._pool = model.init_page_pool(self.n_pages, self.page_size, quant=self.page_quant)
            # the request whose page wait is being counted (its first
            # blocked tick marks the request's flow, later ones only count)
            self._page_wait_rid = None
            self._page_wait_rid_inject = None  # the same for a handoff's admission
            # pool gauges refresh at SCRAPE time (an idle batcher's gauges
            # never freeze at the last tick's); the ledger reads the pool's
            # bytes at every scrape and postmortem — both weakly held
            self._page_nbytes: float | None = None
            self._obs.add_collect_hook(self._export_pool_gauges)
            get_memory_ledger(self._obs).register_source(
                "kv_pages", self._ledger_page_bytes, name=self._ledger_name())
        else:
            self.n_pages = 0
            self._cache = model.init_cache(n_slots)

        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (0 = unbounded), got {max_queue}")
        self.max_queue = int(max_queue)
        self._queue: deque[Request] = deque()
        # handed-off admissions (inject): (request, cache1 or (pages, prefix
        # rows), first logits); they admit before the queue
        self._inject: deque = deque()
        self._live: dict[int, Request] = {}  # queued, injected or in a slot
        self._done: dict[int, Request] = {}  # retired, awaiting collect()
        self._latency: list = []  # (ttft_s, e2e_s) per retired request
        self._gaps: list = []  # inter-emission gaps
        self._prefixes: list = []  # (tokens, cache1 or pages, last logits), longest first
        self._next_rid = 0
        # slot state on the host; the device state is the cache or pool
        self._slot_rid = np.full(n_slots, -1, np.int64)  # -1 = free
        self._pos = np.zeros(n_slots, np.int64)  # next cache write index
        self._last_tok = np.zeros(n_slots, np.int64)
        self._slot_key = np.zeros(n_slots, np.int64)  # request_key of the slot's request

        if decode_quantum < 1:
            raise ValueError(f"decode_quantum must be >= 1, got {decode_quantum}")
        self.decode_quantum = decode_quantum
        if turbo_factor < 0 or turbo_factor == 1:
            raise ValueError(f"turbo_factor must be 0 (off) or >= 2, got {turbo_factor}")
        if turbo_factor and speculative_window:
            raise ValueError(
                "turbo_factor composes with plain quanta only; the speculative "
                "window sets its own per-tick budget")
        if turbo_factor and decode_quantum * turbo_factor >= cfg.max_seq:
            # submit's L + max_new <= max_seq with a nonempty prompt caps the
            # remaining budget at max_seq - 1: such a quantum never engages
            raise ValueError(
                f"turbo quantum {decode_quantum * turbo_factor} >= max_seq={cfg.max_seq} — "
                "no request could ever have that much budget remaining")
        self.turbo_factor = int(turbo_factor)
        if adaptive_quantum:
            if adaptive_quantum < 2 or adaptive_quantum > cfg.max_seq:
                raise ValueError(
                    f"adaptive_quantum must be in [2, max_seq={cfg.max_seq}] or 0 (off), "
                    f"got {adaptive_quantum}")
            if turbo_factor or speculative_window:
                raise ValueError(
                    "adaptive_quantum sets its own early-exit per-tick budget; "
                    "exclusive with turbo_factor and speculative_window")
        self.adaptive_quantum = int(adaptive_quantum)
        if speculative_window:
            if speculative_window < 2 or speculative_ngram < 1:
                raise ValueError(
                    f"speculative_window must be >= 2 (1 committed + >=1 draft) and "
                    f"speculative_ngram >= 1; got {speculative_window}, {speculative_ngram}")
            if self.temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (verify-by-argmax); temperature must be 0")
            if decode_quantum != 1:
                raise ValueError(
                    "speculative_window replaces decode_quantum (the window IS the per-tick "
                    "token budget); set decode_quantum=1")
        self.speculative_window = int(speculative_window)
        self.speculative_ngram = int(speculative_ngram)
        if speculative_adaptive and not speculative_window:
            raise ValueError(
                "speculative_adaptive adapts the speculative window; set speculative_window >= 2")
        self.speculative_adaptive = bool(speculative_adaptive)
        # acceptance telemetry of the speculative tick: per-slot and
        # batcher-level EWMAs of the draft acceptance rate, the verify
        # tick's wall time and the tokens committed a slot a tick — the
        # inputs of the adaptive window, of predicted_tpot_s and of the
        # serving_spec_accept_rate gauge
        self._slot_accept = np.full(n_slots, np.nan)
        self.accept_ewma: float | None = None
        self.spec_tick_s_ewma: float | None = None
        self.commit_ewma: float | None = None
        self.n_spec_ticks = 0
        self.spec_window_used: dict[int, int] = {}  # width -> ticks
        # dispatch counters: decode ticks by kind and prefill passes (whole
        # prompts or chunks); insert copies of prefix rows and swapped-in
        # pages; the adaptive ticks' token read-backs and the steps they
        # decoded past an EOS stop
        self.n_plain_ticks = 0
        self.n_turbo_ticks = 0
        self.n_adaptive_ticks = 0
        self.n_adaptive_syncs = 0
        self.n_adaptive_steps_dropped = 0
        self.n_prefill_dispatches = 0
        self.n_insert_dispatches = 0

    @staticmethod
    def _mesh_model(model, mesh, paged: bool):
        """This rank's model on ``mesh``: the whole ``model`` cut into its
        shard over the mesh's tp group (on ``mesh.device``), or ``model``
        itself when it already is that shard or tp is 1. The cache's or
        pool's head count must divide by tp (the JAX batcher's check)."""
        tp = mesh.shape.get("tp", 1)
        heads = model._n_cache_heads
        if heads % tp:
            raise ValueError(
                f"{'pool' if paged else 'cache'} head count {heads} not divisible by tp={tp}")
        group = mesh.group("tp")
        if tp > 1 and not model.is_partial:
            return model.shard(group, mesh.device)
        if model.tp != tp or model.tp_group is not group:
            raise ValueError(f"the model is a tp = {model.tp} shard, not one of this mesh's "
                             f"tp = {tp} group")
        return model

    @classmethod
    def for_devices(cls, model, devices, rank: int = 0, init_file: str | None = None, **kwargs):
        """A batcher whose replica spans ``devices``, the JAX ``for_devices``.
        One device is the plain batcher (the model's weights must live
        there). More is a tensor-parallel replica over a ``MeshSpec(tp=
        len(devices))`` mesh: one process per device, each calling this
        with its ``rank`` (its device is ``devices[rank]``) and the same
        ``init_file`` (the mesh's rendezvous path, ``parallel.mesh.
        build_mesh``); ``model`` is the WHOLE model, of which this process
        keeps its shard. ``len(devices)`` must divide the cache's head
        count."""
        devices = list(devices)
        if len(devices) <= 1:
            if devices and torch.device(devices[0]) != model.device:
                raise ValueError(f"the model's weights are on {model.device}, not {devices[0]}")
            return cls(model, **kwargs)
        if init_file is None or not 0 <= rank < len(devices):
            raise ValueError(
                f"a replica over {len(devices)} devices runs one process per device: pass this "
                f"process's rank (0..{len(devices) - 1}, got {rank}) and the init_file every "
                "rank shares")
        from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

        mesh = build_mesh(MeshSpec(tp=len(devices)), rank, len(devices), init_file,
                          devices[rank])
        return cls(model, mesh=mesh, **kwargs)

    @classmethod
    def from_checkpoint(cls, model, directory, step: int | None = None, mesh=None,
                        param_dtype=None, **kwargs):
        """Serve straight from a training checkpoint: a WEIGHTS-ONLY partial
        restore of the ``params`` subtree into ``model`` (the optimizer
        state is never read). ``directory`` is a native checkpoint run
        directory of either package (or an open ``CheckpointManager``);
        ``step=None`` loads the latest committed step. ``param_dtype``
        (``"float32"``/``"bfloat16"`` or a torch dtype) serves the weights
        in that type: ``model`` is rebuilt in it first and the restore
        casts (e.g. a bf16-trained checkpoint served as f32). Every
        parameter is restored, so the module's own tensors are the
        template (the JAX package's ``init_seed`` template has no use
        here). With ``mesh`` the weights land in this rank's tp shard
        (built on ``mesh.device``; ``model`` only names the class and the
        config): the whole arrays are read on the host and the rank keeps
        its blocks (``checkpoint.optim_state.restore_params``). Remaining
        kwargs go to the constructor."""
        from dsml_tpu_torch.checkpoint import CheckpointManager
        from dsml_tpu_torch.checkpoint.optim_state import restore_params

        name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(param_dtype, param_dtype)
        config = model.config
        if name is not None and name != config.dtype:
            config = dataclasses.replace(config, dtype=name)
        if mesh is not None and mesh.shape.get("tp", 1) > 1:
            model = type(model)(config, device=mesh.device, tp_group=mesh.group("tp"))
        elif config is not model.config:
            model = type(model)(config, device=model.device)
        own = not hasattr(directory, "restore")
        manager = CheckpointManager(directory) if own else directory
        try:
            restore_params(manager, model, step)
        finally:
            if own:
                manager.close()
        return cls(model, mesh=mesh, **kwargs)

    # ---- device steps ----------------------------------------------------------

    def _tokens(self, padded: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(padded, device=self.device).long()

    def _insert(self, cache1, slot: int) -> None:
        """Copy a 1-row cache (on any device) into slot ``slot`` of the
        batch cache (the dense admission write); the source stays intact."""
        for c, c1 in zip(self._cache, cache1):
            for key in c:
                c[key][slot] = c1[key][0]

    def _chunk_paged(self, pool, table: np.ndarray, padded: np.ndarray, start: int, last: int):
        return self.model.prefill_chunk_paged(
            pool, torch.as_tensor(table, device=self.device), self._tokens(padded), int(start),
            last_index=int(last), quant=self.page_quant,
        )

    def _sample_rows(self, logits: torch.Tensor, keys: torch.Tensor, steps: torch.Tensor):
        if self.temperature <= 0.0:
            return logits.argmax(-1)
        return sample_token_logits(logits, None, self.temperature, self.top_k, self.top_p,
                                   uniform=request_uniform(keys, steps, logits.shape[-1]))

    def _decode_state(self, steps_done: np.ndarray) -> dict:
        """The device inputs of a decode chain: every slot's last token,
        position, sampler key and steps done, and (paged) the decode table."""
        dev = self.device
        return {"t": torch.as_tensor(self._last_tok, device=dev),
                "pos": torch.as_tensor(self._pos, device=dev),
                "keys": torch.as_tensor(self._slot_key, device=dev),
                "steps": torch.as_tensor(steps_done, device=dev),
                "table": torch.as_tensor(self._decode_table(), device=dev) if self.paged else None}

    def _decode_steps(self, st: dict, i0: int, n: int) -> list:
        """Steps ``i0 .. i0+n-1`` of the decode chain ``st`` (advanced in
        place), each sampling on the device and feeding its tokens to the
        next; returns the n token tensors [n_slots], not fetched. Positions
        clamp at max_seq - 1: a slot that retires mid-chain keeps writing
        its own dead last row (dense) or the scratch page (paged)."""
        max_seq = self.model.config.max_seq
        toks = []
        for i in range(i0, i0 + n):
            if self.paged:
                logits, _ = self.model.decode_step_slots_paged(
                    self._pool, st["table"], st["t"], st["pos"], quant=self.page_quant)
            else:
                logits, _ = self.model.decode_step_slots(self._cache, st["t"], st["pos"])
            st["t"] = self._sample_rows(logits, st["keys"], st["steps"] + i)
            toks.append(st["t"])
            st["pos"] = torch.clamp(st["pos"] + 1, max=max_seq - 1)
        return toks

    def _decode_tokens(self, steps_done: np.ndarray, quantum: int) -> np.ndarray:
        """One decode quantum over every slot: ``quantum`` chained steps,
        then one host fetch → tokens [quantum, n_slots]."""
        return torch.stack(self._decode_steps(self._decode_state(steps_done), 0, quantum)) \
            .cpu().numpy()

    def _decode_until(self, steps_done: np.ndarray, remaining: np.ndarray, active) -> np.ndarray:
        """The adaptive tick: decode until the step at which any active slot
        reaches its budget (``remaining``, on the host: step
        ``min(remaining[active])``) or samples ``eos_id``, or
        ``adaptive_quantum`` steps — the stop of the JAX early-exit
        ``while_loop``. Without an EOS id that is one chain and one fetch;
        with one, the tokens are read back every :data:`ADAPTIVE_EOS_CHECK`
        steps and the chain stops at the first group holding an active
        slot's EOS (steps past the stop write rows that the next tick
        overwrites before any query reads them, and their tokens are
        dropped). Returns tokens [n_steps, n_slots]."""
        k_stop = int(min(self.adaptive_quantum, remaining[active].min()))
        if self.eos_id is None:
            self.n_adaptive_syncs += 1
            return self._decode_tokens(steps_done, k_stop)
        st = self._decode_state(steps_done)
        groups, i = [], 0
        while i < k_stop:
            n = min(ADAPTIVE_EOS_CHECK, k_stop - i)
            got = torch.stack(self._decode_steps(st, i, n)).cpu().numpy()
            self.n_adaptive_syncs += 1
            groups.append(got)
            hit = np.flatnonzero((got[:, active] == self.eos_id).any(1))
            if len(hit):
                self.n_adaptive_steps_dropped += n - int(hit[0]) - 1
                return np.concatenate(groups)[: i + int(hit[0]) + 1]
            i += n
        return np.concatenate(groups)

    # ---- request interface -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, key_rid: int | None = None,
               trace_id: str | None = None, priority: int = 0) -> int:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        # the same validation generate applies
        self.model._check_generate_args(
            len(prompt), max_new_tokens, self.temperature, self.top_k, self.top_p)
        if self.speculative_window:
            # a continuing slot verifies a whole window at pos < L + max_new;
            # its last row (pos + W - 1) must stay inside the cache
            w = self.speculative_window
            if len(prompt) + max_new_tokens + w - 1 > self.model.config.max_seq:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) + "
                    f"speculative_window-1 ({w - 1}) must fit max_seq={self.model.config.max_seq}")
        if self.paged:
            if not self.prefill_chunk:
                raise ValueError(
                    "paged local admission requires prefill_chunk > 0 "
                    "(decode-only paged workers admit via inject)")
            if not self._chunk_grid_fits(len(prompt)):
                raise ValueError(
                    f"prompt length {len(prompt)} exceeds the chunk grid for "
                    f"max_seq={self.model.config.max_seq} (paged admission "
                    "has no bucketed fallback)")
            # never-fits check against the RESERVABLE ceiling: all pages but
            # the scratch page and the registry's, a matched prefix's shared
            # pages credited
            pre = self._prefixes and self._match_prefix(prompt)
            p_len = len(pre[0]) if pre else 0
            need = self._reserve_rows(len(prompt), max_new_tokens, p_len, worst_case=True)
            n_private = -(-need // self.page_size) - p_len // self.page_size
            ceiling = self.n_pages - 1 - self._registry_pages
            if n_private > ceiling:
                raise ValueError(
                    f"request needs {n_private} private pages but only "
                    f"{ceiling} are ever reservable ({self._registry_pages} "
                    "held by the prefix registry); raise n_pages")
        elif not self._chunk_grid_fits(len(prompt)):
            _bucket(len(prompt), self.prompt_buckets)  # whole-prompt admission: reject now
        if self.max_queue and len(self._queue) >= self.max_queue:
            # shed AFTER validation: a malformed request is the caller's bug
            # (ValueError), a full queue is the deployment's state
            self._shed()
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      submitted_at=time.monotonic(), key_rid=key_rid, trace_id=trace_id,
                      priority=int(priority))
        self._queue.append(req)
        self._live[rid] = req
        return rid

    def _shed(self) -> None:
        if self._obs.enabled:
            self._obs.counter("serving_shed_total", "requests rejected by the queue cap",
                              labels=("replica", "role")).inc(
                replica=self.obs_replica, role=self.obs_role)
        raise QueueFull(
            f"admission queue at its cap ({self.max_queue} waiting); "
            "request shed — retry on another replica or back off")

    def inject(self, prompt, max_new_tokens: int, cache1=None, logits_row=None,
               key_rid: int | None = None, submitted_at: float | None = None, *,
               kv_pages=None, page_size: int | None = None, prefix_rows: int = 0,
               trace_id: str | None = None) -> int:
        """Admit a request whose PREFILL ran elsewhere: the decode-worker
        half of the fleet's KV handoff (``serving/handoff.py``). ``cache1``
        is the 1-row KV cache a ``PrefillWorker`` produced for the whole
        prompt, ``logits_row`` the next-token logits at its last position.
        Admission costs one insert (no prefill here); the first token
        samples from ``logits_row`` under the (seed, ``key_rid``, step)
        noise a local admission would draw, so tokens equal submitting the
        prompt here. ``submitted_at`` carries the ORIGINAL submit time, so
        the admission histogram reports the true TTFT. Sheds with
        :class:`QueueFull` at ``max_queue`` handoffs waiting.

        A PAGED worker admits a paged handoff: ``kv_pages`` is the shipped
        page payload (per-layer dicts with a leading page axis, the pool's
        own entry layout), ``page_size`` the sender's (must match), and
        ``prefix_rows`` the leading rows not shipped because this worker
        shares its own registered prefix pages for them (validated here
        against the local registry). Tensors on another device (a decoded
        handoff's CPU tensors) are copied onto this worker's at admission.

        On a tensor-parallel ``mesh`` the handoff carries every head (a
        ``PrefillWorker`` serves the whole model) and this rank keeps its
        contiguous block of the head axis, the JAX ``P(None, "tp")``
        placement (:func:`head_block`); a payload already cut to this
        rank's heads is taken as it is. Nothing here reads a clock or a
        rank: every rank of the mesh admits the same request into the same
        slot and samples the same first token from the same logits row."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        self.model._check_generate_args(
            len(prompt), max_new_tokens, self.temperature, self.top_k, self.top_p)
        cfg = self.model.config
        tp = self.model.tp
        if tp > 1:
            payload = kv_pages if self.paged else cache1
            if payload is not None and len(payload) and \
                    payload[0]["k"].shape[1] == self.model._n_cache_heads:
                cut = head_block(payload, tp, self.mesh.coord("tp"))
                if self.paged:
                    kv_pages = cut
                else:
                    cache1 = cut
        if self.paged:
            if kv_pages is None:
                raise ValueError(
                    "paged decode worker: inject needs kv_pages= (a dense "
                    "cache1 cannot land in a page pool)")
            if page_size != self.page_size:
                raise ValueError(
                    f"handoff pages are {page_size} rows, this pool's are "
                    f"{self.page_size} — prefill and decode workers must "
                    "share the page size")
            if len(kv_pages) != cfg.n_layer:
                raise ValueError(f"handoff has {len(kv_pages)} layers, model has {cfg.n_layer}")
            ref = self._pool[0]
            for key in ref:
                arr = kv_pages[0].get(key)
                if arr is None or tuple(arr.shape[1:]) != tuple(ref[key].shape[1:]):
                    raise ValueError(
                        f"handoff page entry {key!r} is "
                        f"{None if arr is None else tuple(arr.shape)}; pool "
                        f"pages are {tuple(ref[key].shape)} — quant modes "
                        "must match")
            if prefix_rows < 0 or prefix_rows % self.page_size or prefix_rows > len(prompt):
                raise ValueError(
                    f"prefix_rows={prefix_rows} must be a multiple of "
                    f"page_size={self.page_size} within the prompt")
            if prefix_rows:
                # fail at the fleet edge when no local registration covers
                # the shared rows (the router replicates registrations)
                self._registered_prefix_pages(prompt, prefix_rows)
            n_ship = int(kv_pages[0]["k"].shape[0])
            rows = self._handoff_rows(len(prompt), max_new_tokens, prefix_rows, n_ship,
                                      worst_case=True)
            n_private = -(-rows // self.page_size) - prefix_rows // self.page_size
            ceiling = self.n_pages - 1 - self._registry_pages
            if n_private > ceiling:
                raise ValueError(
                    f"handoff needs {n_private} private pages but only "
                    f"{ceiling} are ever reservable ({self._registry_pages} "
                    "held by the prefix registry); raise n_pages")
        else:
            if kv_pages is not None:
                raise ValueError(
                    "dense decode worker: got kv_pages= (paged handoffs "
                    "need a paged_kv batcher)")
            if len(cache1) != cfg.n_layer:
                raise ValueError(
                    f"handoff cache has {len(cache1)} layers, model has {cfg.n_layer}")
            k = cache1[0]["k"]
            heads = self._cache[0]["k"].shape[1]  # this rank's, on a mesh
            if k.shape[0] != 1 or k.shape[1] != heads or k.shape[2] != cfg.max_seq:
                raise ValueError(
                    f"handoff cache rows are {tuple(k.shape)}; expected "
                    f"(1, {heads}, max_seq={cfg.max_seq}, ...) — prefill and "
                    "decode workers must share the model config")
        if self.max_queue and len(self._inject) >= self.max_queue:
            self._shed()
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      submitted_at=time.monotonic() if submitted_at is None else submitted_at,
                      key_rid=key_rid, trace_id=trace_id)
        self._live[rid] = req
        ctx = req.trace_ctx()
        if ctx is not None and self._obs.enabled:
            # the handoff landed here: a flow step on the decode lane links
            # the prefill worker's handoff to the admission that follows
            get_tracer().flow("decode_inject", ctx, phase="step", rid=rid,
                              replica=self.obs_replica)
        payload = (kv_pages, int(prefix_rows)) if self.paged else cache1
        self._inject.append((req, payload, torch.as_tensor(logits_row).reshape(-1)))
        return rid

    def register_prefix(self, tokens) -> None:
        """Precompute and keep the KV rows and next-token logits of a shared
        prompt head (a system prompt); later prompts starting with the
        longest registered prefix admit from them. Dense: the rows are
        copied into the slot and the suffix chunk-prefilled (needs
        ``prefill_chunk > 0``). Paged: the prefix is chunk-prefilled into
        pages the registry holds for good, and matching admissions share
        them read-only (copy-on-write for a straddling tail page)."""
        if self.paged:
            self._register_prefix_paged(tokens)
            return
        if not self.prefill_chunk:
            raise ValueError("prefix caching requires prefill_chunk > 0")
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prefix")
        if not self._chunk_grid_fits(n):
            raise ValueError(
                f"prefix length {n} exceeds the chunk grid for max_seq={self.model.config.max_seq}")
        c = self.prefill_chunk
        cache1 = self.model.init_cache(1)
        logits = None
        for start in range(0, n, c):
            end = min(start + c, n)
            padded = np.zeros((1, c), np.int64)
            padded[0, : end - start] = tokens[start:end]
            last_local = (n - 1) - start if end >= n else c - 1
            logits, cache1 = self.model.prefill_chunk(cache1, self._tokens(padded), start,
                                                      last_index=last_local)
        self._prefixes.append((tokens, cache1, logits[0]))
        self._prefixes.sort(key=lambda p: -len(p[0]))  # longest match wins

    def _register_prefix_paged(self, tokens) -> None:
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prefix")
        c = self.prefill_chunk or self.page_size
        if -(-n // c) * c > self.model.config.max_seq:
            raise ValueError(
                f"prefix length {n} exceeds the chunk grid for max_seq={self.model.config.max_seq}")
        pages, logits, self._pool = prefill_prefix_into_pages(
            self._chunk_paged, self._pool, self._pages, tokens, c, self.page_size, self._n_pt)
        self._registry_pages += len(pages)
        self._prefixes.append((tokens, pages, logits))
        self._prefixes.sort(key=lambda p: -len(p[0]))

    def _registered_prefix_pages(self, prompt: np.ndarray, prefix_rows: int) -> list:
        """The first ``prefix_rows // page_size`` pages of a registered
        prefix that agrees with ``prompt`` on its first ``prefix_rows``
        tokens (any such registration holds the same bytes there)."""
        n_full = prefix_rows // self.page_size
        for ptoks, ppages, _ in self._prefixes:
            if len(ptoks) >= prefix_rows and len(ppages) >= n_full and \
                    np.array_equal(ptoks[:prefix_rows], prompt[:prefix_rows]):
                return [int(p) for p in ppages[:n_full]]
        raise RuntimeError(
            f"no registered prefix covers the handoff's {prefix_rows} shared "
            "rows — inject validation should have rejected it")

    def _match_prefix(self, prompt: np.ndarray):
        """Longest registered prefix that heads ``prompt`` and whose suffix
        chunk grid stays inside the cache; None otherwise."""
        L = len(prompt)
        c = self.prefill_chunk
        max_seq = self.model.config.max_seq
        for ptoks, pcache, plogits in self._prefixes:
            p = len(ptoks)
            if p > L or not np.array_equal(prompt[:p], ptoks):
                continue
            if p < L and p + (-(-(L - p) // c)) * c > max_seq:
                continue  # the padded suffix grid would overrun the cache
            return ptoks, pcache, plogits
        return None

    @property
    def n_active(self) -> int:
        return int((self._slot_rid >= 0).sum())

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_pending(self) -> int:
        """Chunked admissions mid-prefill (0 or 1)."""
        return 0 if self._pending is None else 1

    @property
    def n_injected(self) -> int:
        """Handed-off admissions waiting for a free slot (:meth:`inject`)."""
        return len(self._inject)

    @property
    def n_preempted(self) -> int:
        """Evicted, unfinished requests awaiting resume (paged preemption)."""
        return len(self._preempted) if (self.paged and self.preemption) else 0

    @property
    def free_pages(self) -> int:
        return self._pages.free_pages if self.paged else 0

    @property
    def used_pages(self) -> int:
        return self._pages.used_pages if self.paged else 0

    @property
    def shared_pages(self) -> int:
        return self._pages.shared_pages if self.paged else 0

    # ---- scheduling ------------------------------------------------------------

    def _req_key(self, req: Request) -> int:
        return request_key(self.seed, req.rid if req.key_rid is None else req.key_rid)

    def _sample(self, logits_row: torch.Tensor, req: Request) -> int:
        """The first token, from the admission's logits row, at sampler step
        len(req.tokens) — the same noise the decode tick would draw."""
        keys = torch.tensor([self._req_key(req)], device=logits_row.device)
        steps = torch.tensor([len(req.tokens)], device=logits_row.device)
        return int(self._sample_rows(logits_row[None], keys, steps)[0])

    def _chunk_grid_fits(self, prompt_len: int) -> bool:
        """True when chunked admission serves this prompt: chunking is on
        and the padded grid ceil(L/C)·C stays inside max_seq."""
        c = self.prefill_chunk
        if c <= 0:
            return False
        return -(-prompt_len // c) * c <= self.model.config.max_seq

    def _handoff_rows(self, prompt_len: int, max_new: int, prefix_rows: int, n_ship: int,
                      worst_case: bool = False) -> int:
        """Rows a paged HANDOFF admission reserves pages for: the decode
        budget (with the speculative window's overhang) or the shipped and
        shared page grid, whichever is larger — one formula for inject's
        validation and the admission's reservation. With ``preemption``
        the admission reserves only the landing grid and the decode budget
        grows page by page."""
        base = prompt_len + max_new
        if self.speculative_window:
            base += self.speculative_window - 1
        landing = prefix_rows + n_ship * self.page_size
        if self.preemption and not worst_case:
            return max(prompt_len, landing)
        return max(base, landing)

    def _reserve_rows(self, prompt_len: int, max_new: int, prefix_len: int,
                      worst_case: bool = False) -> int:
        """Rows a paged admission reserves pages for: everything the request
        can ever write — the padded prefill chunk grid, the decode budget
        and the speculative window's overhang (W - 1 rows). With
        ``preemption`` only the chunk grid (decode grows page by page);
        ``worst_case`` (submit's never-fits check) always counts the whole
        footprint."""
        base = prompt_len + max_new
        if self.speculative_window:
            base += self.speculative_window - 1
        c = self.prefill_chunk or self.page_size
        grid_end = prefix_len + -(-(prompt_len - prefix_len) // c) * c \
            if prompt_len > prefix_len else prompt_len
        if self.preemption and not worst_case:
            return min(self.model.config.max_seq, grid_end)
        return min(self.model.config.max_seq, max(base, grid_end))

    def _assign_slot_pages(self, slot: int, plan) -> None:
        """Install an admission plan as ``slot``'s page table and run its
        CoW copy of a straddling prefix tail."""
        self._slot_pages[slot] = list(plan.pages)
        self._slot_shared[slot] = plan.n_shared
        self._page_table[slot, :] = 0
        self._page_table[slot, : len(plan.pages)] = plan.pages
        if plan.copy is not None:
            src, dst = plan.copy
            self._pool = copy_page(self._pool, src, dst)
            self.n_cow_copies += 1
            if self._obs.enabled:
                self._obs.counter("serving_cow_copies_total",
                                  "prefix pages materialized privately on first write",
                                  labels=("replica", "role")).inc(
                    replica=self.obs_replica, role=self.obs_role)

    def _decode_table(self) -> np.ndarray:
        """The page table a decode tick sees: ACTIVE slots' rows only. A
        pending chunked admission already owns its pages, but the decode
        step writes a masked garbage row for every non-active slot; routed
        to the scratch page here, it cannot clobber the admission's rows."""
        return np.where((self._slot_rid >= 0)[:, None], self._page_table, 0)

    def _free_slot_pages(self, slot: int) -> None:
        """Release a slot's pages; its table row points back at the scratch
        page. No-op for dense."""
        if not self.paged:
            return
        pages = self._slot_pages[slot]
        if pages:
            self._pages.release(pages)
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self._page_table[slot, :] = 0

    # ---- eviction-based preemption (paged preemption=True) ---------------------

    def _pick_victim(self, exclude: int | None = None) -> int | None:
        """Lowest priority first, youngest (highest rid) within a priority;
        ``exclude`` shields the slot whose growth caused the pressure."""
        best = None
        for slot in np.flatnonzero(self._slot_rid >= 0):
            s = int(slot)
            if s == exclude:
                continue
            key = (self._slot_prio[s], -self._slot_rid[s])
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    def _preempt_kind(self, req) -> str:
        """"auto": a victim still at its first token holds only prompt-grid
        pages that chunked prefill rebuilds (recompute); past that, swapping
        the live bytes beats re-running prefill (swap). Both resume with
        identical tokens (quantized chunk chaining is chunk-size
        invariant)."""
        if self.preempt_policy != "auto":
            return self.preempt_policy
        return "recompute" if len(req.tokens) <= 1 else "swap"

    def _evict_slot(self, slot: int) -> None:
        """Preempt ``slot``: private pages copy to the host (swap) or drop
        (recompute), every page reference is released (a shared prefix
        page only loses this reference), and the request joins the resume
        queue."""
        req = self._live[int(self._slot_rid[slot])]
        pages = self._slot_pages[slot]
        n_shared = int(self._slot_shared[slot])
        kind = self._preempt_kind(req)
        entry = {"req": req, "pos": int(self._pos[slot]), "last_tok": int(self._last_tok[slot]),
                 "shared_rows": n_shared * self.page_size, "kind": kind}
        if kind == "swap":
            entry["pages_host"] = gather_pages(self._pool, pages[n_shared:])
            self.n_swap_evictions += 1
        else:
            self.n_recompute_evictions += 1
        self._slot_rid[slot] = -1
        self._free_slot_pages(slot)
        self._preempted.append(entry)
        self.n_preemptions += 1
        if self._obs.enabled:
            self._obs.counter("serving_preemptions_total",
                              "slots evicted under page-pool pressure",
                              labels=("kind", "replica", "role")).inc(
                kind=kind, replica=self.obs_replica, role=self.obs_role)
            # the pressure that forced the eviction: a postmortem shows
            # whether the card or merely the pool's sizing was the limit.
            # The eviction's kind rides as preempt_kind: ``kind`` is the
            # event's own (the JAX batcher's kind=kind raises a TypeError)
            flight_recorder.record("serving_preempt", rid=req.rid, preempt_kind=kind,
                                   pos=entry["pos"], pressure=round(self.memory_pressure(), 4),
                                   **self._trace_field(req))

    def _ensure_decode_pages(self, active, width: int) -> list:
        """Before a decode tick each participating slot must own pages for
        its next ``width`` rows; when the pool is dry, evict (lowest
        priority, youngest first) until the growth fits — the growing slot
        itself only when nobody else is left. Returns the slots still
        active."""
        max_seq = self.model.config.max_seq
        kept = []
        for slot in active:
            s = int(slot)
            if self._slot_rid[s] < 0:
                continue  # evicted as a victim this pass
            last_row = min(int(self._pos[s]) + width - 1, max_seq - 1)
            n_entries = last_row // self.page_size + 1
            while len(self._slot_pages[s]) < n_entries:
                want = n_entries - len(self._slot_pages[s])
                if self._pages.can_alloc(want):
                    start_i = len(self._slot_pages[s])
                    new = self._pages.alloc(want)
                    self._slot_pages[s].extend(new)
                    self._page_table[s, start_i : start_i + want] = new
                    continue
                victim = self._pick_victim(exclude=s)
                if victim is None:
                    # nobody else holds pages: this slot yields and resumes
                    # once retirements free the pool
                    self._evict_slot(s)
                    break
                self._evict_slot(int(victim))
            if self._slot_rid[s] >= 0:
                kept.append(s)
        return [s for s in kept if self._slot_rid[s] >= 0]

    def _install_pages(self, pages: list, payload: list) -> None:
        """Scatter a page payload (per-layer dicts with a leading page axis,
        on any device: a swapped-out slot's or a handoff's) into ``pages``
        of the pool."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for c, layer in zip(self._pool, payload):
            for key, arr in layer.items():
                c[key][idx] = arr.to(self.device)
        self.n_insert_dispatches += 1

    def _install_slot(self, slot: int, shared: list, n_private: int) -> list:
        """Share ``shared`` pages and allocate ``n_private`` fresh ones as
        ``slot``'s table; returns the private pages."""
        self._pages.share(shared)
        private = self._pages.alloc(n_private)
        pages = shared + private
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = len(shared)
        self._page_table[slot, :] = 0
        self._page_table[slot, : len(pages)] = pages
        return private

    def _try_resume(self, entry: dict, slot: int) -> bool:
        """Re-admit a preempted request into ``slot``. Swap: re-share the
        prefix pages, allocate private pages and copy the host rows back in
        — the same rows, no recompute. Recompute: reserve the re-prefill
        grid and stage a pending chunked admission over prompt + emitted
        tokens (all but the last, the next decode input). False when the
        pool cannot serve it yet (it keeps its place in the queue)."""
        req, pos, shared_rows = entry["req"], entry["pos"], entry["shared_rows"]
        n_full = shared_rows // self.page_size
        if entry["kind"] == "swap":
            payload = entry["pages_host"]
            n_private = int(payload[0]["k"].shape[0])
            if not self._pages.can_alloc(n_private):
                return False
            shared = self._registered_prefix_pages(req.prompt, shared_rows) if shared_rows else []
            private = self._install_slot(slot, shared, n_private)
            if n_private:
                self._install_pages(private, payload)
            self._restore_slot(req, slot, pos, entry["last_tok"])
            return True
        c = self.prefill_chunk or self.page_size
        grid_end = min(shared_rows + -(-(pos - shared_rows) // c) * c, self.model.config.max_seq)
        n_private = pages_for(grid_end, self.page_size) - n_full
        if not self._pages.can_alloc(n_private):
            return False
        shared = self._registered_prefix_pages(req.prompt, shared_rows) if shared_rows else []
        self._install_slot(slot, shared, n_private)
        if pos == shared_rows:
            # every written row lives in shared prefix pages: reoccupy directly
            self._restore_slot(req, slot, pos, entry["last_tok"])
            return True
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int64)])
        assert len(seq) == pos, (len(seq), pos)
        self._slot_rid[slot] = -2  # reserved: not free, not decoding
        self._pending = (req, slot, shared_rows, seq, {"pos": pos, "last_tok": entry["last_tok"]})
        return True

    def _restore_slot(self, req, slot: int, pos: int, last_tok: int) -> None:
        """Reoccupy ``slot`` with a resumed request's decode state."""
        self._slot_rid[slot] = req.rid
        self._pos[slot] = pos
        self._last_tok[slot] = last_tok
        self._slot_key[slot] = self._req_key(req)
        self._slot_accept[slot] = np.nan
        self._slot_prio[slot] = req.priority
        if self._obs.enabled:
            flight_recorder.record("serving_resume", rid=req.rid, pos=pos, **self._trace_field(req))

    # ---- admission ---------------------------------------------------------------

    def _occupy(self, req: Request, slot: int, tok: int) -> None:
        self._slot_rid[slot] = req.rid
        self._pos[slot] = len(req.prompt)
        self._last_tok[slot] = tok
        self._slot_key[slot] = self._req_key(req)
        self._slot_accept[slot] = np.nan  # a fresh request, a fresh EWMA
        if self.paged:
            self._slot_prio[slot] = req.priority

    def _finish_admission(self, req: Request, slot: int, logits_row, emitted: dict) -> None:
        """The admission epilogue of every path: sample the first token,
        stamp the time to first token, emit, then retire (the slot stays
        free) or occupy."""
        tok = self._sample(logits_row, req)
        req.tokens.append(tok)
        req.first_token_at = time.monotonic()
        if self._obs.enabled:
            # admission latency = queue wait + prefill, the serving-side
            # time to first token; the trace_id rides as the exemplar
            admission_ms = (req.first_token_at - req.submitted_at) * 1e3
            self._obs.histogram("serving_admission_ms", "submit→first-token latency",
                                labels=("replica", "role")).observe(
                admission_ms, exemplar=req.trace_id, replica=self.obs_replica,
                role=self.obs_role)
            flight_recorder.record("serving_admit", rid=req.rid, prompt_len=len(req.prompt),
                                   admission_ms=round(admission_ms, 3), **self._trace_field(req))
            if req.trace_id is not None:
                get_tracer().instant("serving_first_token", trace_id=req.trace_id, rid=req.rid,
                                     admission_ms=round(admission_ms, 3),
                                     replica=self.obs_replica)
        emitted[req.rid] = [tok]
        if self._finished(req, tok):
            self._retire(req)
            self._slot_rid[slot] = -1
            self._free_slot_pages(slot)
            return
        self._occupy(req, slot, tok)

    def _admit_injected(self, emitted: dict) -> None:
        """Admit handed-off requests into free slots before queued prompts
        (they already paid their prefill): insert the prefilled rows and
        run the admission epilogue — one insert, no prefill here. A paged
        handoff reserves and installs PAGES instead: its shared prefix rows
        resolve to this worker's registered prefix pages (a reference, no
        bytes moved), the shipped pages land at freshly allocated ones, and
        the rest of the decode budget's pages come from the free list; one
        that cannot reserve waits at the head of the inject queue."""
        while self._inject:
            free = np.flatnonzero(self._slot_rid == -1)
            if len(free) == 0:
                return
            slot = int(free[0])
            if not self.paged:
                req, cache1, logits_row = self._inject.popleft()
                self.n_insert_dispatches += 1
                self._insert(cache1, slot)
                self._finish_admission(req, slot, logits_row.to(self.device), emitted)
                continue
            req, (payload, prefix_rows), logits_row = self._inject[0]  # peek
            n_ship = int(payload[0]["k"].shape[0])
            rows = self._handoff_rows(len(req.prompt), req.max_new_tokens, prefix_rows, n_ship)
            n_private = pages_for(rows, self.page_size) - prefix_rows // self.page_size
            if not self._pages.can_alloc(n_private):
                first = self._page_wait_rid_inject != req.rid
                self._page_wait_rid_inject = req.rid
                note_page_wait(self._obs, self.obs_replica, self.obs_role,
                               trace=req.trace_ctx() if first else None)
                return  # pool full: the handoff waits for retirements
            shared = self._registered_prefix_pages(req.prompt, prefix_rows) if prefix_rows else []
            self._inject.popleft()
            # _install_slot sets the CoW boundary too: eviction treats the
            # first _slot_shared pages as references and never swaps them
            private = self._install_slot(slot, shared, n_private)
            if n_ship:
                self._install_pages(private[:n_ship], payload)
            self._finish_admission(req, slot, logits_row.to(self.device), emitted)

    def _admit_full(self, req: Request, slot: int, emitted: dict) -> None:
        """Whole-prompt prefill padded to its bucket, the copy into the
        slot, and the first token."""
        L = len(req.prompt)
        padded = np.zeros((1, _bucket(L, self.prompt_buckets)), np.int64)
        padded[0, :L] = req.prompt
        logits, cache1 = self.model.prefill(self._tokens(padded), last_index=L - 1)
        self._insert(cache1, slot)
        self.n_prefill_dispatches += 1
        self._finish_admission(req, slot, logits[0], emitted)

    def _admit(self) -> dict[int, list]:
        """Fill free slots from the queue (whole-prompt admission)."""
        emitted: dict[int, list] = {}
        for slot in np.flatnonzero(self._slot_rid == -1):
            while self._queue and self._slot_rid[slot] == -1:
                self._admit_full(self._queue.popleft(), int(slot), emitted)
        return emitted

    def _advance_pending(self, emitted: dict) -> bool:
        """Run ONE chunk of the in-flight dense chunked admission; on the
        last chunk copy the accumulated cache into the slot and sample the
        first token. True when the admission completed."""
        req, slot, cache1, start = self._pending
        c = self.prefill_chunk
        L = len(req.prompt)
        end = min(start + c, L)
        padded = np.zeros((1, c), np.int64)
        padded[0, : end - start] = req.prompt[start:end]
        is_last = end >= L
        last_local = (L - 1) - start if is_last else c - 1
        logits, cache1 = self.model.prefill_chunk(cache1, self._tokens(padded), start,
                                                  last_index=last_local)
        self.n_prefill_dispatches += 1
        if not is_last:
            self._pending = (req, slot, cache1, start + c)
            return False
        self._insert(cache1, slot)
        self._pending = None
        self._finish_admission(req, slot, logits[0], emitted)
        return True

    def _admit_chunked(self) -> dict[int, list]:
        """Dense chunked admission: advance the in-flight admission by ONE
        chunk; when one completes, keep admitting from the queue (short
        prompts complete in one chunk), and yield to decode the moment a
        long prompt's chunk ends without completing it."""
        emitted: dict[int, list] = {}
        while True:
            if self._pending is not None:
                if not self._advance_pending(emitted):
                    return emitted
                continue
            free = np.flatnonzero(self._slot_rid == -1)
            if len(free) == 0 or not self._queue:
                return emitted
            req = self._queue.popleft()
            slot = int(free[0])
            if not self._chunk_grid_fits(len(req.prompt)):
                self._admit_full(req, slot, emitted)  # the padded grid would overrun the cache
                continue
            pre = self._prefixes and self._match_prefix(req.prompt)
            if pre:
                ptoks, pcache, plogits = pre
                if len(ptoks) == len(req.prompt):
                    # the whole prompt is the prefix: no prefill at all
                    self.n_insert_dispatches += 1
                    self._insert(pcache, slot)
                    self._finish_admission(req, slot, plogits, emitted)
                    continue
                # suffix-only prefill over a COPY of the prefix rows (the
                # chunk writes its cache in place; the master must survive)
                self._slot_rid[slot] = -2
                self._pending = (req, slot, [{k: v.clone() for k, v in c.items()} for c in pcache],
                                 len(ptoks))
                continue
            self._slot_rid[slot] = -2
            self._pending = (req, slot, self.model.init_cache(1), 0)

    def _admit_paged(self) -> dict[int, list]:
        """Paged admission: advance the in-flight admission by ONE chunk;
        else resume a preempted request, or reserve a page plan for the
        queue head (shared prefix pages + CoW tail copy + fresh pages) and
        start it. A head that cannot reserve WAITS (FIFO) for retirements.
        An exact prefix hit admits with no prefill at all."""
        emitted: dict[int, list] = {}
        while True:
            if self._pending is not None:
                if not self._advance_pending_paged(emitted):
                    return emitted
                continue
            free = np.flatnonzero(self._slot_rid == -1)
            if len(free) == 0:
                return emitted
            if self.preemption and self._preempted:
                # resumes precede fresh admissions; one that cannot reserve
                # holds the line
                if not self._try_resume(self._preempted[0], int(free[0])):
                    self._note_page_wait(self._preempted[0]["req"])
                    return emitted
                self._preempted.popleft()
                continue
            if not self._queue:
                return emitted
            req = self._queue[0]  # pop only once pages are reserved
            L = len(req.prompt)
            slot = int(free[0])
            pre = self._prefixes and self._match_prefix(req.prompt)
            ptoks, ppages, plogits = pre if pre else (None, None, None)
            p_len = len(ptoks) if pre else 0
            plan = plan_admission(self._pages, self.page_size,
                                  self._reserve_rows(L, req.max_new_tokens, p_len),
                                  prefix_pages=ppages, prefix_len=p_len)
            if plan is None:
                if self._pages.used_pages == self._registry_pages and self.n_active == 0:
                    # the pool is as empty as it gets and the head still
                    # cannot reserve: a prefix registered after this submit
                    # shrank the ceiling — fail instead of waiting forever
                    raise RuntimeError(
                        f"request {req.rid} can never reserve its pages "
                        f"({self._registry_pages} held by the prefix registry); register "
                        "prefixes before accepting traffic, or raise n_pages")
                self._note_page_wait(req)
                return emitted  # pool full: wait for retirements
            self._queue.popleft()
            self._assign_slot_pages(slot, plan)
            if pre and p_len == L:
                self._finish_admission(req, slot, plogits, emitted)
                continue
            self._slot_rid[slot] = -2
            self._pending = (req, slot, p_len, req.prompt, None)

    def _advance_pending_paged(self, emitted: dict) -> bool:
        """Run ONE chunk of the in-flight paged admission straight into the
        slot's pages. ``seq`` is the prompt, or prompt + emitted tokens for
        a recompute resume (whose last logits are dropped: the request
        already holds its next input). True when the admission completed."""
        req, slot, start, seq, resume = self._pending
        c = self.prefill_chunk or self.page_size
        L = len(seq)
        end = min(start + c, L)
        padded = np.zeros((1, c), np.int64)
        padded[0, : end - start] = seq[start:end]
        is_last = end >= L
        last_local = (L - 1) - start if is_last else c - 1
        logits, self._pool = self._chunk_paged(self._pool, self._page_table[slot : slot + 1],
                                               padded, start, last_local)
        self.n_prefill_dispatches += 1
        if not is_last:
            self._pending = (req, slot, start + c, seq, resume)
            return False
        self._pending = None
        if resume is not None:
            self._restore_slot(req, slot, resume["pos"], resume["last_tok"])
            return True
        self._finish_admission(req, slot, logits[0], emitted)
        return True

    # ---- retirement and metrics ------------------------------------------------

    def _finished(self, req: Request, tok: int) -> bool:
        return (self.eos_id is not None and tok == self.eos_id) or (
            len(req.tokens) >= req.max_new_tokens)

    def _retire(self, req: Request) -> None:
        req.done = True
        req.finished_at = time.monotonic()
        self._latency.append((
            (req.first_token_at or req.finished_at) - req.submitted_at,  # TTFT
            req.finished_at - req.submitted_at,  # end to end
        ))
        if self._obs.enabled:
            flight_recorder.record("serving_retire", rid=req.rid, tokens=len(req.tokens),
                                   e2e_ms=round((req.finished_at - req.submitted_at) * 1e3, 3),
                                   **self._trace_field(req))
            ctx = req.trace_ctx()
            if ctx is not None:
                # flow END: the request's causal chain ends on this lane
                get_tracer().flow("serving_retire", ctx, phase="end", rid=req.rid,
                                  outcome="retired", replica=self.obs_replica)
        self._done[req.rid] = self._live.pop(req.rid)

    def _note_emissions(self, emitted: dict) -> None:
        """Record the gap since each request's previous emission (a quantum
        of k tokens is one emission)."""
        now = time.monotonic()
        for rid, toks in emitted.items():
            if not toks:
                continue
            req = self._live.get(rid) or self._done.get(rid)
            if req is None:
                continue
            if req.last_emit_at is not None:
                self._gaps.append(now - req.last_emit_at)
            req.last_emit_at = now

    def latency_stats(self) -> dict:
        """p50/p99 time to first token, inter-emission gap and end-to-end
        seconds over the requests retired since construction (or the last
        ``reset_latency_stats``)."""
        out = {"n_requests": len(self._latency)}
        if not self._latency:
            return out

        def pct(vals, q):
            return round(float(np.percentile(np.asarray(vals), q)), 6)

        ttft, e2e = zip(*self._latency)
        out.update(ttft_p50_s=pct(ttft, 50), ttft_p99_s=pct(ttft, 99),
                   e2e_p50_s=pct(e2e, 50), e2e_p99_s=pct(e2e, 99))
        if self._gaps:
            out["gap_p50_s"] = pct(self._gaps, 50)
            out["gap_p99_s"] = pct(self._gaps, 99)
        return out

    def reset_latency_stats(self) -> None:
        self._latency.clear()
        self._gaps.clear()

    def step(self) -> dict[int, list]:
        """One scheduler tick: admit, one decode quantum over all slots,
        emit. Returns {rid: [new tokens]} for every request that produced
        tokens, the admissions' first tokens included."""
        if not self._obs.enabled:
            emitted = self._step_inner()
            self._note_emissions(emitted)
            return emitted
        # one span a tick (decode quantum + admissions), without a fence:
        # the tick already ends in the host fetch of its tokens
        with get_tracer().span("decode_tick", replica=self.obs_replica, n_active=self.n_active):
            emitted = self._step_inner()
        self._note_emissions(emitted)
        labels = {"replica": self.obs_replica, "role": self.obs_role}
        self._obs.histogram(
            "serving_slot_occupancy", "active slots / n_slots per tick", labels=("replica", "role"),
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        ).observe(self.n_active / self.n_slots, **labels)
        self._obs.gauge("serving_queue_depth", "requests waiting for a slot",
                        labels=("replica", "role")).set(self.n_queued + self.n_injected, **labels)
        self._obs.counter("serving_tokens_total", "tokens emitted", labels=("replica", "role")).inc(
            sum(len(t) for t in emitted.values()), **labels)
        return emitted

    # ---- observability -----------------------------------------------------------

    def _ledger_name(self) -> str:
        return f"{self.obs_replica}/{self.obs_role}/{id(self):x}"

    @staticmethod
    def _trace_field(req: Request) -> dict:
        return {"trace_id": req.trace_id} if req.trace_id else {}

    def _note_page_wait(self, req: Request) -> None:
        """One tick of an admission (or a resume) waiting for pool pages;
        the first tick of the request's wait marks its flow."""
        first = self._page_wait_rid != req.rid
        self._page_wait_rid = req.rid
        note_page_wait(self._obs, self.obs_replica, self.obs_role,
                       trace=req.trace_ctx() if first else None)

    def _export_pool_gauges(self) -> None:
        """Collect-hook body: the pool's occupancy gauges and
        ``serving_memory_pressure`` from its CURRENT state at every
        exposition."""
        if not self._obs.enabled:
            return  # the hooks run on a disabled registry too: skip the reads
        export_pool_gauges(self._obs, self._pages, self.obs_replica, self.obs_role)
        self._obs.gauge(
            "serving_memory_pressure",
            "device-memory pressure in [0,1]: measured bytes_in_use / bytes_limit when the "
            "card reports memory_stats, else the pool's allocated-page fraction",
            labels=("replica", "role"),
        ).set(self.memory_pressure(), replica=self.obs_replica, role=self.obs_role)

    def _bytes_per_page(self) -> float:
        """Bytes of ONE physical page, from the live pool tensors (int4
        rows, kv heads and scales all reflected), computed once."""
        if self._page_nbytes is None:
            self._page_nbytes = tree_nbytes(self._pool, per_device=True) / max(self.n_pages, 1)
        return self._page_nbytes

    def _ledger_page_bytes(self) -> dict:
        """Ledger source: the pool's device bytes as a disjoint
        live/shared/free/scratch split (summing to the whole pool, which is
        resident whatever the occupancy)."""
        bpp = self._bytes_per_page()
        shared = self._pages.shared_pages
        return {"live": (self._pages.used_pages - shared) * bpp, "shared": shared * bpp,
                "free": self._pages.free_pages * bpp, "scratch": bpp}

    def _ledger_weight_quant_bytes(self) -> dict:
        """Ledger source: the quantized serving weights' packed codes and
        scales."""
        return dict(self._wq_bytes)

    def memory_pressure(self) -> float:
        """Device-memory pressure in [0, 1]: MEASURED ``bytes_in_use /
        bytes_limit`` when the card reports ``torch.cuda.memory_stats``
        (the whole card, weights and temporaries included), else the pool's
        allocated-page fraction (a CPU run). 0 for a dense cache."""
        if not self.paged:
            return 0.0
        measured = get_memory_ledger(self._obs).measure()
        if measured["available"] and measured.get("bytes_limit"):
            return min(max(measured["bytes_in_use"] / measured["bytes_limit"], 0.0), 1.0)
        allocatable = max(self.n_pages - 1, 1)
        return (allocatable - self._pages.free_pages) / allocatable

    def _step_inner(self) -> dict[int, list]:
        emitted: dict[int, list] = {}
        if self._inject:
            self._admit_injected(emitted)
        # handed-off and local admissions touch disjoint rids
        if self.paged:
            emitted.update(self._admit_paged())
        else:
            emitted.update(self._admit_chunked() if self.prefill_chunk else self._admit())
        active = np.flatnonzero(self._slot_rid >= 0)
        if len(active) == 0:
            return emitted
        if self.speculative_window:
            return self._step_speculative(emitted, active)
        if self.paged and self.preemption:
            # every decoding slot must own pages for this tick's writes
            active = self._ensure_decode_pages(active, self.decode_quantum)
            if not active:
                return emitted
        steps_done = np.asarray(
            [len(self._live[rid].tokens) if rid >= 0 else 0 for rid in self._slot_rid], np.int64)
        if self.paged:  # the paged tick is the plain quantum, as in the JAX batcher
            self.n_plain_ticks += 1
            return self._apply_decoded(emitted, active,
                                       self._decode_tokens(steps_done, self.decode_quantum),
                                       self.decode_quantum)
        # adaptive early-exit tick, whenever no chunked admission is mid-flight
        # (those need the plain quantum's chunk interleave); a retirement ends
        # the tick, so a queued request admits on the very next tick
        if self.adaptive_quantum and self._pending is None:
            toks = self._decode_until(steps_done, self._remaining(active), active)
            self.n_adaptive_ticks += 1
            return self._apply_decoded(emitted, active, toks, len(toks))
        # turbo escalation in steady-state decode (nothing waiting to admit):
        # gated on the LARGEST remaining budget — with an empty queue a slot
        # freed mid-tick would idle under plain ticks too
        quantum = self.decode_quantum
        if (self.turbo_factor and not self._queue and self._pending is None
                and self._remaining(active)[active].max() >= quantum * self.turbo_factor):
            quantum *= self.turbo_factor
            self.n_turbo_ticks += 1
        else:
            self.n_plain_ticks += 1
        return self._apply_decoded(emitted, active, self._decode_tokens(steps_done, quantum),
                                   quantum)

    def _remaining(self, active) -> np.ndarray:
        """[n_slots] budget left of each ``active`` slot (max_seq elsewhere)."""
        rem = np.full(self.n_slots, self.model.config.max_seq, np.int64)
        for slot in active:
            req = self._live[int(self._slot_rid[slot])]
            rem[slot] = req.max_new_tokens - len(req.tokens)
        return rem

    def _apply_decoded(self, emitted: dict, active, toks, quantum: int) -> dict:
        """Apply one tick's tokens [quantum, n_slots]: emit, retire on EOS or
        budget (dropping a finished slot's tail), advance continuing slots."""
        for slot in active:
            req = self._live[int(self._slot_rid[slot])]
            new = emitted.setdefault(req.rid, [])
            for i in range(quantum):
                tok = int(toks[i, slot])
                req.tokens.append(tok)
                new.append(tok)
                if self._finished(req, tok):
                    self._retire(req)
                    self._slot_rid[slot] = -1
                    self._free_slot_pages(slot)
                    break
            if self._slot_rid[slot] >= 0:
                self._pos[slot] += quantum
                # submit's L + max_new <= max_seq keeps a continuing slot's
                # next write inside the cache, so the clamp never bites here
                assert self._pos[slot] < self.model.config.max_seq, (
                    f"slot {slot} position {self._pos[slot]} escaped max_seq="
                    f"{self.model.config.max_seq}")
                self._last_tok[slot] = int(toks[-1, slot])
        return emitted

    def _active_accept_ewma(self) -> float | None:
        """The adaptive window's acceptance signal: the mean of ACTIVE
        slots' EWMAs, else the batcher-level EWMA while no active slot has
        a measurement (fresh admissions), None before any measurement."""
        active = self._slot_accept[self._slot_rid >= 0]
        vals = active[~np.isnan(active)]
        if len(vals):
            return float(vals.mean())
        return self.accept_ewma

    def _spec_window_for_tick(self) -> int:
        """This tick's verify window: ``speculative_window``, or under
        ``speculative_adaptive`` one draft beyond the expected accepted
        count at the measured acceptance (floor 2, cap the configured
        window; the cap until the first measurement). Greedy tokens are
        the same at any width."""
        w_max = self.speculative_window
        if not self.speculative_adaptive:
            return w_max
        acc = self._active_accept_ewma()
        if acc is None:
            return w_max
        expected = 1.0 + acc * (w_max - 1)
        return max(2, min(w_max, int(np.ceil(expected)) + 1))

    def predicted_tpot_s(self) -> float | None:
        """Acceptance-aware time per output token: the verify tick's wall
        EWMA over the committed tokens a slot a tick. None until both are
        measured, or without the speculative tick. The fleet router's
        cost model reads it (``Router.decode_cost_s``)."""
        if (not self.speculative_window or self.spec_tick_s_ewma is None
                or not self.commit_ewma):
            return None
        return self.spec_tick_s_ewma / max(self.commit_ewma, 1.0)

    def _step_speculative(self, emitted: dict, active) -> dict[int, list]:
        """One speculative tick: per-slot prompt-lookup drafts on the host,
        ONE verify call over every slot at its own depth (dense
        ``verify_step``, paged ``verify_step_paged`` through the decode
        table), one host fetch of the greedy tokens, then each active slot
        commits its accepted drafts and the model's next token; the
        acceptance EWMAs update per slot."""
        w = self._spec_window_for_tick()
        if self.paged and self.preemption:
            # the window writes rows pos..pos+w-1: grow first
            active = self._ensure_decode_pages(active, w)
            if len(active) == 0:
                return emitted
        toks = np.zeros((self.n_slots, w), np.int64)
        pos = np.zeros(self.n_slots, np.int64)
        for slot in active:
            req = self._live[int(self._slot_rid[slot])]
            history = np.concatenate([req.prompt, np.asarray(req.tokens, np.int64)])
            toks[slot, 0] = self._last_tok[slot]
            toks[slot, 1:] = lookup_draft_host(history, self.speculative_ngram, w - 1)
            pos[slot] = self._pos[slot]
        t0 = time.monotonic()
        window, start = self._tokens(toks), torch.as_tensor(pos, device=self.device)
        if self.paged:
            logits, _ = self.model.verify_step_paged(
                self._pool, torch.as_tensor(self._decode_table(), device=self.device), window,
                start, quant=self.page_quant)
        else:
            logits, _ = self.model.verify_step(self._cache, window, start)
        greedy = logits.argmax(-1).cpu().numpy()  # [n_slots, W]; the fetch ends the tick
        wall = time.monotonic() - t0
        self.n_spec_ticks += 1
        self.spec_window_used[w] = self.spec_window_used.get(w, 0) + 1
        # wall-clock: reported (predicted_tpot_s), never read by a tick's
        # decision, so the ranks of a mesh cannot diverge on it
        self.spec_tick_s_ewma = (wall if self.spec_tick_s_ewma is None
                                 else 0.8 * self.spec_tick_s_ewma + 0.2 * wall)
        committed_total = 0
        for slot in active:
            req = self._live[int(self._slot_rid[slot])]
            new = emitted.setdefault(req.rid, [])
            drafts = toks[slot, 1:]
            committed = 0
            measured = True  # False when a retirement censors the window
            for i in range(w):
                # greedy[i] is the model's next token after window position
                # i, valid while every earlier draft matched the chain
                tok = int(greedy[slot, i])
                req.tokens.append(tok)
                new.append(tok)
                self._last_tok[slot] = tok
                committed += 1
                if self._finished(req, tok):
                    self._retire(req)
                    self._slot_rid[slot] = -1
                    self._free_slot_pages(slot)
                    # the unconsumed drafts were never judged: no sample,
                    # unless the window was accepted whole
                    measured = committed == w
                    break
                if i == w - 1 or int(drafts[i]) != tok:
                    break
            committed_total += committed
            if measured and w > 1:
                rate = (committed - 1) / (w - 1)
                prev = self._slot_accept[slot]
                self._slot_accept[slot] = rate if np.isnan(prev) else 0.8 * prev + 0.2 * rate
                self.accept_ewma = (rate if self.accept_ewma is None
                                    else 0.8 * self.accept_ewma + 0.2 * rate)
            if self._slot_rid[slot] >= 0:
                self._pos[slot] += committed
                # submit's L + max_new + W - 1 <= max_seq keeps the next window inside
                assert self._pos[slot] + w <= self.model.config.max_seq, (
                    f"slot {slot} verify window would escape max_seq={self.model.config.max_seq}")
        mean_commit = committed_total / len(active)
        self.commit_ewma = (mean_commit if self.commit_ewma is None
                            else 0.8 * self.commit_ewma + 0.2 * mean_commit)
        if self._obs.enabled and self.accept_ewma is not None:
            self._obs.gauge("serving_spec_accept_rate", "speculative draft acceptance rate (EWMA)",
                            labels=("replica", "role")).set(
                self.accept_ewma, replica=self.obs_replica, role=self.obs_role)
        return emitted

    def abandon(self) -> list[Request]:
        """Evacuate every unfinished request (queued, injected,
        mid-admission, mid-decode, preempted) and reset the scheduler; retired results stay
        collectable. Every slot's pages return to the pool (registered
        prefix pages stay)."""
        live = [self._live[rid] for rid in sorted(self._live)]
        self._queue.clear()
        self._inject.clear()  # handed-off rows die with the replica; a router re-prefills
        self._live.clear()
        self._pending = None
        if self.paged and self.preemption:
            self._preempted.clear()
        self._slot_rid[:] = -1
        self._pos[:] = 0
        self._last_tok[:] = 0
        self._slot_accept[:] = np.nan
        if self.paged:
            for slot in range(self.n_slots):
                self._free_slot_pages(slot)
        if self._obs.enabled:
            flight_recorder.record("serving_abandon", n_requests=len(live))
            for req in live:
                if req.trace_id is not None:
                    # not a flow end: a fleet requeues them under the same trace
                    get_tracer().instant("serving_abandon", trace_id=req.trace_id, rid=req.rid,
                                         outcome="abandoned", replica=self.obs_replica)
        return live

    def collect(self) -> dict[int, list]:
        """{rid: [tokens]} for every request retired since the last collect."""
        done = {rid: req.tokens for rid, req in self._done.items()}
        self._done.clear()
        return done

    def collect_requests(self) -> dict[int, Request]:
        """:meth:`collect` with the whole :class:`Request` (tokens and time
        marks)."""
        done = dict(self._done)
        self._done.clear()
        return done

    def run(self, max_steps: int = 100_000) -> dict[int, list]:
        """Drain the queue and the slots; returns {rid: [tokens]} for every
        request retired during (or before) this call."""
        for _ in range(max_steps):
            if (not self._queue and not self._inject and self.n_active == 0
                    and self.n_pending == 0 and self.n_preempted == 0):
                break
            self.step()
        else:
            raise RuntimeError(f"serving did not drain within {max_steps} steps")
        return self.collect()
