"""The hybrid train step — ``dsml_tpu/parallel/hybrid.py`` over every axis
of the mesh: pp × dp × fsdp × (sp or cp) × tp.

The JAX step is one jitted SPMD program over the mesh: parameters
TP-sharded (and ZeRO-sharded over fsdp, and stage-sharded over pp), the
batch rows sharded over dp × fsdp and the sequence over the sequence axis
(``sp`` or ``cp``, ``MeshSpec.seq_axis``), the loss ``pmean``-ed over
``("dp", "fsdp") + seq_names``, and the shard_map transpose assigning every
collective's cotangent. Here each rank is one process running
:func:`make_hybrid_train_step`'s ``step``:

1. it takes its share of the global batch (``P(("dp", "fsdp"),
   seq_names)``): its contiguous sequence shard on a mesh with a sequence
   axis, and of that its rows over dp then fsdp;
2. with fsdp, the ZeRO-3 shards are all-gathered into the module's weights
   (``parallel.fsdp.Zero3``, the JAX ``gather_fsdp``);
3. the loss and its gradients: ``model.loss`` (Megatron tp inside the
   model, ``parallel.tp``; every tp rank seeds its identical loss alike),
   or with pp the pipeline (``parallel.pp``: ``"gpipe"``, interleaved when
   ``config.pp_interleave > 1``, or ``"1f1b"``, over ``n_microbatches``,
   the sequence group and its position offset reaching every stage's
   blocks), whose non-layer gradients (the embedding's on stage 0, the
   head's on the last stage: the tied ``wte`` gets both) are then summed
   over the pp group, and whose loss is the last stage's; on a sequence
   axis the per-rank loss is seeded with 1/n_seq (the sequence-parallel
   attention's backward carries each rank's K/V cotangents home) and the
   gradients, replicated over the group, are summed over it;
4. the microbatch gradients summed and divided by ``grad_accum``; with
   fsdp reduce-scattered back into the shards (averaged over fsdp); then
   averaged over dp — ``dp_sync="xla"`` through the process group's own
   ``all_reduce`` of one flat buffer, an explicit algorithm (a dp-only
   mesh) through ``parallel.bucketing.bucketed_all_reduce`` once per step;
5. clip by the global norm (optax's rule; on a sharded model the squares
   of every shard, each counted once, summed over tp, pp and fsdp), then
   the optimizer on every rank: the replicas stay identical.

The JAX guards hold: ``"1f1b"`` needs pp > 1, ``pp_interleave > 1`` is
gpipe only, an explicit ``dp_sync`` needs a dp-only mesh.
:func:`hybrid_model` builds a rank's model (its tp shard and pp stage, the
layers in the interleave order) and :func:`init_hybrid` fills it and, with
fsdp, shards it.

Observability, as the JAX step writes it: every step lands a memory-ledger
peak watermark (``note_step_peak``, an allocator statistic read on the
host: no device sync); an explicit ``dp_sync`` records its bucket plan
(``obs.record_collective_plan``) once per batch signature, where the JAX
step records it once per compilation; the first step, which allocates
``torch.optim``'s state, claims the parameters (this rank's shard bytes)
and that state in the ledger (the JAX ``init_hybrid`` claims them at
initialisation: optax's state exists before the first update, torch's
after it).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dsml_tpu_torch.models.common import spec_dim
from dsml_tpu_torch.obs import record_collective_plan
from dsml_tpu_torch.obs.memory import get_memory_ledger
from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce
from dsml_tpu_torch.ops.quantization import compressed_checkpoint
from dsml_tpu_torch.parallel.bucketing import (bucketed_all_reduce, default_bucket_mb,
                                               is_quantized_algorithm)
from dsml_tpu_torch.parallel.dp import named_params, rank_rows
from dsml_tpu_torch.parallel.fsdp import Zero3, rebuild_optimizer
from dsml_tpu_torch.parallel.mesh import Mesh
from dsml_tpu_torch.parallel.pp import _check as _check_pp
from dsml_tpu_torch.parallel.pp import (_forward_ticks, pipeline_train, pipeline_train_1f1b,
                                        stage_layer_ids)

__all__ = ["default_attn_impl", "gather_fsdp", "hybrid_eval_loss", "hybrid_loss_fn",
           "hybrid_model", "init_hybrid", "make_hybrid_train_step", "shard_fsdp"]

_MP_AXES = ("pp", "fsdp", "tp")  # the model-parallel axes: their own step


def default_attn_impl(mesh: Mesh) -> str:
    """What ``attn_impl=None`` resolves to on this mesh, as in the JAX
    package: the flash ring ``"ring2"`` when cp is sized, else the XLA ring
    ``"ring"`` (on an unsharded sequence the model routes that to plain
    attention, as the JAX ``_route_attention`` does)."""
    return "ring2" if mesh.shape.get("cp", 1) > 1 else "ring"


def _seq_group(mesh: Mesh):
    """The group of the mesh's sequence axis (``MeshSpec.seq_axis``: cp or
    sp, whichever is sized), or None."""
    return mesh.group(mesh.spec.seq_axis())


def hybrid_loss_fn(model, attn_impl: str = "ring", seq_group=None):
    """Per-rank loss closure ``loss_fn(x, y)`` over this rank's sequence
    shard: positions offset by the shard origin and the rank's own
    cross-entropy, as the JAX ``hybrid_loss_fn`` with ``seq_axis``; the
    model routes ``attn_impl`` over ``seq_group`` (``GPT2._attend``)."""

    def loss_fn(x, y):
        return model.loss(x, y, attn_impl=attn_impl, sp_group=seq_group)

    return loss_fn


def _is_mp(mesh: Mesh) -> bool:
    return any(mesh.shape.get(a, 1) > 1 for a in _MP_AXES)


def hybrid_model(model_cls, config, mesh: Mesh):
    """This rank's model of ``model_cls(config)`` on ``mesh``: its tp shard
    (the mesh's ``tp`` group) and, with pp, its stage's layers in the order
    the schedule runs them (``parallel.pp.stage_layer_ids``: the JAX stacked
    axis after ``init_hybrid``'s interleave permutation), on the mesh's
    device. Weights uninitialised (:func:`init_hybrid` fills them)."""
    layer_ids = None
    if mesh.shape.get("pp", 1) > 1:
        layer_ids = stage_layer_ids(config.n_layer, mesh.shape["pp"], mesh.coord("pp"),
                                    config.pp_interleave)
    return model_cls(config, device=mesh.device, tp_group=mesh.group("tp"), layer_ids=layer_ids)


def gather_fsdp(model):
    """The rank's ZeRO-3 shards all-gathered into ``model``'s weights (the
    JAX ``gather_fsdp``); a no-op for a model :func:`init_hybrid` did not
    shard."""
    zero3 = getattr(model, "fsdp", None)
    if zero3 is not None:
        zero3.gather()


def init_hybrid(model, optimizer, mesh: Mesh, seed: int = 0):
    """Fill the weights from ``seed`` on every rank (the same seed gives the
    same weights, and each tp/pp rank keeps its shard of them:
    ``GPT2.init`` draws the whole model from numpy), then
    :func:`shard_fsdp`. Returns ``(model, optimizer)``; the parameters and
    the optimizer state are claimed in the memory ledger at this rank's
    shard bytes after the first step."""
    model.init(seed)
    return shard_fsdp(model, optimizer, mesh)


def shard_fsdp(model, optimizer, mesh: Mesh):
    """With fsdp > 1 the model's weights become ZeRO-3 shards on the first
    free divisible dim of ``model.param_specs(fsdp)`` (``parallel.fsdp.
    Zero3``, kept as ``model.fsdp``) and the optimizer is rebuilt over
    them; otherwise nothing changes. Returns ``(model, optimizer)``."""
    if mesh.shape.get("fsdp", 1) > 1:
        specs = model.param_specs(fsdp=mesh.shape["fsdp"])
        full = {model.local_name(k): spec_dim(v, "fsdp") for k, v in specs.items()}
        model.fsdp = Zero3(model, mesh.group("fsdp"), {k: v for k, v in full.items() if k})
        optimizer = rebuild_optimizer(optimizer, model.fsdp.shards)
    return model, optimizer


def _shard(t, group):
    """This rank's contiguous share of the sequence axis of ``t`` [b, S]."""
    t = torch.as_tensor(t)
    if group is None:
        return t
    s = t.shape[1]
    if s % group.size:
        raise ValueError(f"sequence {s} not divisible by the sequence axis' {group.size}")
    n = s // group.size
    return t[:, group.rank * n:(group.rank + 1) * n]


def make_hybrid_train_step(model, optimizer, mesh: Mesh, attn_impl: str | None = None,
                           grad_accum: int = 1, n_microbatches: int = 1,
                           schedule: str = "gpipe", dp_sync: str = "xla",
                           clip_norm: float = 0.0, bucket_size_mb: float | None | str = "auto"):
    """Build ``step(x, y, lr=None) -> loss`` for ``mesh``. ``x``/``y`` are
    the GLOBAL batch [batch, seq] (every rank passes the same); each rank
    trains on its sequence shard (sp or cp) of its rows (dp, fsdp). With
    ``grad_accum > 1`` the rank's batch splits into that many microbatches
    whose gradients are summed and divided by ``grad_accum`` (as the JAX
    step). ``dp_sync`` picks the dp gradient sync: ``"xla"``, the process
    group's own ``all_reduce``, or an explicit algorithm (``"ring"``,
    ``"ring2"``, ``"naive"``, ``"auto"``, or a quantized one: ``"q8"``,
    ``"q8_ring"``, ``"q8_ring2"``, ``"q4_ring"``, ``"q4_ring2"``,
    ``"quant"``) through ``bucketed_all_reduce`` with ``bucket_size_mb``
    (``"auto"`` = the ``DSML_BUCKET_MB`` default, ``None`` = one buffer),
    once per step. Error feedback is the dp step's option
    (``parallel.dp.make_dp_train_step``), as in the JAX package.
    ``clip_norm > 0`` clips the synced gradients by global norm (the JAX
    example's ``optax.chain`` puts the clip in the optimizer); ``lr`` sets
    every group's learning rate before the update. Returns the global mean
    loss (a device scalar, identical on every rank)."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "1f1b" and mesh.shape.get("pp", 1) == 1:
        raise ValueError("schedule='1f1b' requires a mesh with pp > 1")
    if schedule == "1f1b" and model.config.pp_interleave > 1:
        raise ValueError("pp_interleave > 1 composes with the gpipe schedule only")
    if dp_sync != "xla":
        busy = {a: s for a in ("pp", "fsdp", "sp", "cp", "tp") if (s := mesh.shape.get(a, 1)) > 1}
        if busy:
            raise ValueError(f"dp_sync={dp_sync!r} requires a dp-only mesh; got {busy} — "
                             "use dp_sync='xla' on multi-axis meshes")
    if _is_mp(mesh):
        return _make_mp_step(model, optimizer, mesh, attn_impl or default_attn_impl(mesh),
                             grad_accum, n_microbatches, schedule, clip_norm)
    # the loss mean is exact: a quantized name is no all_reduce algorithm
    loss_sync = "ring" if is_quantized_algorithm(dp_sync) else dp_sync
    mb = default_bucket_mb() if bucket_size_mb == "auto" else bucket_size_mb
    seq_group, dp_group = _seq_group(mesh), mesh.group("dp")
    if attn_impl is None:
        attn_impl = default_attn_impl(mesh)
    loss_fn = hybrid_loss_fn(model, attn_impl, seq_group)
    n_seq = 1 if seq_group is None else seq_group.size
    params = [p for _, p in named_params(model, optimizer)]
    ledger = get_memory_ledger()
    signatures = set()  # the batch signatures seen: where jit would trace

    def step(x, y, lr: float | None = None):
        x = rank_rows(_shard(x, seq_group), dp_group).to(model.device).long()
        y = rank_rows(_shard(y, seq_group), dp_group).to(model.device).long()
        sig = (tuple(x.shape), tuple(y.shape))
        first = sig not in signatures
        if first:
            signatures.add(sig)
            if dp_sync != "xla":
                record_collective_plan(dp_sync, params, mb, "dp")
        if x.shape[0] % grad_accum:
            raise ValueError(f"per-rank batch {x.shape[0]} not divisible by grad_accum={grad_accum}")
        micro = x.shape[0] // grad_accum
        optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for m in range(grad_accum):
            rows = slice(m * micro, (m + 1) * micro)
            micro_loss = loss_fn(x[rows], y[rows])
            # the gradient of the global mean: every rank seeds 1/n_seq, and
            # the sequence-parallel attention's backward carries each rank's
            # share home
            (micro_loss / n_seq).backward()
            loss += micro_loss.detach().float()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if seq_group is not None:
            _sum_grads(grads, seq_group)
            loss = all_reduce(loss, seq_group, ReduceOp.SUM, "ring")
        if grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
        loss = loss / (n_seq * grad_accum)
        if dp_group is not None:
            grads = bucketed_all_reduce(grads, dp_group, ReduceOp.AVG, dp_sync,
                                        None if dp_sync == "xla" else mb)
            loss = all_reduce(loss, dp_group, ReduceOp.AVG, loss_sync)
        for p, g in zip(params, grads):
            p.grad = g
        if clip_norm > 0:
            from dsml_tpu_torch.cli.train_gpt2 import clip_by_global_norm

            clip_by_global_norm(grads, clip_norm)
        if lr is not None:
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.step()
        if first and ledger.enabled:
            ledger.claim_tree("params", model, detail="hybrid")
            ledger.claim_tree("optimizer", optimizer.state, detail="hybrid")
        ledger.note_step_peak()
        return loss

    return step


def _sum_grads(grads, group) -> None:
    """Sum ``grads`` over ``group`` in place, as one flat buffer in their
    type (rank order on the CPU, the ring on CUDA)."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group, ReduceOp.SUM,
                      "xla" if grads[0].is_cpu else "ring")
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def _sum_over(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = all_reduce(flat, group, ReduceOp.SUM, "xla" if flat.is_cpu else "ring")
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _seq_offset(seq_group, s: int) -> int:
    """The global position of this rank's first row of a sequence shard of
    length ``s``."""
    return 0 if seq_group is None else seq_group.rank * s


def _pp_chunks(model, attn_impl: str, s: int, remat=False, seq_group=None) -> list:
    """This stage's chunk functions ``h -> h`` (one per interleave chunk:
    its layers in order) at sequence length ``s``, attention routed over
    ``seq_group`` at the shard's global positions (the JAX block closure's
    ``sp_axis``); ``remat=True`` recomputes each chunk in the backward and
    ``"int8"`` each layer from an int8 stash, as the JAX ``_blocks_spmd``
    does for GPipe (``"mlp"`` is inside the block)."""
    attend = model._attend(attn_impl, seq_group)
    rot = model._rotary(_seq_offset(seq_group, s), s)
    layers = list(model.layers)
    v = model.config.pp_interleave
    per_chunk = len(layers) // v

    def layer_fn(layer, h):
        return model._block(layer, h, attend, rot)

    if remat == "int8":
        layer_fn = compressed_checkpoint(layer_fn)

    def chunk(chunk_layers):
        def run(h):
            for layer in chunk_layers:
                h = layer_fn(layer, h)
            return h

        if remat is True:
            return lambda h: checkpoint(run, h, use_reentrant=False)
        return run

    return [chunk(layers[j * per_chunk:(j + 1) * per_chunk]) for j in range(v)]


def _pp_feed(model, x, y, group, n_micro: int, seq_group=None):
    """Stage 0's embedded microbatches (None elsewhere, with the embedding's
    output kept for its backward; positions from the sequence shard's
    origin), the targets by microbatch and the pipeline's ``micros_like``."""
    cfg = model.config
    b, s = x.shape
    if b % n_micro:
        raise ValueError(f"per-rank batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    micros = h = None
    if group.rank == 0:
        h = model._embed(x, _seq_offset(seq_group, s))
        micros = h.detach().view(n_micro, mb, s, cfg.d_model)
    like = (n_micro, (mb, s, cfg.d_model), cfg.torch_dtype, model.device)
    return h, micros, y.view(n_micro, mb, s), like


def _pp_loss_backward(model, x, y, group, n_micro: int, schedule: str, attn_impl: str,
                      seq_group=None):
    """This stage's share of the pipelined loss of ``x``/``y`` and its
    backward (gradients accumulate in ``.grad``): stage 0 embeds and feeds
    ``n_micro`` microbatches, the stages run ``parallel.pp``'s schedule over
    :func:`_pp_chunks` (with the config's ``remat``; attention over
    ``seq_group``), the last stage runs the head (:meth:`GPT2.head_loss`,
    seeded with 1/n_seq on a sequence group), and stage 0 pulls the feed's
    cotangent back through the embedding. Returns the loss (over n_seq) on
    the last stage, 0 elsewhere."""
    n_seq = 1 if seq_group is None else seq_group.size
    chunks = _pp_chunks(model, attn_impl, x.shape[1], model.config.remat, seq_group)
    h, micros, targets, like = _pp_feed(model, x, y, group, n_micro, seq_group)

    def head(out, tgt):
        loss = model.head_loss(out, tgt)
        return loss if n_seq == 1 else loss / n_seq

    if schedule == "1f1b":
        loss, d_micros = pipeline_train_1f1b(chunks[0], head, micros, targets, group, like)
    else:
        loss, d_micros = pipeline_train(chunks, head, micros, targets, group, like)
    if group.rank == 0:
        h.backward(d_micros.view_as(h))
    return loss


def _replication(model, mesh: Mesh, name: str) -> int:
    """How many ranks of one dp replica hold identical copies of parameter
    ``name`` (tp for a leaf tp does not shard, pp for a non-layer leaf,
    fsdp for a leaf fsdp does not shard)."""
    spec = model.param_specs(fsdp=mesh.shape.get("fsdp", 1))[_global_name(model, name)]
    n = 1
    if "tp" not in spec:
        n *= mesh.shape.get("tp", 1)
    if not name.startswith("layers."):
        n *= mesh.shape.get("pp", 1)
    if "fsdp" not in spec:
        n *= mesh.shape.get("fsdp", 1)
    return n


def _global_name(model, name: str) -> str:
    if not name.startswith("layers."):
        return name
    _, pos, rest = name.split(".", 2)
    return f"layers.{model.layer_ids[int(pos)]}.{rest}"


def _make_mp_step(model, optimizer, mesh: Mesh, attn_impl: str, grad_accum: int,
                  n_micro: int, schedule: str, clip_norm: float):
    """The step on a mesh with a sized pp, fsdp or tp axis (see the module
    docstring), and a sequence axis beside them."""
    pp_group, dp_group = mesh.group("pp"), mesh.group("dp")
    fsdp_group, seq_group = mesh.group("fsdp"), _seq_group(mesh)
    n_seq = 1 if seq_group is None else seq_group.size
    zero3 = getattr(model, "fsdp", None)
    if fsdp_group is not None and zero3 is None:
        raise ValueError("an fsdp mesh needs the ZeRO-3 shards of init_hybrid")
    named = named_params(model)
    layer_params = [p for n, p in named if n.startswith("layers.")]
    head_params = [p for n, p in named if not n.startswith("layers.")]
    if zero3 is not None:
        by_id = {id(p): s for _, p, _, s in zero3.entries}
        targets = [(n, by_id[id(p)]) for n, p in named]
    else:
        targets = named
    weights = None  # each target's 1/copies in a replica, for the clip's norm
    ledger = get_memory_ledger()
    first = True

    def step(x, y, lr: float | None = None):
        nonlocal weights, first
        x, y = _shard(x, seq_group), _shard(y, seq_group)
        for g in (dp_group, fsdp_group):
            x, y = rank_rows(x, g), rank_rows(y, g)
        x, y = x.to(model.device).long(), y.to(model.device).long()
        if x.shape[0] % grad_accum:
            raise ValueError(f"per-rank batch {x.shape[0]} not divisible by grad_accum={grad_accum}")
        gather_fsdp(model)
        for _, p in named:
            p.grad = None
        micro = x.shape[0] // grad_accum
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for m in range(grad_accum):
            rows = slice(m * micro, (m + 1) * micro)
            if pp_group is not None:
                loss += _pp_loss_backward(model, x[rows], y[rows], pp_group, n_micro, schedule,
                                          attn_impl, seq_group)
            else:
                micro_loss = model.loss(x[rows], y[rows], attn_impl=attn_impl,
                                        sp_group=seq_group)
                if n_seq > 1:
                    micro_loss = micro_loss / n_seq  # the global mean's seed
                micro_loss.backward()
                loss += micro_loss.detach().float()
        for p in layer_params + head_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if pp_group is not None:
            # the embedding's gradient lives on stage 0, the head's on the
            # last stage: the one tied wte sums both
            _sum_over([p.grad for p in head_params], pp_group)
            loss = all_reduce(loss, pp_group, ReduceOp.SUM, "xla" if loss.is_cpu else "ring")
        if grad_accum > 1:
            torch._foreach_div_([p.grad for p in layer_params + head_params], grad_accum)
        loss = loss / grad_accum
        if zero3 is not None:
            zero3.scatter_grads()
            loss = all_reduce(loss, fsdp_group, ReduceOp.AVG, "xla" if loss.is_cpu else "ring")
        if seq_group is not None:
            # every parameter is replicated over the sequence axis: its
            # ranks' shares sum to the gradient of the global mean
            _sum_grads([t.grad for _, t in targets], seq_group)
            loss = all_reduce(loss, seq_group, ReduceOp.SUM, "xla" if loss.is_cpu else "ring")
        grads = [t.grad for _, t in targets]
        if dp_group is not None:
            grads = bucketed_all_reduce(grads, dp_group, ReduceOp.AVG, "xla", None)
            loss = all_reduce(loss, dp_group, ReduceOp.AVG, "xla" if loss.is_cpu else "ring")
        for (_, t), g in zip(targets, grads):
            t.grad = g
        if clip_norm > 0:
            if weights is None:
                weights = [1.0 / _replication(model, mesh, n) for n, _ in targets]
            _clip_sharded(grads, weights, clip_norm, mesh)
        if lr is not None:
            for g in optimizer.param_groups:
                g["lr"] = lr
        optimizer.step()
        if first and ledger.enabled:
            ledger.claim_tree("params", [t for _, t in targets], detail="hybrid")
            ledger.claim_tree("optimizer", optimizer.state, detail="hybrid")
        first = False
        ledger.note_step_peak()
        return loss

    return step


@torch.no_grad()
def _clip_sharded(grads, weights, max_norm: float, mesh: Mesh) -> None:
    """optax's ``clip_by_global_norm`` over a sharded model: each rank's
    squares weighted by 1/(copies in the replica), summed over tp, pp and
    fsdp — every element of the logical gradient counted once — then every
    shard scaled by ``max_norm / norm`` when the norm reaches ``max_norm``."""
    sq = sum(w * g.float().square().sum() for g, w in zip(grads, weights))
    sq = sq.reshape(1)
    for axis in ("tp", "pp", "fsdp"):
        group = mesh.group(axis)
        if group is not None:
            sq = all_reduce(sq, group, ReduceOp.SUM, "xla" if sq.is_cpu else "ring")
    norm = torch.sqrt(sq[0])
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


@torch.no_grad()
def _pp_eval_loss(model, x, y, group, n_micro: int, attn_impl: str,
                  seq_group=None) -> torch.Tensor:
    """The pipelined forward alone (``parallel.pp``'s forward ticks, GPipe
    or interleaved as the model's ``pp_interleave`` says, no graph kept)
    over ``n_micro`` microbatches, the head over all of them on the last
    stage: the loss there, 0 elsewhere."""
    _check_pp(group.size, n_micro, model.config.pp_interleave)
    chunks = _pp_chunks(model, attn_impl, x.shape[1], seq_group=seq_group)
    _, micros, targets, like = _pp_feed(model, x, y, group, n_micro, seq_group)
    _, outputs = _forward_ticks(chunks, like, micros, group, len(chunks), False)
    if group.rank != group.size - 1:
        return torch.zeros((), dtype=torch.float32, device=model.device)
    out = torch.cat([outputs[m] for m in range(n_micro)])
    return model.head_loss(out, targets.reshape(-1, targets.shape[2])).float()


@torch.no_grad()
def hybrid_eval_loss(model, mesh: Mesh, attn_impl: str, x, y,
                     n_microbatches: int = 1) -> torch.Tensor:
    """The global mean loss of the batch ``x``/``y`` [batch, seq] with no
    update (the JAX example's eval: ``pmean`` of ``hybrid_loss_fn`` over the
    batch and sequence axes): every rank's loss over its sequence shard
    (sp or cp) of its rows (dp × fsdp), averaged over those groups. With fsdp the
    weights are the gathered ZeRO-3 shards (:func:`gather_fsdp`), released
    again after the forward; with pp the loss is the pipelined forward over
    ``n_microbatches`` microbatches (:func:`_pp_eval_loss`), summed over the
    stages (the JAX masked-head psum). Returns a device scalar, identical on
    every rank."""
    seq_group, dp_group = _seq_group(mesh), mesh.group("dp")
    pp_group, fsdp_group = mesh.group("pp"), mesh.group("fsdp")
    x, y = _shard(x, seq_group), _shard(y, seq_group)
    for g in (dp_group, fsdp_group):
        x, y = rank_rows(x, g), rank_rows(y, g)
    x, y = x.to(model.device).long(), y.to(model.device).long()
    gather_fsdp(model)
    try:
        if pp_group is not None:
            loss = _pp_eval_loss(model, x, y, pp_group, n_microbatches, attn_impl, seq_group)
            loss = all_reduce(loss, pp_group, ReduceOp.SUM, "xla" if loss.is_cpu else "ring")
        else:
            loss = hybrid_loss_fn(model, attn_impl, seq_group)(x, y).float()
    finally:
        zero3 = getattr(model, "fsdp", None)
        if zero3 is not None:
            zero3.release()
    for group in (seq_group, fsdp_group, dp_group):
        if group is not None:
            loss = all_reduce(loss, group, ReduceOp.AVG, "xla" if loss.is_cpu else "ring")
    return loss
