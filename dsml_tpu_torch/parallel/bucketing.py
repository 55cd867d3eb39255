"""Gradient bucketing — the counterpart of ``dsml_tpu/parallel/bucketing.py``.

Gradients are partitioned into size-targeted flat buckets and each bucket
is reduced as its own collective, as production data-parallel stacks do,
instead of one ravel of the whole gradient:

- :func:`plan_buckets` — greedy, order-preserving partition of the leaves
  into per-dtype buckets of ~``bucket_size_mb`` MiB; a leaf over the target
  gets a bucket of its own and leaves are never split.
- :func:`flatten_buckets` / :func:`unflatten_buckets` — leaves ⇄ one flat
  vector per bucket, an exact round trip.
- :func:`bucketed_all_reduce` — one collective per bucket: ``ring`` /
  ``ring2`` / ``naive`` / ``auto`` / ``xla`` through
  ``ops.collectives.all_reduce``; ``q8`` through
  ``ops.quantization.compressed_all_reduce`` (kernel 8 quantizes each
  float bucket on the card); the block-quantized ring family ``q8_ring``
  / ``q8_ring2`` / ``q4_ring`` / ``q4_ring2`` through
  ``ops.quantization.quantized_ring_all_reduce``; ``quant`` resolves the
  scheme per bucket dtype from ``DSML_QUANT``. ``bucket_size_mb=None`` is
  one flat buffer of every leaf and a single collective.
- **Error feedback**: with ``error_feedback=`` (this rank's f32 residuals
  from :func:`init_error_feedback`) a ring-family sync runs on ``grads +
  residual`` under deterministic rounding and also returns the new
  residual, ``adjusted − roundtrip(adjusted)``, so what the compressor
  dropped is offered again next step.

A tree is a dict ``{dotted name: tensor}`` (``model.named_parameters()``)
or a sequence of tensors. A dict's leaves are taken in the order
``jax.tree`` flattens the JAX package's parameter tree (dict keys sorted,
list entries by index; ``models/convert.py`` maps the names), so bucket
boundaries, and with them the summation order at n > 2, equal the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import torch

from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce, ring_wire_bytes
from dsml_tpu_torch.ops.quantization import (_leaf_seed, _roundtrip_residual, _wrap_i32,
                                             compressed_all_reduce, compressed_gather_wire_bytes,
                                             quant_algorithm_for, quantized_ring_all_reduce,
                                             quantized_ring_wire_bytes)

__all__ = [
    "BucketPlan",
    "QUANT_RING_ALGORITHMS",
    "bucketed_all_reduce",
    "default_bucket_mb",
    "flatten_buckets",
    "init_error_feedback",
    "is_quantized_algorithm",
    "plan_buckets",
    "plan_quant_wire_bytes",
    "supports_error_feedback",
    "tree_order",
    "unflatten_buckets",
]

# the block-quantized ring family: algorithm name -> (scheme, bidirectional)
QUANT_RING_ALGORITHMS = {
    "q8_ring": ("int8", False),
    "q8_ring2": ("int8", True),
    "q4_ring": ("int4", False),
    "q4_ring2": ("int4", True),
}


def is_quantized_algorithm(algorithm: str) -> bool:
    """True for every compressed sync: ``q8``, the ring family, ``quant``."""
    return algorithm in ("q8", "quant") or algorithm in QUANT_RING_ALGORITHMS


def supports_error_feedback(algorithm: str) -> bool:
    """Error feedback pairs with the deterministic-rounding ring family (and
    ``quant``, which resolves into it)."""
    return algorithm == "quant" or algorithm in QUANT_RING_ALGORITHMS


def _resolve_quant(algorithm: str, dtype) -> str:
    """``"quant"`` resolved for a bucket of ``dtype`` through
    ``DSML_QUANT``; every other name as it is. The result may be a plain
    ``"ring"``/``"ring2"`` (``DSML_QUANT=none``): that bucket then syncs
    at full precision."""
    return quant_algorithm_for(dtype) if algorithm == "quant" else algorithm


def default_bucket_mb() -> float:
    """4 MiB, or ``DSML_BUCKET_MB`` when that is a positive number (a
    malformed or non-positive value falls back; "no bucketing" is
    ``bucket_size_mb=None`` at the call site)."""
    try:
        mb = float(os.environ.get("DSML_BUCKET_MB", 4.0))
    except ValueError:
        return 4.0
    return mb if mb > 0 else 4.0


def _path_key(name: str):
    # list indices compare as numbers, dict keys as strings
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split("."))


def tree_order(names) -> list[str]:
    """``names`` (dotted paths) in the order ``jax.tree`` flattens the
    nested dicts and lists they name."""
    return sorted(names, key=_path_key)


def _leaves(tree):
    """(names or None, tensors in tree order)."""
    if isinstance(tree, dict):
        names = tree_order(tree)
        return names, [tree[k] for k in names]
    return None, list(tree)


def _rebuild(names, leaves):
    return dict(zip(names, leaves)) if names is not None else leaves


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static partition of a tree's leaves into flat buckets."""

    names: tuple | None  # leaf names in tree order (None for a sequence)
    shapes: tuple  # per-leaf shapes
    dtypes: tuple  # per-leaf dtypes
    buckets: tuple  # tuple of tuples of leaf indices, order-preserving

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_nbytes(self, b: int) -> int:
        return sum(_numel(self.shapes[i]) * self.dtypes[i].itemsize for i in self.buckets[b])


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def plan_buckets(tree, bucket_size_mb: float) -> BucketPlan:
    """Partition ``tree``'s leaves into per-dtype buckets of
    ~``bucket_size_mb`` MiB, greedy in leaf order: each dtype keeps one
    open bucket; a leaf joins it while the bucket is under the target and
    the leaf alone is too, else it opens a new one (so an over-target leaf
    always sits alone)."""
    names, leaves = _leaves(tree)
    shapes = tuple(tuple(t.shape) for t in leaves)
    dtypes = tuple(t.dtype for t in leaves)
    target = max(float(bucket_size_mb), 1e-6) * (1 << 20)
    open_bucket: dict = {}  # dtype -> [leaf indices, bytes so far]
    buckets: list = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        nbytes = _numel(shape) * dtype.itemsize
        if nbytes < target and dtype in open_bucket and open_bucket[dtype][1] < target:
            open_bucket[dtype][0].append(i)
            open_bucket[dtype][1] += nbytes
        else:
            open_bucket[dtype] = [[i], nbytes]
            buckets.append(open_bucket[dtype][0])
    return BucketPlan(None if names is None else tuple(names), shapes, dtypes,
                      tuple(tuple(b) for b in buckets))


def flatten_buckets(tree, plan: BucketPlan) -> list[torch.Tensor]:
    """One flat vector per bucket: its leaves raveled and concatenated in
    plan order (a single-leaf bucket is a view of its leaf)."""
    _, leaves = _leaves(tree)
    out = []
    for idxs in plan.buckets:
        if len(idxs) == 1:
            out.append(leaves[idxs[0]].reshape(-1))
        else:
            out.append(torch.cat([leaves[i].reshape(-1) for i in idxs]))
    return out


def unflatten_buckets(flat_buckets: Sequence[torch.Tensor], plan: BucketPlan):
    """Exact inverse of :func:`flatten_buckets`: each leaf a view of its
    bucket, cast back to the plan's dtype; a dict for a named plan, else a
    list."""
    leaves: list = [None] * len(plan.shapes)
    for idxs, flat in zip(plan.buckets, flat_buckets):
        off = 0
        for i in idxs:
            n = _numel(plan.shapes[i])
            leaves[i] = flat[off:off + n].view(plan.shapes[i]).to(plan.dtypes[i])
            off += n
    return _rebuild(plan.names, leaves)


def _q8_bucket_seed(flat: torch.Tensor, bucket_index: int) -> torch.Tensor:
    """The data-dependent dither seed of one bucket, in int32 arithmetic:
    the sum of its f32 bitcasts (it changes every step with the
    gradients, so rounding directions do not repeat) + ``bucket_index ·
    7919`` (identical buckets do not share noise). A device tensor."""
    return _wrap_i32(_leaf_seed(flat).long() + bucket_index * 7919)


def _ef_plan(plan: BucketPlan) -> BucketPlan:
    """The residuals' plan: the same partition, every leaf f32 (a bf16
    run's correction is not itself truncated)."""
    return dataclasses.replace(plan, dtypes=tuple(torch.float32 for _ in plan.dtypes))


def init_error_feedback(tree):
    """Zero error-feedback residuals for ``tree``'s gradients: one f32
    tensor per leaf, in ``tree``'s form (a dict or a list), on the leaf's
    device. They are this rank's own state (each rank's compression error
    is its own), held by this rank's process: the JAX package's ``[n,
    *shape]`` array sharded over the axis has no counterpart here."""
    names, leaves = _leaves(tree)
    return _rebuild(names, [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                            for t in leaves])


def plan_quant_wire_bytes(plan: BucketPlan, n_ranks: int, algorithm: str) -> dict:
    """Per-rank wire bytes of one sync of ``plan`` under a quantized
    ``algorithm``, by scheme: ``{"int8" | "int4" | "fp32": bytes}``
    (buckets that ride the full-precision ring, integer ones or those
    ``DSML_QUANT=none`` resolves, count under ``"fp32"`` at their own
    item size). Exact: it follows from the shapes alone."""
    out: dict = {}
    for b, idxs in enumerate(plan.buckets):
        dtype = plan.dtypes[idxs[0]]
        n_elems = sum(_numel(plan.shapes[i]) for i in idxs)
        resolved = _resolve_quant(algorithm, dtype)
        if resolved in QUANT_RING_ALGORITHMS and dtype.is_floating_point:
            scheme, bidir = QUANT_RING_ALGORITHMS[resolved]
            nbytes = quantized_ring_wire_bytes(n_elems, n_ranks, scheme, bidir)
        elif resolved == "q8" and dtype.is_floating_point:
            scheme, nbytes = "int8", compressed_gather_wire_bytes(n_elems, n_ranks)
        else:
            scheme, nbytes = "fp32", ring_wire_bytes(n_elems, n_ranks, dtype.itemsize)
        out[scheme] = out.get(scheme, 0) + nbytes
    return out


def _quant_ring_bucket(flat, group, op, resolved, ef_bucket, bucket_index):
    """One float bucket through the quantized ring → (reduced, new
    residual or None). Without a residual: stochastic rounding seeded by
    the bucket's own bits. With one: the ring runs on ``flat + residual``
    under deterministic rounding, and the new residual is what the first
    quantization of that sum drops."""
    scheme, bidir = QUANT_RING_ALGORITHMS[resolved]
    mean = op == ReduceOp.AVG
    if ef_bucket is None:
        out = quantized_ring_all_reduce(flat, group, scheme, bidir, mean, stochastic=True,
                                        seed=_q8_bucket_seed(flat, bucket_index))
        return out, None
    adjusted = flat.float() + ef_bucket
    out = quantized_ring_all_reduce(adjusted, group, scheme, bidir, mean, stochastic=False)
    return out.to(flat.dtype), _roundtrip_residual(adjusted, scheme)


def _single_buffer(leaves, group, op, algorithm):
    """Every leaf raveled in tree order into one vector of their promoted
    type, one collective, unraveled (the JAX ``ravel_pytree`` path)."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in leaves])
    flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves])
    if algorithm == "q8":
        if flat.element_size() < 4:
            # the JAX package bitcasts the raveled vector to int32 for its
            # seed, which a 16-bit vector cannot be: it raises, and so does
            # the port (the bucketed q8 path casts to f32 first)
            raise ValueError(f"the single-buffer q8 sync cannot seed a {dtype} vector "
                             "(bitcast to int32); give bucket_size_mb")
        flat = compressed_all_reduce(flat, group, seed=_wrap_i32(flat.view(torch.int32).sum()),
                                     mean=op == ReduceOp.AVG)
    else:
        resolved = _resolve_quant(algorithm, dtype)
        if resolved in QUANT_RING_ALGORITHMS:
            flat, _ = _quant_ring_bucket(flat, group, op, resolved, None, 0)
        else:
            flat = all_reduce(flat, group, op, resolved)
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def bucketed_all_reduce(tree, group, op: ReduceOp = ReduceOp.AVG, algorithm: str = "ring",
                        bucket_size_mb: float | None = None, error_feedback=None):
    """All-reduce ``tree`` over ``group`` as one collective per bucket,
    returning a tree of the same form (new tensors).

    ``algorithm`` is any ``ops.collectives.all_reduce`` algorithm, ``"q8"``
    (the int8 gather), a ring-family name (``"q8_ring"``, ``"q8_ring2"``,
    ``"q4_ring"``, ``"q4_ring2"``) or ``"quant"`` (per bucket dtype from
    ``DSML_QUANT``). Quantized syncs take SUM or AVG only; integer buckets
    ride the full-precision ring, exact. ``bucket_size_mb=None`` is the
    single flat buffer (a bf16 or f16 tree under ``"q8"`` raises there,
    as in the JAX package).

    ``error_feedback``: this rank's residuals (:func:`init_error_feedback`,
    in ``tree``'s form) for a ring-family algorithm or ``"quant"``; the
    return is then ``(reduced tree, new residuals)``. Under it
    ``bucket_size_mb=None`` means per-dtype buckets, and a float bucket
    that ``DSML_QUANT=none`` leaves unquantized syncs ``grads + residual``
    exactly and zeroes its residual."""
    op = ReduceOp(op)
    if is_quantized_algorithm(algorithm) and op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"quantized sync ({algorithm}) supports SUM/AVG, got {op!r}")
    if error_feedback is not None and not supports_error_feedback(algorithm):
        raise ValueError(f"error_feedback requires a quantized ring algorithm "
                         f"({sorted(QUANT_RING_ALGORITHMS)} or 'quant'), got {algorithm!r}")
    names, leaves = _leaves(tree)
    if bucket_size_mb is None and error_feedback is None:
        return _rebuild(names, _single_buffer(leaves, group, op, algorithm))
    plan = plan_buckets(tree, bucket_size_mb if bucket_size_mb is not None else float("inf"))
    ef_buckets = None if error_feedback is None else flatten_buckets(error_feedback, plan)
    reduced, new_ef = [], []
    for b, flat in enumerate(flatten_buckets(tree, plan)):
        is_float = flat.is_floating_point()
        resolved = _resolve_quant(algorithm, flat.dtype)
        if algorithm == "q8" and is_float:
            out = compressed_all_reduce(flat, group, seed=_q8_bucket_seed(flat, b),
                                        mean=op == ReduceOp.AVG)
        elif resolved in QUANT_RING_ALGORITHMS and is_float:
            ef_b = None if ef_buckets is None else ef_buckets[b]
            out, ef_out = _quant_ring_bucket(flat, group, op, resolved, ef_b, b)
            if ef_buckets is not None:
                new_ef.append(ef_out)
        else:
            # integer buckets ride the plain ring; a float bucket that
            # resolved to full precision takes that algorithm
            fallback = resolved if not is_quantized_algorithm(resolved) else "ring"
            if ef_buckets is not None and is_float:
                # an exact exchange delivers what the compressor still owed
                out = all_reduce(flat.float() + ef_buckets[b], group, op, fallback).to(flat.dtype)
                new_ef.append(torch.zeros_like(ef_buckets[b]))
            else:
                out = all_reduce(flat, group, op, fallback)
                if ef_buckets is not None:
                    new_ef.append(ef_buckets[b])  # an integer bucket's stays zero
        reduced.append(out)
    result = unflatten_buckets(reduced, plan)
    if error_feedback is not None:
        return result, unflatten_buckets(new_ef, _ef_plan(plan))
    return result
