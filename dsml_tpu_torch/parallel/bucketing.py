"""Gradient bucketing — the full-precision half of
``dsml_tpu/parallel/bucketing.py``.

Gradients are partitioned into size-targeted flat buckets and each bucket
is reduced as its own collective (``ops.collectives.all_reduce``), as
production data-parallel stacks do, instead of one ravel of the whole
gradient:

- :func:`plan_buckets` — greedy, order-preserving partition of the leaves
  into per-dtype buckets of ~``bucket_size_mb`` MiB; a leaf over the target
  gets a bucket of its own and leaves are never split.
- :func:`flatten_buckets` / :func:`unflatten_buckets` — leaves ⇄ one flat
  vector per bucket, an exact round trip.
- :func:`bucketed_all_reduce` — one collective per bucket (``ring`` /
  ``ring2`` / ``naive`` / ``auto`` / ``xla``); ``bucket_size_mb=None`` is
  one flat buffer of every leaf and a single collective.

A tree is a dict ``{dotted name: tensor}`` (``model.named_parameters()``)
or a sequence of tensors. A dict's leaves are taken in the order
``jax.tree`` flattens the JAX package's parameter tree (dict keys sorted,
list entries by index; ``models/convert.py`` maps the names), so bucket
boundaries, and with them the summation order at n > 2, equal the JAX
package's. The quantized algorithms (``q8``, ``q8_ring*``, ``q4_ring*``,
``quant``) and error feedback come with the compressed-communication slice
and raise here.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import torch

from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce

__all__ = [
    "BucketPlan",
    "QUANT_RING_ALGORITHMS",
    "bucketed_all_reduce",
    "default_bucket_mb",
    "flatten_buckets",
    "is_quantized_algorithm",
    "plan_buckets",
    "supports_error_feedback",
    "tree_order",
    "unflatten_buckets",
]

_NOT_PORTED = "comes with the compressed-communication slice (ROADMAP.md queue 1, item 10)"

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


def bucketed_all_reduce(tree, group, op: ReduceOp = ReduceOp.AVG, algorithm: str = "ring",
                        bucket_size_mb: float | None = None, error_feedback=None):
    """All-reduce ``tree`` over ``group`` as one collective per bucket,
    returning a tree of the same form (new tensors). ``algorithm`` is any
    ``ops.collectives.all_reduce`` algorithm. ``bucket_size_mb=None`` is
    the single flat buffer: every leaf raveled in tree order into one
    vector of their promoted type, one collective, unraveled."""
    op = ReduceOp(op)
    if error_feedback is not None:
        raise NotImplementedError("error_feedback " + _NOT_PORTED)
    if is_quantized_algorithm(algorithm):
        raise NotImplementedError(f"quantized sync algorithm={algorithm!r} " + _NOT_PORTED)
    names, leaves = _leaves(tree)
    if bucket_size_mb is None:
        dtype = functools.reduce(torch.promote_types, [t.dtype for t in leaves])
        flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves])
        flat = all_reduce(flat, group, op, algorithm)
        out, off = [], 0
        for t in leaves:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return _rebuild(names, out)
    plan = plan_buckets(tree, bucket_size_mb)
    reduced = [all_reduce(flat, group, op, algorithm) for flat in flatten_buckets(tree, plan)]
    return unflatten_buckets(reduced, plan)
