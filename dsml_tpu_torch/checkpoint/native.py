"""Native checkpoint format: per-leaf binary piece files + a JSON manifest —
the counterpart of ``dsml_tpu/checkpoint/native.py``, and the same format
on disk: a checkpoint either package writes restores in the other, each
leaf bit for bit (the same tree paths, shapes, dtype names, piece indices
and piece bytes).

- **Trees**: nested dicts (keys sorted), lists and tuples (by index) of
  tensors, numpy arrays and scalars, flattened in the order
  ``jax.tree_util`` flattens the same containers, paths joined with
  ``/``. ``None`` is an empty node, as in JAX. The piece files are named
  ``L{leaf index:05d}_P{piece index:03d}.bin`` after that order, so they
  carry the JAX package's names for the same tree.
- **Leaves**: Python scalars and strings and numpy scalars ride the
  manifest inline; tensors (0-d ones too) and numpy
  arrays become pieces of raw little-endian bytes. A bf16 tensor is
  written as its 16 bits under the dtype name ``"bfloat16"`` and read back
  by that name into ``torch.bfloat16`` (numpy has no bfloat16 of its own).
- **Ranks**: with ``world`` > 1 every rank calls :func:`snapshot` and
  :func:`commit` for the same step. A :class:`RankShard` leaf is one row
  per rank of an ``[n, *shape]`` array sharded over the dp axis (the
  error-feedback residuals' JAX layout): every rank writes its own piece,
  and a restore on rank r reads row r only. Every other leaf is
  replicated: the manifest lists its one piece and rank 0 writes it.
  A :class:`FlatShard` leaf is one rank's contiguous segment of a flat
  1-D leaf sharded over the fsdp axis (ZeRO-2's moment buckets, the JAX
  ``init_zero2`` layout): every rank writes its segment as one piece, and a
  restore reassembles the buckets, re-pads them to the template's width and
  keeps the rank's segment.
  A :class:`MeshShard` leaf is one rank's block of a global leaf laid out
  over a process mesh (the JAX package's ``NamedSharding`` leaf of the
  ``init_hybrid`` tree: tp-sharded dims, the stacked pp layer axis, fsdp
  shards): the manifest lists every distinct block of the layout, in the
  JAX package's order, the lowest rank holding a block writes it, and a
  restore into a ``MeshShard`` template reads the rank's block back from
  whatever pieces the checkpoint holds (those of any mesh, or one whole
  piece), touching only the bytes of the block.
  ``commit`` waits on a barrier for every rank's pieces before rank 0
  writes the manifest and publishes the step.
- **Atomic**: files land in ``.tmp.step_N`` (fsynced, the manifest last)
  and one ``os.replace`` publishes ``step_N``: a step directory is visible
  iff it is complete.
- **Async-friendly**: :func:`snapshot` copies every piece to host memory
  (a real copy: an in-place update after it returns cannot reach the
  checkpoint) and :func:`commit` does the disk I/O, on any thread.

Restore resizing rule (the ZeRO-2 cross-width path, as in JAX): a 1-D leaf
saved sharded over a mesh axis may restore into a template of another 1-D
size — a smaller size trims verified zero padding, a larger one appends
zeros. Any other shape mismatch is an error.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from dsml_tpu_torch.utils.dtypes import DTYPE_NAMES
from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["FlatShard", "MeshShard", "RankShard", "Snapshot", "commit", "read_manifest",
           "restore_tree", "snapshot", "step_dirname", "tree_leaves_with_path"]

log = get_logger("checkpoint.native")

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp."


def step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):08d}"


def parse_step_dirname(name: str) -> int | None:
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


@dataclasses.dataclass
class RankShard:
    """Row ``rank`` of an ``[n, *tensor.shape]`` leaf sharded over the dp
    axis: the layout of state that is each rank's own (the JAX package
    keeps it as one array sharded ``P("dp")``). As a template leaf it
    restores this rank's row, as a tensor like ``tensor``."""

    tensor: torch.Tensor
    rank: int
    n: int


@dataclasses.dataclass
class FlatShard:
    """Segment ``rank`` of a flat leaf of ``n · len(tensor)`` elements
    sharded over ``axis`` (the JAX ``P(axis)`` of a ZeRO-2 bucket). As a
    template leaf it restores this rank's segment of the saved leaf, after
    the 1-D resize rule brings it to ``n · len(tensor)``."""

    tensor: torch.Tensor
    rank: int
    n: int
    axis: str = "fsdp"


@dataclasses.dataclass
class MeshShard:
    """This rank's block ``tensor`` of a global leaf of ``shape`` over a
    process mesh: ``index`` is the block's ``[[start, stop], ...]``,
    ``pieces`` every distinct block of the layout in the order the JAX
    package numbers them (sorted by index), ``owner`` whether this rank
    writes its block (it is the lowest rank holding it) and ``sharding``
    the manifest's description of the layout. As a template leaf it
    restores this rank's block, as a tensor like ``tensor``."""

    tensor: torch.Tensor
    shape: tuple
    index: list
    pieces: list
    owner: bool
    sharding: dict | None = None


# ---------------------------------------------------------------------------
# trees / dtypes
# ---------------------------------------------------------------------------


def _children(node):
    """(key, child) pairs of a container in JAX's flatten order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple: fields in order
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` of ``tree`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out += tree_leaves_with_path(child, f"{prefix}/{key}" if prefix else str(key))
    return out


def _map_tree(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (containers
    rebuilt as their own type)."""
    if tree is None:
        return None
    children = _children(tree)
    if children is None:
        return fn(prefix, tree)
    mapped = [(k, _map_tree(fn, c, f"{prefix}/{k}" if prefix else str(k))) for k, c in children]
    if isinstance(tree, dict):
        return dict(mapped)
    if hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in mapped))
    return type(tree)(v for _, v in mapped)


def _torch_dtype_name(dt: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dt]
    except KeyError:
        raise ValueError(f"no checkpoint dtype name for {dt}") from None


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, bf16 as its 16 bits (int16). The copy
    is real on every device: ``Tensor.cpu()`` of a CPU tensor would return
    the same storage."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _raw_dtype(name: str) -> np.dtype:
    """The numpy dtype a piece of dtype ``name`` is read as."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"checkpoint dtype {name!r} has no reader in this package") from None


def _is_inline(leaf) -> bool:
    return isinstance(leaf, (bool, int, float, str, np.generic))


# ---------------------------------------------------------------------------
# snapshot (host copy) — the synchronous half of an async save
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Snapshot:
    """Host image of one checkpoint on this rank: the manifest and the
    pieces this rank writes. Safe to commit from another thread."""

    manifest: dict
    blobs: list  # [(relative filename, np.ndarray)]
    world: int = 1
    rank: int = 0


def _full_index(shape) -> list:
    return [[0, int(n)] for n in shape]


def snapshot(state: Any, step: int, extra: dict | None = None, rank: int = 0,
             world: int = 1) -> Snapshot:
    """Copy this rank's pieces of ``state`` to host memory and lay out the
    manifest (identical on every rank). Returns before any disk I/O."""
    entries: list[dict] = []
    blobs: list[tuple[str, np.ndarray]] = []
    for li, (path, leaf) in enumerate(tree_leaves_with_path(state)):
        if _is_inline(leaf):
            value = leaf.item() if isinstance(leaf, np.generic) else leaf
            entries.append({"path": path, "inline": value, "kind": type(value).__name__})
            continue
        if isinstance(leaf, RankShard):
            t = leaf.tensor
            shape = [leaf.n, *t.shape]
            pieces = [{"file": f"L{li:05d}_P{r:03d}.bin",
                       "index": [[r, r + 1], *_full_index(t.shape)]} for r in range(leaf.n)]
            entries.append({
                "path": path, "shape": shape, "dtype": _torch_dtype_name(t.dtype),
                "sharding": {"spec": [["dp"]], "mesh_axes": ["dp"], "mesh_shape": [leaf.n]},
                "pieces": pieces,
            })
            blobs.append((pieces[leaf.rank]["file"], _host_array(t)[None]))
            continue
        if isinstance(leaf, FlatShard):
            t = leaf.tensor
            seg = t.shape[0]
            pieces = [{"file": f"L{li:05d}_P{r:03d}.bin", "index": [[r * seg, (r + 1) * seg]]}
                      for r in range(leaf.n)]
            entries.append({
                "path": path, "shape": [leaf.n * seg], "dtype": _torch_dtype_name(t.dtype),
                "sharding": {"spec": [[leaf.axis]], "mesh_axes": [leaf.axis],
                             "mesh_shape": [leaf.n]},
                "pieces": pieces,
            })
            blobs.append((pieces[leaf.rank]["file"], _host_array(t)))
            continue
        if isinstance(leaf, MeshShard):
            pieces = [{"file": f"L{li:05d}_P{pi:03d}.bin", "index": idx}
                      for pi, idx in enumerate(leaf.pieces)]
            entries.append({"path": path, "shape": list(leaf.shape),
                            "dtype": _torch_dtype_name(leaf.tensor.dtype),
                            "sharding": leaf.sharding, "pieces": pieces})
            if leaf.owner:
                blobs.append((pieces[leaf.pieces.index(leaf.index)]["file"],
                              _host_array(leaf.tensor)))
            continue
        if isinstance(leaf, torch.Tensor):
            shape, dtype = list(leaf.shape), _torch_dtype_name(leaf.dtype)
            arr = _host_array(leaf) if rank == 0 else None
        else:
            arr = np.array(leaf)  # a host copy (numpy arrays, Python lists)
            shape, dtype = list(arr.shape), arr.dtype.name
        fn = f"L{li:05d}_P000.bin"
        entries.append({"path": path, "shape": shape, "dtype": dtype, "sharding": None,
                        "pieces": [{"file": fn, "index": _full_index(shape)}]})
        if rank == 0:  # a replicated leaf: the lowest rank owns its piece
            blobs.append((fn, arr))
    manifest = {"format": FORMAT_VERSION, "step": int(step), "leaves": entries,
                "extra": dict(extra or {})}
    return Snapshot(manifest=manifest, blobs=blobs, world=int(world), rank=int(rank))


# ---------------------------------------------------------------------------
# commit (disk) — runs on the async writer thread
# ---------------------------------------------------------------------------


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # platforms without directory fsync
        pass


def commit(directory: str, snap: Snapshot, barrier=None) -> str:
    """Write ``snap`` under ``directory`` and atomically publish it as
    ``step_<N>``: everything lands in ``.tmp.step_<N>`` first (the manifest
    last) and only the final ``os.replace`` makes the step visible. With
    ``snap.world`` > 1, ``barrier()`` (a barrier over every rank) runs
    after this rank's pieces and again after rank 0 published."""
    step = snap.manifest["step"]
    final = os.path.join(directory, step_dirname(step))
    tmp = os.path.join(directory, _TMP_PREFIX + step_dirname(step))
    multi = snap.world > 1
    if multi and barrier is None:
        raise ValueError(f"a checkpoint of {snap.world} ranks needs a barrier over them")
    if os.path.isdir(tmp) and not multi:
        shutil.rmtree(tmp)  # stale leftover from a crashed writer
    os.makedirs(tmp, exist_ok=True)
    for fn, arr in snap.blobs:
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
            f.flush()
            os.fsync(f.fileno())
    if multi:
        barrier()  # every rank's pieces are down before rank 0 publishes
        if snap.rank != 0:
            barrier()
            return final
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(snap.manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)  # re-save of the same step
    os.replace(tmp, final)
    _fsync_dir(directory)
    if multi:
        barrier()
    log.info("committed checkpoint step %d -> %s", step, final)
    return final


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def read_manifest(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def _read_piece(ckpt_dir: str, entry: dict, piece: dict) -> np.ndarray:
    sub_shape = tuple(b - a for a, b in piece["index"])
    raw = np.fromfile(os.path.join(ckpt_dir, piece["file"]), dtype=_raw_dtype(entry["dtype"]))
    expect = int(np.prod(sub_shape)) if sub_shape else 1
    if raw.size != expect:
        raise ValueError(
            f"checkpoint piece {piece['file']} for {entry['path']!r} has "
            f"{raw.size} elements, expected {expect} — truncated file?"
        )
    return raw.reshape(sub_shape)


def _assemble(ckpt_dir: str, entry: dict) -> np.ndarray:
    """Full host array for one manifest entry, reassembled from its pieces
    (bf16 as its int16 bits)."""
    out = np.empty(tuple(entry["shape"]), _raw_dtype(entry["dtype"]))
    for piece in entry["pieces"]:
        out[tuple(slice(a, b) for a, b in piece["index"])] = _read_piece(ckpt_dir, entry, piece)
    return out


def _read_region(ckpt_dir: str, entry: dict, index: list) -> np.ndarray:
    """The block ``index`` (``[[start, stop], ...]``) of a saved leaf, read
    from the parts of its pieces that overlap it (memory-mapped: only the
    block's bytes are read)."""
    dtype = _raw_dtype(entry["dtype"])
    out = np.empty([b - a for a, b in index], dtype)
    filled = 0
    for piece in entry["pieces"]:
        lo = [max(a, pa) for (a, _), (pa, _) in zip(index, piece["index"])]
        hi = [min(b, pb) for (_, b), (_, pb) in zip(index, piece["index"])]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        sub_shape = tuple(b - a for a, b in piece["index"])
        if not sub_shape:
            src = _read_piece(ckpt_dir, entry, piece)
        else:
            path = os.path.join(ckpt_dir, piece["file"])
            expect = int(np.prod(sub_shape)) * dtype.itemsize
            if os.path.getsize(path) != expect:
                raise ValueError(f"checkpoint piece {piece['file']} for {entry['path']!r} has "
                                 f"{os.path.getsize(path)} bytes, expected {expect} — "
                                 "truncated file?")
            src = np.memmap(path, dtype=dtype, mode="r", shape=sub_shape)
        src_at = tuple(slice(a - pa, b - pa) for a, b, (pa, _) in zip(lo, hi, piece["index"]))
        out_at = tuple(slice(a - ia, b - ia) for a, b, (ia, _) in zip(lo, hi, index))
        out[out_at] = src[src_at]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if filled != out.size:
        raise ValueError(f"the pieces of {entry['path']!r} cover {filled} of the {out.size} "
                         f"elements of block {index}")
    return out


def _rank_row(ckpt_dir: str, entry: dict, tleaf: RankShard) -> np.ndarray:
    """Row ``tleaf.rank`` of a leaf saved sharded over ``tleaf.n`` ranks,
    read from that row's piece alone."""
    shape = entry["shape"]
    want = [tleaf.n, *tleaf.tensor.shape]
    if list(shape) != want:
        raise ValueError(f"template shape {want} (rank {tleaf.rank} of {tleaf.n}) != saved shape "
                         f"{shape} for {entry['path']!r}")
    row = [[tleaf.rank, tleaf.rank + 1], *_full_index(shape[1:])]
    for piece in entry["pieces"]:
        if piece["index"] == row:
            return _read_piece(ckpt_dir, entry, piece)[0]
    raise ValueError(f"{entry['path']!r} has no piece for row {tleaf.rank}: it was not saved "
                     "one row a rank")


def _saved_dim0_sharded(entry: dict) -> bool:
    sh = entry.get("sharding")
    return bool(sh and sh["spec"] and sh["spec"][0])


def _resize_flat(arr: np.ndarray, target: int, path: str) -> np.ndarray:
    """Trim (verified-zero tail) or zero-pad a flat 1-D leaf — the ZeRO-2
    bucket-padding invariant (see module docstring)."""
    if target < arr.shape[0]:
        tail = arr[target:]
        if np.any(tail != 0):
            raise ValueError(
                f"cannot restore {path!r}: shrinking {arr.shape[0]} -> {target} "
                "would drop non-zero data (not bucket padding)"
            )
        return np.ascontiguousarray(arr[:target])
    return np.concatenate([arr, np.zeros(target - arr.shape[0], arr.dtype)])


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())  # 0-d stays 0-d
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def _materialize(ckpt_dir: str, entry: dict, tleaf) -> Any:
    """Restore one leaf with the shape, dtype and device of the template
    leaf: a tensor, a :class:`RankShard` (this rank's row), a
    :class:`FlatShard` (this rank's segment), a :class:`MeshShard` (this
    rank's block), a numpy array or a Python scalar."""
    if "inline" in entry or entry.get("kind"):
        return entry.get("inline")
    if isinstance(tleaf, RankShard):
        t = _to_tensor(_rank_row(ckpt_dir, entry, tleaf), entry["dtype"])
        return t.to(device=tleaf.tensor.device, dtype=tleaf.tensor.dtype)
    if isinstance(tleaf, MeshShard):
        saved = tuple(entry["shape"])
        if saved == tuple(tleaf.shape):
            arr = _read_region(ckpt_dir, entry, tleaf.index)
        elif len(saved) == 1 and len(tleaf.shape) == 1 and _saved_dim0_sharded(entry):
            (a, b), = tleaf.index
            arr = _resize_flat(_assemble(ckpt_dir, entry), int(tleaf.shape[0]), entry["path"])[a:b]
        else:
            raise ValueError(f"template shape {tuple(tleaf.shape)} != saved shape {saved} "
                             f"for {entry['path']!r}")
        t = _to_tensor(np.ascontiguousarray(arr), entry["dtype"])
        return t.to(device=tleaf.tensor.device, dtype=tleaf.tensor.dtype)
    arr = _assemble(ckpt_dir, entry)
    if isinstance(tleaf, FlatShard):
        seg = tleaf.tensor.shape[0]
        if arr.ndim != 1 or (arr.shape[0] != seg * tleaf.n and not _saved_dim0_sharded(entry)):
            raise ValueError(f"template flat shard of {seg * tleaf.n} != saved shape "
                             f"{arr.shape} for {entry['path']!r}")
        if arr.shape[0] != seg * tleaf.n:
            arr = _resize_flat(arr, seg * tleaf.n, entry["path"])
        t = _to_tensor(np.ascontiguousarray(arr[tleaf.rank * seg:(tleaf.rank + 1) * seg]),
                       entry["dtype"])
        return t.to(device=tleaf.tensor.device, dtype=tleaf.tensor.dtype)
    t_shape = getattr(tleaf, "shape", None)
    if t_shape is not None and tuple(t_shape) != arr.shape:
        if arr.ndim == 1 and len(t_shape) == 1 and _saved_dim0_sharded(entry):
            arr = _resize_flat(arr, int(t_shape[0]), entry["path"])
        else:
            raise ValueError(
                f"template shape {tuple(t_shape)} != saved shape {arr.shape} "
                f"for {entry['path']!r}"
            )
    if isinstance(tleaf, torch.Tensor):
        return _to_tensor(arr, entry["dtype"]).to(device=tleaf.device, dtype=tleaf.dtype)
    if entry["dtype"] == "bfloat16":
        arr = _to_tensor(arr, "bfloat16").float().numpy()  # numpy holds bf16 values as f32
    if isinstance(tleaf, np.ndarray):
        return arr.astype(tleaf.dtype, copy=False)
    if isinstance(tleaf, (bool, int, float)):
        return type(tleaf)(arr.item())
    if isinstance(tleaf, np.generic):
        return arr.astype(tleaf.dtype)[()]
    raise TypeError(f"template leaf for {entry['path']!r} is a {type(tleaf).__name__}: "
                    "expected a tensor, a RankShard, a numpy array or a Python scalar")


def restore_tree(ckpt_dir: str, template: Any = None, partial: bool = False) -> Any:
    """Rebuild the saved tree.

    With a ``template``, each template leaf is matched to its saved entry by
    tree path and restored with the template leaf's shape, dtype and
    device. ``partial=True`` allows the template to name a subtree of what
    was saved (the weights-only serving load); with ``partial=False`` a
    template that silently drops saved state is an error.

    Without a template, returns nested dicts and lists of CPU tensors and
    inline values (tuples come back as lists)."""
    manifest = read_manifest(ckpt_dir)
    entries = {e["path"]: e for e in manifest["leaves"]}
    if template is None:
        root: dict = {}
        for e in manifest["leaves"]:
            value = (e["inline"] if "inline" in e
                     else _to_tensor(_assemble(ckpt_dir, e), e["dtype"]))
            _insert(root, e["path"].split("/"), value)
        return _listify(root)
    matched = set()

    def restore(path, tleaf):
        if path not in entries:
            raise KeyError(
                f"template leaf {path!r} not found in checkpoint "
                f"{ckpt_dir} (saved paths: {sorted(entries)[:8]}...)"
            )
        matched.add(path)
        return _materialize(ckpt_dir, entries[path], tleaf)

    out = _map_tree(restore, template)
    if not partial and len(matched) != len(entries):
        missing = sorted(set(entries) - matched)
        raise ValueError(
            f"restore template covers {len(matched)}/{len(entries)} saved "
            f"leaves (first missing: {missing[:5]}); pass partial=True for a "
            "weights-only/subtree restore"
        )
    return out


def _insert(root: dict, keys: list, value) -> None:
    node = root
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node):
    """Dict levels whose keys are exactly 0..n-1 were sequences; rebuild as
    lists so layer stacks round-trip without a template."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    keys = list(out)
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out
