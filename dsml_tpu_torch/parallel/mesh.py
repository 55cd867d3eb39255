"""The process mesh — the counterpart of ``dsml_tpu/parallel/mesh.py``.

The JAX package names one mesh axis per strategy (pp, dp, fsdp, sp, cp,
tp) over ``jax.devices()`` and runs one SPMD program over it. The port runs
one process per rank and maps the spec onto ``torch.distributed`` process
groups: :func:`build_mesh` joins the processes over gloo (rendezvous through
a ``file://`` path, so nothing depends on a network port), gives rank r the
mesh coordinates that ``jax.devices()[r]`` takes in the JAX mesh (the
devices reshaped in the axis order ``AXES``, ``tp`` innermost: rank r holds
exactly the shard JAX device r holds), and gives each sized axis a
:class:`~dsml_tpu_torch.parallel.peer.RingGroup` over the ranks that differ
only in that axis' coordinate, in coordinate order.

Served: every axis and every composition the JAX package serves — pp, dp,
fsdp, one sequence axis (``sp``, the XLA ring's, or ``cp``, the flash
ring's; :meth:`MeshSpec.seq_axis`) and tp. sp and cp both sized raise the
JAX ``ValueError``: a 2D sequence grid rides tp × sp
(``ops.attention.attention_2d``). A plan of ``parallel.auto.plan_mesh`` is
a spec like any other (``build_mesh(plan.spec, ...)``). gloo carries the control
messages (and the ``"xla"`` syncs); the rings' CUDA payloads go through each
ring's own CUDA IPC transport (``parallel/peer.py``), one notice board and
one set of slots per group. An NCCL route waits for a host with several
cards: two NCCL ranks cannot share one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

from dsml_tpu_torch.parallel.peer import TIMEOUT_S, RingGroup
from dsml_tpu_torch.utils.config import Config, field
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["AXES", "Mesh", "MeshSpec", "axis_group_ranks", "build_mesh", "data_mesh",
           "rank_coords"]

AXES = ("pp", "dp", "fsdp", "sp", "cp", "tp")


@dataclasses.dataclass
class MeshSpec(Config):
    pp: int = field(1, help="pipeline-parallel stages")
    dp: int = field(0, help="data-parallel size (0 = absorb remaining devices)")
    fsdp: int = field(1, help="fully-sharded data-parallel (param sharding) size")
    sp: int = field(1, help="sequence-parallel ring size (XLA online-softmax ring)")
    cp: int = field(1, help="context-parallel ring size (flash ring attention)")
    tp: int = field(1, help="tensor-parallel size")

    def resolved(self, n_devices: int) -> "MeshSpec":
        """Fill dp=0 with whatever devices remain after the fixed axes."""
        fixed = self.pp * self.fsdp * self.sp * self.cp * self.tp
        dp = self.dp
        if dp == 0:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by pp*fsdp*sp*cp*tp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {self.sizes_dict() | {'dp': dp}} needs {dp * fixed} devices, have {n_devices}"
            )
        return dataclasses.replace(self, dp=dp)

    def seq_axis(self) -> str:
        """The mesh axis the SEQUENCE dimension shards over — ``cp`` (flash
        ring attention) when cp > 1, else the legacy ``sp`` ring. At most one
        may exceed 1."""
        if self.sp > 1 and self.cp > 1:
            raise ValueError(
                f"sp={self.sp} and cp={self.cp} both >1: pick ONE sequence "
                "ring (2D sequence grids ride tp × sp via attention_2d)"
            )
        return "cp" if self.cp > 1 else "sp"

    def sizes_dict(self) -> dict:
        return {a: getattr(self, a) for a in AXES}

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes_dict().values())


def rank_coords(spec: MeshSpec, rank: int) -> dict:
    """Rank ``rank``'s coordinate on every axis: the row-major unravel of
    the rank over the ``AXES`` shape (``tp`` fastest), as ``build_mesh``
    reshapes ``jax.devices()``."""
    coords = {}
    for axis in reversed(AXES):
        size = getattr(spec, axis)
        coords[axis] = rank % size
        rank //= size
    return {a: coords[a] for a in AXES}


def _rank_of(spec: MeshSpec, coords: dict) -> int:
    rank = 0
    for axis in AXES:
        rank = rank * getattr(spec, axis) + coords[axis]
    return rank


def axis_group_ranks(spec: MeshSpec, axis: str) -> list[list[int]]:
    """Every group of ``axis``: the global ranks that share all other
    coordinates, each list in ``axis``-coordinate order (the ring order);
    the groups in the order of their first rank."""
    groups: dict = {}
    for rank in range(math.prod(spec.sizes_dict().values())):
        c = rank_coords(spec, rank)
        key = tuple(v for a, v in c.items() if a != axis)
        groups.setdefault(key, []).append(rank)
    return sorted(groups.values())


@dataclasses.dataclass
class Mesh:
    """The resolved spec, this process's rank, device and mesh coordinates,
    and one :class:`RingGroup` per sized axis."""

    spec: MeshSpec
    rank: int
    device: torch.device
    groups: dict
    coords: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return self.spec.sizes_dict()

    def group(self, axis: str) -> RingGroup | None:
        return self.groups.get(axis)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def slot_bytes(self) -> int:
        """Device bytes of every open CUDA IPC slot of this rank's groups."""
        return sum(g._ipc.slot_bytes for g in self.groups.values() if g._ipc is not None)

    def close(self) -> None:
        """Close every group's CUDA transport (a collective call)."""
        for g in self.groups.values():
            g.close()


def build_mesh(spec: MeshSpec, rank: int, world_size: int, init_file: str,
               device=None, timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the ``world_size`` processes of ``spec`` (this one is ``rank``)
    over gloo, through the rendezvous file ``init_file`` (a path that no
    earlier run used; every rank passes the same), and build the groups.
    ``device`` is where this rank's tensors live (``None`` = the CUDA
    card, on ``cuda:{rank % device_count}``: ranks share a card when there
    are fewer cards than ranks); a CUDA device becomes the process's
    current device. A rank that waits longer than ``timeout_s`` on another
    in a gloo operation raises instead of hanging. sp and cp both sized raise ``ValueError``
    before any group is joined."""
    spec = spec.resolved(world_size)
    spec.seq_axis()
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    workdir = os.path.dirname(os.path.abspath(init_file))
    coords = rank_coords(spec, rank)
    groups = {}
    for axis in AXES:
        if getattr(spec, axis) == 1:
            continue
        for ranks in axis_group_ranks(spec, axis):
            if len(ranks) == world_size:  # the whole world, in rank order
                pg = dist.group.WORLD
            else:  # every rank creates every group, in the same order
                pg = dist.new_group(ranks, timeout=datetime.timedelta(seconds=timeout_s))
            if rank in ranks:
                groups[axis] = RingGroup(pg, ranks, ranks.index(rank), dev, workdir,
                                         name=f"{axis}{ranks[0]}")
    return Mesh(spec, rank, dev, groups, coords)


def data_mesh(n: int, rank: int, init_file: str, device=None) -> Mesh:
    """A pure data-parallel mesh of ``n`` processes (this one is ``rank``):
    the rank-process counterpart of ``dsml_tpu.parallel.mesh.data_mesh``.
    Each of the ``n`` processes calls it with the same ``init_file``."""
    return build_mesh(MeshSpec(dp=n), rank, n, init_file, device)
