"""The process mesh — the counterpart of ``dsml_tpu/parallel/mesh.py``.

The JAX package names one mesh axis per strategy (pp, dp, fsdp, sp, cp,
tp) over ``jax.devices()`` and runs one SPMD program over it. The port runs
one process per rank and maps the spec onto ``torch.distributed`` process
groups: :func:`build_mesh` joins the processes over gloo (rendezvous through
a ``file://`` path, so nothing depends on a network port) and gives each
sized axis a :class:`~dsml_tpu_torch.parallel.peer.RingGroup`.

Two meshes are served so far: the data-parallel ring (``dp`` with every
other axis 1; :func:`data_mesh`) and the context-parallel ring (``cp``
with dp = 1). Every other sized axis, and dp composed with cp, raises and
names the ROADMAP item that brings it. gloo carries the control messages
(and the ``"xla"`` sync); the rings' CUDA payloads go through the ring's
own CUDA IPC transport (``parallel/peer.py``). An NCCL route waits for a
host with several cards: two NCCL ranks cannot share one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from dsml_tpu_torch.parallel.peer import TIMEOUT_S, RingGroup
from dsml_tpu_torch.utils.config import Config, field
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["AXES", "Mesh", "MeshSpec", "build_mesh", "data_mesh"]

AXES = ("pp", "dp", "fsdp", "sp", "cp", "tp")
_NOT_PORTED = "comes with a later slice of the port (ROADMAP.md queue 1, item {})"
# the item of ROADMAP.md queue 1 that serves each axis other than dp and cp
_AXIS_ITEMS = {"pp": 11, "fsdp": 11, "sp": 12, "tp": 11}
_RING_AXES = ("dp", "cp")  # the axes a mesh may size, one at a time


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


@dataclasses.dataclass
class Mesh:
    """The resolved spec, this process's rank and device, and one
    :class:`RingGroup` per sized axis (``dp`` or ``cp``)."""

    spec: MeshSpec
    rank: int
    device: torch.device
    groups: dict

    @property
    def shape(self) -> dict:
        return self.spec.sizes_dict()

    def group(self, axis: str) -> RingGroup | None:
        return self.groups.get(axis)

    def close(self) -> None:
        """Close every group's CUDA transport (a collective call)."""
        for g in self.groups.values():
            g.close()


def build_mesh(spec: MeshSpec, rank: int, world_size: int, init_file: str,
               device=None) -> Mesh:
    """Join the ``world_size`` processes of ``spec`` (this one is ``rank``)
    over gloo, through the rendezvous file ``init_file`` (a path that no
    earlier run used; every rank passes the same), and build the groups.
    ``device`` is where this rank's tensors live (``None`` = the CUDA
    card, on ``cuda:{rank % device_count}``: ranks share a card when there
    are fewer cards than ranks); a CUDA device becomes the process's
    current device. A rank that waits longer than ``TIMEOUT_S`` on another
    raises instead of hanging."""
    spec = spec.resolved(world_size)
    spec.seq_axis()
    for axis, item in _AXIS_ITEMS.items():
        if getattr(spec, axis) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={getattr(spec, axis)} " + _NOT_PORTED.format(item))
    if spec.dp > 1 and spec.cp > 1:
        raise NotImplementedError(
            f"mesh axis dp={spec.dp} composed with cp={spec.cp} " + _NOT_PORTED.format(12))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    groups = {}
    for axis in _RING_AXES:
        if getattr(spec, axis) > 1:
            # the only sized axis: its ring is the whole world, in rank order
            groups[axis] = RingGroup(dist.group.WORLD, range(world_size), rank, dev,
                                     os.path.dirname(os.path.abspath(init_file)))
    return Mesh(spec, rank, dev, groups)


def data_mesh(n: int, rank: int, init_file: str, device=None) -> Mesh:
    """A pure data-parallel mesh of ``n`` processes (this one is ``rank``):
    the rank-process counterpart of ``dsml_tpu.parallel.mesh.data_mesh``.
    Each of the ``n`` processes calls it with the same ``init_file``."""
    return build_mesh(MeshSpec(dp=n), rank, n, init_file, device)
