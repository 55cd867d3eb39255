"""Preemption-safe sharded checkpointing — the counterpart of
``dsml_tpu/checkpoint/`` (the JAX package's ``docs/CHECKPOINT.md``), with
the same on-disk format: a checkpoint written by either package restores
in the other, each leaf bit for bit.

- :mod:`native` — the format: per-leaf binary piece files (unique pieces
  only: a rank's own rows of a :class:`~native.RankShard` leaf, its own
  block of a :class:`~native.MeshShard` leaf, one copy of everything
  replicated) + a JSON manifest (tree paths, shapes, dtypes,
  sharding specs), committed atomically via write-to-temp + ``os.replace``.
- :mod:`async_writer` — background commit thread; the step loop pays only
  the device→host snapshot, never the disk.
- :mod:`manager` — :class:`CheckpointManager`: ``save``/``restore``/
  ``latest_step``/``max_to_keep`` GC/partial (weights-only) restore, plus
  the manifest-side ``iterator_state`` hook.
- :mod:`iterator` — :class:`ResumableIterator`: persists the data-loader
  position for bit-identical resume.
- :mod:`optim_state` — the bridge between a module's ``state_dict`` and
  ``torch.optim`` state and the parameter and optax state trees the JAX
  package saves under ``params`` and ``opt_state``; :func:`optim_state.mesh_state`
  lays a rank of a model-parallel mesh out as the JAX ``init_hybrid`` tree.

``utils.checkpoint.Checkpointer`` is the thin compat front-end (the native
backend; orbax is JAX-only).
"""

from dsml_tpu_torch.checkpoint.async_writer import AsyncWriter
from dsml_tpu_torch.checkpoint.iterator import ResumableIterator
from dsml_tpu_torch.checkpoint.manager import CheckpointManager
from dsml_tpu_torch.checkpoint.native import MeshShard, RankShard

__all__ = ["AsyncWriter", "CheckpointManager", "MeshShard", "RankShard", "ResumableIterator"]
