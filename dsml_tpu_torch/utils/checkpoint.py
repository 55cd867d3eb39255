"""Checkpoint/resume compat front-end over ``dsml_tpu_torch.checkpoint`` —
the counterpart of ``dsml_tpu/utils/checkpoint.py``, native backend only.

:class:`Checkpointer` keeps the original save/restore/latest_step API over
:class:`~dsml_tpu_torch.checkpoint.CheckpointManager`: the (params,
opt_state, meta) triple is one ``{"params", "opt_state", "meta"}`` tree,
the layout the JAX package's native backend writes (build the trees with
``checkpoint.optim_state``). The orbax backend wraps a JAX library and
stays in the JAX package: ``backend="orbax"`` (or
``DSML_CKPT_BACKEND=orbax``) raises.
"""

from __future__ import annotations

import os
from typing import Any

from dsml_tpu_torch.checkpoint import CheckpointManager

__all__ = ["Checkpointer"]


def _pick_backend(backend: str | None) -> str:
    backend = backend or os.environ.get("DSML_CKPT_BACKEND", "") or "native"
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend is JAX-only (orbax.checkpoint saves jax arrays); "
            "the port writes the native format, which the JAX package restores too")
    if backend != "native":
        raise ValueError(f"unknown checkpoint backend {backend!r} (native | orbax)")
    return backend


class Checkpointer:
    """Training-state persistence: (params, opt_state, epoch/step metadata)
    persist atomically, restore gives each leaf the template's shape, dtype
    and device, and async saves never stall the step loop. ``mesh``: every
    rank of it opens the checkpointer and saves (see ``CheckpointManager``)."""

    def __init__(self, directory: str, max_to_keep: int = 3, backend: str | None = None,
                 mesh=None):
        self.backend = _pick_backend(backend)
        self.directory = os.path.abspath(directory)
        self.manager = CheckpointManager(self.directory, max_to_keep=max_to_keep, mesh=mesh)

    def save(self, step: int, params: Any, opt_state: Any = None,
             meta: dict | None = None, wait: bool = True) -> None:
        """Persist training state. ``wait=False`` makes the save ASYNC: the
        tensors are copied to host before return and written in a
        background thread while training continues (call
        :meth:`wait_until_finished` before shutdown, or let the next save's
        barrier absorb it)."""
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        if meta:
            state["meta"] = dict(meta)
        self.manager.save(step, state, wait=wait)

    def wait_until_finished(self) -> None:
        """Block until any in-flight async save has committed."""
        self.manager.wait_until_finished()

    def latest_step(self) -> int | None:
        return self.manager.latest_step()

    def restore(self, step: int | None = None, template: Any = None,
                partial: bool = False) -> dict:
        """Restore state. With ``template`` (a tree of like-shaped tensors,
        e.g. ``{"params": optim_state.param_tree(model)}``), leaves come back
        with the template's shapes, dtypes and devices. ``partial=True``
        restores only the subtree named by the template (e.g. params
        without opt_state — the inference-load path)."""
        return self.manager.restore(step, template=template, partial=partial)

    def close(self) -> None:
        self.manager.close()
