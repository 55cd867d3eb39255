"""CheckpointManager — the front-end of the native checkpoint subsystem, the
counterpart of ``dsml_tpu/checkpoint/manager.py``.

Directory layout (one run directory, many steps)::

    <dir>/step_00000042/manifest.json   # tree paths, shapes, dtypes,
    <dir>/step_00000042/L00003_P001.bin #   shardings, piece index
    <dir>/.tmp.step_00000043/...        # in-flight write (invisible to
                                        #   latest_step until renamed)

``save(..., wait=False)`` copies the tensors to host BEFORE returning (an
in-place update after it cannot reach the checkpoint) and commits on a
background thread — the step loop never stalls on disk. ``max_to_keep``
garbage-collects old steps after each commit. ``restore`` gives every leaf
the template's shape, dtype and device (see ``native.restore_tree``).
``iterator_state`` rides in the manifest so a resume can put the data
loader back at the exact batch it stopped at
(``checkpoint.iterator.ResumableIterator``).

With a ``mesh`` (``parallel.mesh``; one process a rank), every rank opens
the manager and calls ``save`` for the same steps: each writes its own
pieces (``native.RankShard`` leaves; rank 0 the replicated ones), and the
commit's barriers run over a gloo group of their own, so a commit on the
writer thread never interleaves with the training loop's collectives.
Rank 0 publishes each step and collects the old ones.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
from typing import Any

from dsml_tpu_torch.checkpoint import native
from dsml_tpu_torch.checkpoint.async_writer import AsyncWriter
from dsml_tpu_torch.obs import get_registry
from dsml_tpu_torch.utils.logging import get_logger

__all__ = ["CheckpointManager"]

log = get_logger("checkpoint")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.rank = 0 if mesh is None else mesh.rank
        self.world = 1 if mesh is None else math.prod(mesh.shape.values())
        self._barrier = None
        if self.world > 1:
            import torch.distributed as dist

            from dsml_tpu_torch.parallel.peer import TIMEOUT_S

            # a group of their own (a collective call: every rank opens the
            # manager) keeps the writer thread's barriers apart from the
            # collectives the training loop runs meanwhile
            group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
            self._barrier = lambda: dist.barrier(group=group)
        self._writer = AsyncWriter()
        # reclaim any .trash.* debris a prior delete renamed but could not
        # remove (busy NFS handles at deletion time)
        for name in os.listdir(self.directory):
            if name.startswith(".trash."):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- write ------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        *,
        iterator_state: dict | None = None,
        meta: dict | None = None,
        wait: bool = True,
    ) -> None:
        """Persist ``state`` as step ``step`` (on every rank of the mesh).
        With ``wait=False`` only the host snapshot happens here; the disk
        commit overlaps training and is made durable by the next
        ``wait_until_finished``/``close`` (or absorbed by a later save's
        barrier). ``iterator_state`` /``meta``
        must be JSON-serializable; they land in the manifest, not as
        leaves."""
        extra = {}
        if iterator_state is not None:
            extra["iterator"] = iterator_state
        if meta:
            extra["meta"] = dict(meta)
        snap = native.snapshot(state, step=step, extra=extra, rank=self.rank, world=self.world)
        directory = self.directory

        def job():
            native.commit(directory, snap, self._barrier)
            if self.rank == 0:  # the publisher collects
                self._gc()

        # the label surfaces in commit-deadline warnings and flight events,
        # so a stuck wait() names the step it is blocked on; the blob
        # bytes ride along as the ledger's checkpoint_staging claim
        # (held until the commit lands, success or fail)
        self._writer.submit(
            job, label=f"step {step}",
            nbytes=sum(int(b.nbytes) for _, b in snap.blobs),
        )
        get_registry().counter(
            "checkpoint_saves_total", "checkpoint save submissions",
            labels=("mode",),
        ).inc(mode="sync" if wait else "async")
        if wait:
            self._writer.wait()
            log.info("saved checkpoint step %d -> %s", step, directory)
        else:
            log.info("scheduled async checkpoint save step %d -> %s", step, directory)

    def wait_until_finished(self) -> None:
        """Block until every in-flight async save has committed (re-raising
        any background write failure)."""
        self._writer.wait()

    def _delete_step(self, step: int, why: str) -> bool:
        path = os.path.join(self.directory, native.step_dirname(step))
        # rename-then-delete: a reader listing steps mid-GC never sees a
        # half-deleted directory as a valid checkpoint
        trash = os.path.join(self.directory, f".trash.{native.step_dirname(step)}")
        try:
            os.replace(path, trash)
        except OSError:  # already gone (concurrent GC) — fine
            return False
        # the RENAME is the deletion (the step is out of every listing);
        # a reclaim failure (NFS .nfsXXXX busy files, open fds) must still
        # count + log the deletion — silence exactly when deletion
        # misbehaves is how trash dirs quietly eat a disk
        try:
            shutil.rmtree(trash)
        except OSError as e:
            log.warning("checkpoint step %d removed but %s not yet "
                        "reclaimed (%s); swept at the next manager open",
                        step, trash, e)
        # a silent deletion is how a "lost" checkpoint becomes a
        # mystery: every deletion names the step AND the path it removed,
        # through both the logger and the registry
        get_registry().counter(
            "checkpoint_gc_total", "checkpoint deletions",
        ).inc()
        log.info("deleted checkpoint step %d (%s), reason=%s", step, path, why)
        return True

    def _gc(self) -> None:
        if not self.max_to_keep or self.max_to_keep < 1:
            return
        steps = self.all_steps()
        for step in steps[: -self.max_to_keep]:
            self._delete_step(step, f"max_to_keep={self.max_to_keep}")

    def delete_steps(self, steps) -> int:
        """Explicitly drop committed steps — the elastic controller's
        lineage-pruning hook (a replay grow-back discards the mixed-width
        checkpoints so a later fallback cannot mix lineages). Returns how
        many were actually removed."""
        return sum(self._delete_step(int(s), "explicit") for s in steps)

    # -- read -------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Committed steps, ascending. Only directories with a manifest
        count — an interrupted write (temp dir) is invisible."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in names:
            step = native.parse_step_dirname(name)
            if step is None:
                continue
            if os.path.exists(os.path.join(self.directory, name, native.MANIFEST)):
                out.append(step)
        return sorted(out)

    @staticmethod
    def newest_common_step(per_host_steps) -> int | None:
        """The newest step EVERY host has committed — the step a
        COORDINATED all-hosts checkpoint fallback must restore when P2P
        shard migration cannot deliver (the JAX package's docs/ELASTIC.md
        § Multi-host recovery). A host restoring a step its peers never
        committed would desync the fleet; the intersection is the only
        safe set. ``None`` when any host has nothing (or the intersection
        is empty): the outage predates the first fleet-wide commit."""
        sets = [set(int(s) for s in steps) for steps in per_host_steps]
        if not sets:
            return None
        common = set.intersection(*sets)
        return max(common) if common else None

    def latest_step(self, where=None) -> int | None:
        """Newest committed step; with ``where`` (a predicate over the
        step's manifest ``meta`` dict), the newest step whose meta
        satisfies it — how the elastic controller finds the last
        pure-lineage checkpoint for a replay grow-back."""
        steps = self.all_steps()
        if where is None:
            return steps[-1] if steps else None
        for step in reversed(steps):
            try:
                meta = self.meta(step)
            except (OSError, KeyError, ValueError):
                continue
            if where(meta):
                return step
        return None

    def _step_dir(self, step: int | None) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, native.step_dirname(step))
        if not os.path.exists(os.path.join(path, native.MANIFEST)):
            raise FileNotFoundError(f"no committed checkpoint for step {step} under {self.directory}")
        return path

    def restore(self, step: int | None = None, template: Any = None,
                partial: bool = False) -> Any:
        """Restore state (latest step when ``step`` is None). With a
        ``template`` (tensors, ``native.RankShard`` rows, numpy arrays,
        scalars), leaves come back with the template's shapes, dtypes and
        devices; ``partial=True`` restores only the subtree the template
        names (the weights-only inference path)."""
        return native.restore_tree(self._step_dir(step), template, partial)

    def iterator_state(self, step: int | None = None) -> dict | None:
        """The data-loader position saved with this step (None if absent)."""
        return native.read_manifest(self._step_dir(step))["extra"].get("iterator")

    def meta(self, step: int | None = None) -> dict:
        return native.read_manifest(self._step_dir(step))["extra"].get("meta", {})

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
