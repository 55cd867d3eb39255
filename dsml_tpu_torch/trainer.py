"""Data-parallel trainer, the counterpart of ``dsml_tpu/trainer.py``: the
reference client's epoch loop (batched training, per-epoch "Average Loss /
Accuracy" lines, a final test accuracy) over any model that exposes
``init(seed)``, ``loss(x, y)`` and ``apply(x)`` as methods of an
``nn.Module`` on its device.

Each step is ``parallel.dp.make_dp_train_step``'s: loss, ``backward()``,
the gradient sync, the optimizer's update with the schedule's learning
rate for that update count (optax's order: the count BEFORE the update).
Batches are drawn as the JAX trainer draws them (``shard_batches``
shuffled by ``seed + epoch``), so both trainers see the same batches in
the same order.

Without a mesh the trainer runs on the model's device (any full-precision
``algorithm`` syncs over a group of one: the identity). With a mesh whose
dp > 1 (``parallel.mesh.data_mesh``, one process a rank), every rank runs
the loop on its rows of the same global batches, syncing with
``cfg.algorithm``; eval counts are summed over the ranks, and rank 0 logs.

``cfg.algorithm`` takes every sync of the dp step, the quantized ones
(``q8``, the ``q8_ring``/``q4_ring`` family, ``quant``) included;
``cfg.error_feedback`` keeps each rank's compression residuals in the step
(zero at the start, restored on resume).

Checkpointing (``cfg.checkpoint_dir``), as the JAX trainer: the state
``{"params", "opt_state", "meta": {"epoch"}, "ef"?}`` in the JAX
package's trees (``checkpoint.optim_state``), with the loader position
``{"epoch", "consumed"}`` in the manifest, is saved asynchronously every
``save_every`` epochs and, with ``save_every_steps``, inside an epoch
(then the checkpoint id is the global step, else the completed epoch);
the last save waits, and the writer is closed on every exit. At dp > 1
every rank saves: the error-feedback residuals are each rank's own rows
of ``ef/<p>`` ``[n, *shape]`` (``native.RankShard``), the rest is rank
0's. ``resume`` restores the latest step (a checkpoint that cannot be read
raises) and, after a save inside an epoch, fast-forwards that epoch's
``shard_batches(seed + epoch)`` stream past the consumed batches: the run
continues bit for bit as if never stopped. A checkpoint either package
wrote resumes in the other.

Observability (``dsml_tpu_torch.obs``), as in the JAX trainer and all of
it at the existing loss sync, which adds no device→host round trip: with
the registry enabled, a per-step breakdown (data / step_dispatch /
loss_sync) and goodput; ``train_start``, ``step``, ``loss_sync`` and
``epoch`` flight-recorder events; memory-ledger claims of the parameters,
the optimizer state (claimed after the run's first update: a fresh
``torch.optim`` allocates its state there) and the error-feedback
residuals, and a peak watermark at every loss sync;
``quant_error_feedback_norm`` (the global L2
norm of ``step.error_feedback``, f32) at loss syncs; an OOM postmortem on
the way out. ``DSML_SENTINELS`` checks the synced loss; ``DSML_HANGWATCH``
arms a deadline per sync window (disarmed on every exit).
``DSML_MEASURE_ACT=1`` measures the step's activation footprint before
training (``parallel.auto.measured_activation_bytes``) into the ledger's
``activations`` claim, an ``activation_measured`` event and a log line,
where ``parallel.auto.plan_mesh`` reads it. Each of the three knobs
implies ``obs.enable()``. With a checkpoint: the ``checkpoint_stall``
breakdown phase (the save's synchronous part), the goodput marks
``restore`` and ``checkpoint_save``, a ``checkpoint_save`` event.

``cfg.lr_schedule="plateau"`` is the JAX trainer's adaptive scheduler: a
constant ``cfg.lr`` times the scale of ``utils.schedules.adaptive_plateau``
(``factor=cfg.plateau_factor``, ``patience=cfg.plateau_patience``, one
window an epoch: ``accumulation_size = steps_per_epoch``), which the dp
step feeds the group-averaged loss of every update and which reads the
host once a window; its six-leaf state is checkpointed at the JAX
trainer's ``opt_state/1/...`` paths (``checkpoint.optim_state``), so a
resume inside an epoch keeps the window's ``count`` and ``avg_value``.

Models whose forward couples rows through batch statistics
(``models.resnet.ResNet18``) normalise as in the JAX trainer: over the
global batch under ``algorithm="xla"`` and in every eval, over each rank's
rows under the explicit syncs (``parallel.dp``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from dsml_tpu_torch import obs
from dsml_tpu_torch.checkpoint import CheckpointManager, RankShard
from dsml_tpu_torch.checkpoint.optim_state import (flat_paths, load_optax_state, load_param_tree,
                                                   nest_paths, optax_state, param_tree)
from dsml_tpu_torch.obs import GoodputTracker, StepBreakdown, flight_recorder, hangwatch
from dsml_tpu_torch.obs.memory import get_memory_ledger, maybe_dump_oom
from dsml_tpu_torch.obs.sentinels import TrainingSentinels
from dsml_tpu_torch.parallel.dp import make_dp_train_step, make_eval_step, named_params
from dsml_tpu_torch.utils.config import Config, field
from dsml_tpu_torch.utils.data import Dataset, prefetch_batches, shard_batches
from dsml_tpu_torch.utils.logging import get_logger
from dsml_tpu_torch.utils.metrics import EpochMetrics, MetricsLogger, ProgressBar
from dsml_tpu_torch.utils.schedules import make_schedule, wrap_with_plateau

__all__ = ["TrainConfig", "Trainer"]

log = get_logger("trainer")


@dataclasses.dataclass
class TrainConfig(Config):
    epochs: int = field(10, help="training epochs (reference: 10)")
    batch_size: int = field(64, help="GLOBAL batch size (reference: 64)")
    lr: float = field(0.01, help="SGD learning rate (reference: 0.01)")
    optimizer: str = field("sgd", help="sgd | momentum | adam | adamw")
    lr_schedule: str = field("constant", help="constant | cosine | linear | step | plateau (the adaptive reduce-on-plateau scheduler: lr times a scale that decays when the epoch's mean loss stops improving)")
    warmup_steps: int = field(0, help="linear warmup steps for the schedule")
    plateau_patience: int = field(5, help="plateau schedule: epochs-worth of steps without improvement before decaying")
    plateau_factor: float = field(0.5, help="plateau schedule: lr decay factor")
    algorithm: str = field("xla", help="gradient sync: xla | ring | ring2 | auto | naive | q8 (int8 gather) | q8_ring | q8_ring2 | q4_ring | q4_ring2 (block-quantized ring schedules) | quant (per dtype from DSML_QUANT)")
    error_feedback: bool = field(False, help="error-feedback residuals for quantized ring sync (q8_ring/q8_ring2/q4_ring/q4_ring2/quant): each rank's compression error re-enters the next step's gradients")
    bucket_mb: float = field(0.0, help="explicit-sync gradient bucket size in MiB (0 = the DSML_BUCKET_MB default, currently 4; negative = single buffer)")
    dp: int = field(0, help="data-parallel ranks (0 or 1 = this device; more needs a mesh of that many processes)")
    seed: int = field(0, help="init + shuffle seed")
    log_metrics: str = field("", help="optional JSONL metrics path")
    checkpoint_dir: str = field("", help="checkpoint directory ('' = no checkpointing; the native sharded format, shared with the JAX package)")
    save_every: int = field(1, help="checkpoint every N epochs")
    save_every_steps: int = field(0, help="ALSO checkpoint every N steps mid-epoch (0 = epoch boundaries only); the data-loader position (epoch, consumed batches) rides the manifest so a preempted run resumes mid-epoch bit-identically; step-granularity saves use the global step as the checkpoint id")
    keep_checkpoints: int = field(3, help="max checkpoints retained (older steps garbage-collected)")
    resume: bool = field(False, help="resume from the latest checkpoint in checkpoint_dir")
    progress: bool = field(False, help="draw per-epoch train/eval progress bars on stderr")
    sync_every: int = field(32, help="device→host loss sync cadence in steps; also the training-health sentinel check point (DSML_SENTINELS)")


def _check_supported(cfg: TrainConfig, mesh) -> None:
    n_dp = 1 if mesh is None else mesh.shape.get("dp", 1)
    if cfg.dp > 1 and cfg.dp != n_dp:
        raise ValueError(
            f"dp={cfg.dp} needs a mesh of dp={cfg.dp} ranks (got dp={n_dp}): start {cfg.dp} "
            "processes (torch.multiprocessing.spawn) and in rank r pass "
            f"mesh=parallel.mesh.data_mesh({cfg.dp}, r, <shared rendezvous file>)")


def _make_optimizer(cfg: TrainConfig, params, steps_per_epoch: int):
    """(torch optimizer, schedule) for ``cfg``: the optax optimizers of the
    JAX trainer on ``torch.optim`` (the same update rules; adamw's weight
    decay is the trainer's 1e-4). The optimizer is built at lr 0: the
    caller sets each update's lr from the schedule."""
    total = max(cfg.epochs * steps_per_epoch, 1)
    schedule = make_schedule(cfg.lr_schedule, cfg.lr, total, cfg.warmup_steps)
    params = list(params)
    makers = {
        "sgd": lambda: torch.optim.SGD(params, lr=0.0),
        # optax's trace starts at 0, so its first step is g: torch's buffer too
        "momentum": lambda: torch.optim.SGD(params, lr=0.0, momentum=0.9),
        "adam": lambda: torch.optim.Adam(params, lr=0.0),
        "adamw": lambda: torch.optim.AdamW(params, lr=0.0, weight_decay=1e-4),
    }
    if cfg.optimizer not in makers:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; choose from {sorted(makers)}")
    return makers[cfg.optimizer](), schedule


def _make_plateau(cfg: TrainConfig, optimizer, steps_per_epoch: int):
    """The reduce-on-plateau scheduler of ``lr_schedule="plateau"`` (else
    None), built as the JAX trainer builds it: one accumulated loss window
    an epoch, so patience counts epochs."""
    if cfg.lr_schedule != "plateau":
        return None
    return wrap_with_plateau(optimizer, factor=cfg.plateau_factor, patience=cfg.plateau_patience,
                             accumulation_size=max(steps_per_epoch, 1))


@torch.no_grad()
def _global_norm(tensors) -> float:
    """optax.global_norm in f32: the L2 norm over every element of
    ``tensors`` (one host read)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors)).item()


class Trainer:
    """Train ``model`` (an ``nn.Module`` with ``init(seed)``, ``loss(x, y)``
    and ``apply(x)``) on the device its weights live on, as one rank of
    ``mesh``'s dp group when given."""

    def __init__(self, model, config: TrainConfig | None = None, mesh=None):
        self.model = model
        self.config = config or TrainConfig()
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0  # logs and writes the metrics
        self.metrics = MetricsLogger((self.config.log_metrics or None) if self.lead else None)
        self.n_dp = 1 if mesh is None else mesh.shape.get("dp", 1)
        self._eval_fn = make_eval_step(model, mesh)
        self.plateau = None  # the last run's reduce-on-plateau scheduler (lr_schedule="plateau")

    def train(self, data: Dataset, params: dict | None = None):
        """Train for ``cfg.epochs``; ``params`` (a state dict, e.g. from
        ``models.convert.params_from_jax``) replaces ``init(seed)``.
        Returns (the model's state dict, per-epoch history, test
        accuracy)."""
        cfg = self.config
        _check_supported(cfg, self.mesh)
        if cfg.batch_size % self.n_dp:
            raise ValueError(f"global batch {cfg.batch_size} not divisible by dp={self.n_dp}")
        model = self.model
        steps_per_epoch = data.n_train // cfg.batch_size
        if params is None:
            model.init(cfg.seed)
        else:
            model.load_state_dict(params)
        optimizer, schedule = _make_optimizer(cfg, model.parameters(), steps_per_epoch)
        plateau = self.plateau = _make_plateau(cfg, optimizer, steps_per_epoch)
        # 0 → the DSML_BUCKET_MB default, < 0 → one buffer
        bucket = "auto" if cfg.bucket_mb == 0 else (None if cfg.bucket_mb < 0 else cfg.bucket_mb)
        step = make_dp_train_step(model, optimizer, self.mesh, cfg.algorithm,
                                  bucket_size_mb=bucket, error_feedback=cfg.error_feedback,
                                  plateau=plateau)
        rank = 0 if self.mesh is None else self.mesh.rank
        ef_names = ([n for n, _ in named_params(model, optimizer)]
                    if step.error_feedback is not None else None)

        def state_tree(epochs_done: int) -> dict:
            """The checkpointed state, in the JAX trainer's trees."""
            state = {"params": param_tree(model),
                     "opt_state": optax_state(optimizer, model, cfg.optimizer, count, plateau),
                     "meta": {"epoch": epochs_done}}
            if ef_names is not None:
                # this rank's residuals: its row of the JAX package's [n, *shape]
                state["ef"] = nest_paths({n: RankShard(t, rank, self.n_dp)
                                          for n, t in zip(ef_names, step.error_feedback)})
            return state

        ckpt = None
        count = 0  # updates done: the schedule's argument, as optax counts
        start_epoch = 1
        resume_skip = 0  # batches already consumed of start_epoch (mid-epoch resume)
        if cfg.checkpoint_dir:
            ckpt = CheckpointManager(cfg.checkpoint_dir, max_to_keep=cfg.keep_checkpoints,
                                     mesh=self.mesh)
            if cfg.resume and ckpt.latest_step() is None:
                foreign = [n for n in os.listdir(ckpt.directory) if n.isdigit()]
                if foreign:
                    # digit-named step dirs = the orbax layout the JAX package's
                    # old Checkpointer wrote; restarting silently would redo
                    # every completed epoch
                    raise RuntimeError(
                        f"resume=True but {cfg.checkpoint_dir} holds no native checkpoints — "
                        f"found orbax-format step dirs {foreign[:3]}; restore them with the JAX "
                        "package's Checkpointer(backend='orbax') or start a fresh checkpoint_dir")
            if cfg.resume and ckpt.latest_step() is not None:
                state = ckpt.restore(template=state_tree(0))
                load_param_tree(model, state["params"])
                count = load_optax_state(optimizer, model, cfg.optimizer, state["opt_state"],
                                         plateau)
                if ef_names is not None:
                    # restoring the residuals keeps a kill-and-resume under a
                    # quantized sync bit-identical to the unkilled run
                    ef = flat_paths(state["ef"])
                    step.error_feedback = [ef[n] for n in ef_names]
                it_state = ckpt.iterator_state() or {}
                if int(it_state.get("consumed", 0)) > 0:
                    # a save inside an epoch: restart there, past the consumed
                    # prefix of the same (seed + epoch) shuffle
                    start_epoch = int(it_state["epoch"])
                    resume_skip = int(it_state["consumed"])
                    log.info("resumed mid-epoch %d at batch %d", start_epoch, resume_skip)
                else:
                    start_epoch = int(state["meta"]["epoch"]) + 1
                    log.info("resumed from checkpoint at epoch %d", start_epoch - 1)
        start_count = count
        sync_every = max(cfg.sync_every, 1)
        # observability: opt-in and sync-free (every host read below is the
        # loss sync the loop does anyway); a forensic knob implies enable()
        obs_reg = obs.get_registry()
        recorder = flight_recorder.get_flight_recorder()
        sentinels = TrainingSentinels.maybe_from_env()
        hw_cfg = hangwatch.config_from_env()
        hw = hangwatch.get_hangwatch() if hw_cfg is not None else None
        measure_act = os.environ.get("DSML_MEASURE_ACT") == "1"
        if sentinels is not None or hw is not None or measure_act:
            # a forensic knob (or a measured activation claim, which a
            # disabled registry would drop) implies the registry, the ring
            # log handler and the flight recorder's hooks
            obs.enable()
        track = obs_reg.enabled
        goodput = GoodputTracker(registry=obs_reg) if track else None
        breakdown = StepBreakdown(registry=obs_reg) if track else None
        ledger = get_memory_ledger(obs_reg)
        if track:
            ledger.claim_tree("params", model)
            if step.error_feedback is not None:
                ledger.claim_tree("error_feedback", step.error_feedback)
        if measure_act:
            self._measure_activation_footprint(data.train_x[: cfg.batch_size],
                                               data.train_y[: cfg.batch_size], ledger, recorder)
        if track and start_epoch > 1:
            goodput.mark("restore", epoch=start_epoch - 1)
        step_deadline = (hangwatch.TrailingDeadline.from_config(hw_cfg)
                         if hw_cfg is not None else None)
        save_every_steps = max(cfg.save_every_steps, 0)
        recorder.record("train_start", epochs=cfg.epochs, batch_size=cfg.batch_size,
                        steps_per_epoch=steps_per_epoch, algorithm=cfg.algorithm,
                        start_epoch=start_epoch)

        def save_ckpt(epochs_done: int, it_epoch: int, consumed_now: int, wait: bool = False):
            """THE checkpoint write of all three call sites (inside an epoch,
            at its end, at the end of the run): id = the global step when
            step-granularity saves are on, else the completed epoch; the
            loader position rides the manifest. With wait=False the loop
            pays only the host snapshot (the commit rides the writer
            thread)."""
            t_save = time.perf_counter()
            ckpt.save(count if save_every_steps else epochs_done, state_tree(epochs_done),
                      iterator_state={"epoch": it_epoch, "consumed": consumed_now}, wait=wait)
            if track:
                breakdown.add("checkpoint_stall", time.perf_counter() - t_save)
                goodput.mark("checkpoint_save", epoch=it_epoch, step=count)
            recorder.record("checkpoint_save", epoch=it_epoch, step=count,
                            stall_ms=round((time.perf_counter() - t_save) * 1e3, 3))

        history = []
        t0 = time.monotonic()
        train_body_done = False
        try:
            for epoch in range(start_epoch, cfg.epochs + 1):
                losses = []  # device scalars, synced every sync_every steps
                batches = prefetch_batches(shard_batches(
                    data.train_x, data.train_y, cfg.batch_size, seed=cfg.seed + epoch))
                skip = resume_skip if epoch == start_epoch else 0
                if skip:
                    # past the consumed prefix of the deterministic stream (the
                    # prefetcher never over-advances the recorded position)
                    batches = itertools.islice(batches, skip, None)
                consumed = skip
                bar = ProgressBar(steps_per_epoch - skip, desc=f"Epoch {epoch}/{cfg.epochs}",
                                  enabled=cfg.progress and self.lead)
                model.train()
                epoch_t0 = time.monotonic()
                t_prev = win_t0 = time.perf_counter()
                # the hang watch covers the SYNC WINDOW (sync to sync): only
                # the sync blocks, so single steps' walls are launch times
                hw_token = None
                try:
                    for x, y in batches:
                        consumed += 1
                        if hw is not None and hw_token is None:
                            deadline_s = step_deadline.timeout_s()
                            if deadline_s is not None:
                                hw_token = hw.arm("train_sync_window", deadline_s,
                                                  step=count + 1, epoch=epoch)
                        if track:
                            t_data = time.perf_counter()
                            breakdown.add("data", t_data - t_prev)
                        losses.append(step(x, y, lr=schedule(count)))
                        count += 1
                        if track:
                            t_disp = time.perf_counter()
                            breakdown.add("step_dispatch", t_disp - t_data)
                            if count == start_count + 1:  # a fresh torch.optim allocates here
                                ledger.claim_tree("optimizer", optimizer.state)
                        bar.update()
                        if len(losses) % sync_every == 0:
                            loss_host = losses[-1].item()  # bounds how far the host runs ahead
                            if track:
                                breakdown.add("loss_sync", time.perf_counter() - t_disp)
                                ledger.note_step_peak(count)
                            if hw is not None:
                                if hw_token is not None:
                                    hw.disarm(hw_token)
                                    hw_token = None
                                now_sync = time.perf_counter()
                                step_deadline.observe(now_sync - win_t0)
                                win_t0 = now_sync
                            if sentinels is not None or track:
                                recorder.record("loss_sync", step=count, epoch=epoch,
                                                loss=loss_host)
                                if sentinels is not None:
                                    # a halt raises SentinelTripped with the bundle on disk
                                    sentinels.check(count, loss_host)
                            if track and step.error_feedback is not None:
                                obs_reg.gauge(
                                    "quant_error_feedback_norm",
                                    "global L2 norm of the error-feedback residual tree "
                                    "(sampled at loss syncs)",
                                ).set(_global_norm(step.error_feedback))
                        if track:
                            now = time.perf_counter()
                            breakdown.note_step_wall(now - t_prev)
                            recorder.record("step", step=count, epoch=epoch,
                                            wall_ms=round((now - t_prev) * 1e3, 3))
                            t_prev = now
                        if (ckpt is not None and save_every_steps
                                and consumed < steps_per_epoch
                                and count % save_every_steps == 0):
                            # a preemption point inside the epoch
                            save_ckpt(epoch - 1, epoch, consumed)
                            if track:
                                t_prev = time.perf_counter()  # a save is not data time
                finally:
                    # disarm on EVERY exit: a halt, an exception or an epoch
                    # ending mid-window must not leave a deadline to fire later
                    if hw_token is not None:
                        hw.disarm(hw_token)
                bar.close()
                if track:
                    goodput.add_productive(time.monotonic() - epoch_t0)
                em = EpochMetrics()
                for loss in torch.stack(losses).tolist() if losses else []:
                    em.update(loss, 0, cfg.batch_size)
                train_acc = self.evaluate(data.train_x, data.train_y)
                if self.lead:
                    log.info("Epoch %d: Average Loss = %.4f, Accuracy = %.2f%%", epoch,
                             em.avg_loss, train_acc * 100)
                recorder.record("epoch", epoch=epoch, avg_loss=em.avg_loss,
                                train_accuracy=train_acc)
                history.append(self.metrics.log(epoch=epoch, avg_loss=em.avg_loss,
                                                train_accuracy=train_acc))
                if ckpt is not None and epoch % max(cfg.save_every, 1) == 0:
                    # async: the commit overlaps the next epoch; the loader
                    # position is the next epoch's seed
                    save_ckpt(epoch, epoch, 0)
            if ckpt is not None and cfg.epochs >= start_epoch \
                    and cfg.epochs % max(cfg.save_every, 1) != 0:
                # the final state is always persisted, even off the cadence
                save_ckpt(cfg.epochs, cfg.epochs, 0, wait=True)
            train_body_done = True
        except BaseException as e:
            # a device OOM unwinding through here leaves a postmortem whose
            # memory.json carries the ledger; anything else passes untouched
            if track:
                try:
                    maybe_dump_oom(e)
                except Exception:  # noqa: BLE001 — never mask the real crash
                    pass
            raise
        finally:
            if ckpt is not None:
                # ALWAYS flush: a dying run still commits its queued saves —
                # the checkpoint recovery resumes from. A writer error must
                # not mask the original exception.
                try:
                    ckpt.close()
                except Exception:
                    if train_body_done:
                        raise
                    log.warning("checkpoint close failed during exception unwind",
                                exc_info=True)
        test_acc = self.evaluate(data.test_x, data.test_y,
                                 progress_label="Testing" if cfg.progress else None)
        wall = time.monotonic() - t0
        epochs_run = max(cfg.epochs - start_epoch + 1, 0)  # a resume skips the earlier epochs
        samples = epochs_run * steps_per_epoch * cfg.batch_size
        if self.lead:
            log.info("Final Test Accuracy: %.2f%%", test_acc * 100)
        final = {"test_accuracy": test_acc, "wall_time_s": wall,
                 "samples_per_sec": samples / max(wall, 1e-9)}
        if track:
            gsum = goodput.summary()
            obs_reg.gauge("train_goodput", "productive/wall of the last run").set(gsum["goodput"])
            final["obs_goodput"] = gsum
            final["obs_step_breakdown"] = breakdown.summary()
        self.metrics.log(**final)
        return model.state_dict(), history, test_acc

    def _measure_activation_footprint(self, x, y, ledger, recorder) -> None:
        """``DSML_MEASURE_ACT=1``: the bytes the step saves for its backward
        at the global batch, from shapes alone
        (``parallel.auto.measured_activation_bytes`` on the model's meta
        twin), recorded as the ledger's ``activations`` claim with its batch
        (``plan_mesh`` rescales it), an ``activation_measured`` event and a
        log line. A failed measurement logs and training goes on."""
        from dsml_tpu_torch.parallel.auto import measured_activation_bytes, meta_twin

        def meta(a):
            return torch.empty_like(torch.as_tensor(a), device="meta")

        try:
            measured = measured_activation_bytes(meta_twin(self.model).loss, meta(x), meta(y))
        except Exception:
            log.warning("DSML_MEASURE_ACT: activation measurement failed", exc_info=True)
            return
        if measured is None:
            log.warning("DSML_MEASURE_ACT: the loss builds no graph — activation "
                        "footprint stays analytic")
            return
        ledger.record_activation_measurement(measured, x.shape[0])
        recorder.record("activation_measured", bytes=int(measured), batch=int(x.shape[0]))
        log.info("measured activation footprint: %.2f MB (bytes autograd saves for the "
                 "step's backward)", measured / 1e6)

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray, batch_size: int = 2048,
                 progress_label: str | None = None) -> float:
        """Fraction of ``x`` whose argmax logit is ``y``, with the model's
        current weights; with dp ranks, over the largest dp multiple of the
        rows (every eval batch splits evenly over dp), as the JAX
        trainer."""
        n_dp = self.n_dp
        n = x.shape[0]
        usable = n - n % n_dp
        bs = max(batch_size - batch_size % n_dp, n_dp)
        bar = ProgressBar((usable + bs - 1) // bs, desc=progress_label or "Testing",
                          enabled=progress_label is not None and self.lead)
        self.model.eval()
        correct = 0
        for start in range(0, usable, bs):
            xb, yb = x[start:start + bs], y[start:start + bs]
            cut = xb.shape[0] - xb.shape[0] % n_dp  # tail: trim to a dp multiple
            correct += int(self._eval_fn(xb[:cut], yb[:cut]))
            bar.update()
        bar.close()
        return correct / max(usable, 1)
