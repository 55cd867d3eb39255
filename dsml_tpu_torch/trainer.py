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
(zero at the start; they ride no checkpoint until checkpointing is
ported).

Observability (``dsml_tpu_torch.obs``), as in the JAX trainer and all of
it at the existing loss sync, which adds no device→host round trip: with
the registry enabled, a per-step breakdown (data / step_dispatch /
loss_sync) and goodput; ``train_start``, ``step``, ``loss_sync`` and
``epoch`` flight-recorder events; memory-ledger claims of the parameters,
the optimizer state (claimed after the first update, which allocates
``torch.optim``'s state) and the error-feedback residuals, and a peak
watermark at every loss sync; ``quant_error_feedback_norm`` (the global L2
norm of ``step.error_feedback``, f32) at loss syncs; an OOM postmortem on
the way out. ``DSML_SENTINELS`` checks the synced loss; ``DSML_HANGWATCH``
arms a deadline per sync window (disarmed on every exit). Either knob
implies ``obs.enable()``.

Not ported yet, and raising: ``checkpoint_dir``/``resume`` (the
checkpointing slice) and the ``plateau`` schedule.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dsml_tpu_torch import obs
from dsml_tpu_torch.obs import GoodputTracker, StepBreakdown, flight_recorder, hangwatch
from dsml_tpu_torch.obs.memory import get_memory_ledger, maybe_dump_oom
from dsml_tpu_torch.obs.sentinels import TrainingSentinels
from dsml_tpu_torch.parallel.dp import make_dp_train_step, make_eval_step
from dsml_tpu_torch.utils.config import Config, field
from dsml_tpu_torch.utils.data import Dataset, prefetch_batches, shard_batches
from dsml_tpu_torch.utils.logging import get_logger
from dsml_tpu_torch.utils.metrics import EpochMetrics, MetricsLogger, ProgressBar
from dsml_tpu_torch.utils.schedules import make_schedule

__all__ = ["TrainConfig", "Trainer"]

log = get_logger("trainer")


@dataclasses.dataclass
class TrainConfig(Config):
    epochs: int = field(10, help="training epochs (reference: 10)")
    batch_size: int = field(64, help="GLOBAL batch size (reference: 64)")
    lr: float = field(0.01, help="SGD learning rate (reference: 0.01)")
    optimizer: str = field("sgd", help="sgd | momentum | adam | adamw")
    lr_schedule: str = field("constant", help="constant | cosine | linear | step (plateau: not ported yet)")
    warmup_steps: int = field(0, help="linear warmup steps for the schedule")
    plateau_patience: int = field(5, help="plateau schedule: epochs-worth of steps without improvement before decaying (not ported yet)")
    plateau_factor: float = field(0.5, help="plateau schedule: lr decay factor (not ported yet)")
    algorithm: str = field("xla", help="gradient sync: xla | ring | ring2 | auto | naive | q8 (int8 gather) | q8_ring | q8_ring2 | q4_ring | q4_ring2 (block-quantized ring schedules) | quant (per dtype from DSML_QUANT)")
    error_feedback: bool = field(False, help="error-feedback residuals for quantized ring sync (q8_ring/q8_ring2/q4_ring/q4_ring2/quant): each rank's compression error re-enters the next step's gradients")
    bucket_mb: float = field(0.0, help="explicit-sync gradient bucket size in MiB (0 = the DSML_BUCKET_MB default, currently 4; negative = single buffer)")
    dp: int = field(0, help="data-parallel ranks (0 or 1 = this device; more needs a mesh of that many processes)")
    seed: int = field(0, help="init + shuffle seed")
    log_metrics: str = field("", help="optional JSONL metrics path")
    checkpoint_dir: str = field("", help="checkpoint directory (checkpointing slice; '' = off)")
    save_every: int = field(1, help="checkpoint every N epochs")
    save_every_steps: int = field(0, help="also checkpoint every N steps mid-epoch")
    keep_checkpoints: int = field(3, help="max checkpoints retained")
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
    if cfg.checkpoint_dir or cfg.resume:
        raise NotImplementedError("checkpoint_dir / resume come with the checkpointing slice")


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
        # 0 → the DSML_BUCKET_MB default, < 0 → one buffer
        bucket = "auto" if cfg.bucket_mb == 0 else (None if cfg.bucket_mb < 0 else cfg.bucket_mb)
        step = make_dp_train_step(model, optimizer, self.mesh, cfg.algorithm,
                                  bucket_size_mb=bucket, error_feedback=cfg.error_feedback)
        sync_every = max(cfg.sync_every, 1)
        # observability: opt-in and sync-free (every host read below is the
        # loss sync the loop does anyway); a forensic knob implies enable()
        obs_reg = obs.get_registry()
        recorder = flight_recorder.get_flight_recorder()
        sentinels = TrainingSentinels.maybe_from_env()
        hw_cfg = hangwatch.config_from_env()
        hw = hangwatch.get_hangwatch() if hw_cfg is not None else None
        if sentinels is not None or hw is not None:
            obs.enable()
        track = obs_reg.enabled
        goodput = GoodputTracker(registry=obs_reg) if track else None
        breakdown = StepBreakdown(registry=obs_reg) if track else None
        ledger = get_memory_ledger(obs_reg)
        if track:
            ledger.claim_tree("params", model)
            if step.error_feedback is not None:
                ledger.claim_tree("error_feedback", step.error_feedback)
        step_deadline = (hangwatch.TrailingDeadline.from_config(hw_cfg)
                         if hw_cfg is not None else None)
        recorder.record("train_start", epochs=cfg.epochs, batch_size=cfg.batch_size,
                        steps_per_epoch=steps_per_epoch, algorithm=cfg.algorithm, start_epoch=1)
        count = 0  # updates done: the schedule's argument, as optax counts
        history = []
        t0 = time.monotonic()
        try:
            for epoch in range(1, cfg.epochs + 1):
                losses = []  # device scalars, synced every sync_every steps
                bar = ProgressBar(steps_per_epoch, desc=f"Epoch {epoch}/{cfg.epochs}",
                                  enabled=cfg.progress and self.lead)
                model.train()
                epoch_t0 = time.monotonic()
                t_prev = win_t0 = time.perf_counter()
                # the hang watch covers the SYNC WINDOW (sync to sync): only
                # the sync blocks, so single steps' walls are launch times
                hw_token = None
                try:
                    for x, y in prefetch_batches(shard_batches(
                            data.train_x, data.train_y, cfg.batch_size, seed=cfg.seed + epoch)):
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
                            if count == 1:  # torch.optim allocates its state in the first update
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
        except BaseException as e:
            # a device OOM unwinding through here leaves a postmortem whose
            # memory.json carries the ledger; anything else passes untouched
            if track:
                try:
                    maybe_dump_oom(e)
                except Exception:  # noqa: BLE001 — never mask the real crash
                    pass
            raise
        test_acc = self.evaluate(data.test_x, data.test_y,
                                 progress_label="Testing" if cfg.progress else None)
        wall = time.monotonic() - t0
        samples = cfg.epochs * steps_per_epoch * cfg.batch_size
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
