"""Single-device trainer, the counterpart of ``dsml_tpu/trainer.py``: the
reference client's epoch loop (batched training, per-epoch "Average Loss /
Accuracy" lines, a final test accuracy) over any model that exposes
``init(seed)``, ``loss(x, y)`` and ``apply(x)`` as methods of an
``nn.Module`` on its device.

Each step is eager PyTorch: loss, ``backward()``, the optimizer's update
with the schedule's learning rate for that update count (optax's order:
the count BEFORE the update). Batches are drawn as the JAX trainer draws
them (``shard_batches`` shuffled by ``seed + epoch``), so both trainers see
the same batches in the same order.

Not ported yet, and raising: gradient sync algorithms other than ``xla``
and ``dp > 1`` (the data-parallel slice), ``error_feedback`` (the
compressed-communication slice), ``checkpoint_dir``/``resume`` (the
checkpointing slice) and the ``plateau`` schedule. The observability hooks
(sentinels, hang watch, flight recorder, memory ledger) come with the
observability slice.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dsml_tpu_torch.models.common import count_correct
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
    algorithm: str = field("xla", help="gradient sync: xla (single device; the ring and quantized algorithms come with the data-parallel slice)")
    error_feedback: bool = field(False, help="error-feedback residuals for quantized sync (compressed-communication slice)")
    bucket_mb: float = field(0.0, help="gradient bucket size in MiB for explicit sync (data-parallel slice)")
    dp: int = field(0, help="data-parallel devices (0 or 1 = this device; more comes with the data-parallel slice)")
    seed: int = field(0, help="init + shuffle seed")
    log_metrics: str = field("", help="optional JSONL metrics path")
    checkpoint_dir: str = field("", help="checkpoint directory (checkpointing slice; '' = off)")
    save_every: int = field(1, help="checkpoint every N epochs")
    save_every_steps: int = field(0, help="also checkpoint every N steps mid-epoch")
    keep_checkpoints: int = field(3, help="max checkpoints retained")
    resume: bool = field(False, help="resume from the latest checkpoint in checkpoint_dir")
    progress: bool = field(False, help="draw per-epoch train/eval progress bars on stderr")
    sync_every: int = field(32, help="device→host loss sync cadence in steps")


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.algorithm != "xla":
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r}: explicit gradient sync comes with the "
            "data-parallel slice; this trainer runs on one device (algorithm='xla')"
        )
    if cfg.dp > 1:
        raise NotImplementedError(f"dp={cfg.dp}: data parallelism comes with the data-parallel slice")
    if cfg.error_feedback:
        raise NotImplementedError("error_feedback comes with the compressed-communication slice")
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


class Trainer:
    """Train ``model`` (an ``nn.Module`` with ``init(seed)``, ``loss(x, y)``
    and ``apply(x)``) on the device its weights live on."""

    def __init__(self, model, config: TrainConfig | None = None):
        self.model = model
        self.config = config or TrainConfig()
        self.metrics = MetricsLogger(self.config.log_metrics or None)
        self.device = next(model.parameters()).device

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def train(self, data: Dataset, params: dict | None = None):
        """Train for ``cfg.epochs``; ``params`` (a state dict, e.g. from
        ``models.convert.params_from_jax``) replaces ``init(seed)``.
        Returns (the model's state dict, per-epoch history, test
        accuracy)."""
        cfg = self.config
        _check_supported(cfg)
        model = self.model
        steps_per_epoch = data.n_train // cfg.batch_size
        if params is None:
            model.init(cfg.seed)
        else:
            model.load_state_dict(params)
        optimizer, schedule = _make_optimizer(cfg, model.parameters(), steps_per_epoch)
        sync_every = max(cfg.sync_every, 1)
        count = 0  # updates done: the schedule's argument, as optax counts
        history = []
        t0 = time.monotonic()
        for epoch in range(1, cfg.epochs + 1):
            losses = []  # device scalars, synced every sync_every steps
            bar = ProgressBar(steps_per_epoch, desc=f"Epoch {epoch}/{cfg.epochs}",
                              enabled=cfg.progress)
            model.train()
            for x, y in prefetch_batches(
                    shard_batches(data.train_x, data.train_y, cfg.batch_size, seed=cfg.seed + epoch)):
                loss = model.loss(self._to_device(x), self._to_device(y))
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                for group in optimizer.param_groups:
                    group["lr"] = schedule(count)
                optimizer.step()
                count += 1
                losses.append(loss.detach())
                bar.update()
                if len(losses) % sync_every == 0:
                    losses[-1].item()  # bounds how far the host runs ahead
            bar.close()
            em = EpochMetrics()
            for loss in torch.stack(losses).tolist() if losses else []:
                em.update(loss, 0, cfg.batch_size)
            train_acc = self.evaluate(data.train_x, data.train_y)
            log.info("Epoch %d: Average Loss = %.4f, Accuracy = %.2f%%", epoch, em.avg_loss,
                     train_acc * 100)
            history.append(self.metrics.log(epoch=epoch, avg_loss=em.avg_loss,
                                            train_accuracy=train_acc))
        test_acc = self.evaluate(data.test_x, data.test_y,
                                 progress_label="Testing" if cfg.progress else None)
        wall = time.monotonic() - t0
        samples = cfg.epochs * steps_per_epoch * cfg.batch_size
        log.info("Final Test Accuracy: %.2f%%", test_acc * 100)
        self.metrics.log(test_accuracy=test_acc, wall_time_s=wall,
                         samples_per_sec=samples / max(wall, 1e-9))
        return model.state_dict(), history, test_acc

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray, batch_size: int = 2048,
                 progress_label: str | None = None) -> float:
        """Fraction of ``x`` whose argmax logit is ``y``, with the model's
        current weights."""
        n = x.shape[0]
        bar = ProgressBar((n + batch_size - 1) // batch_size, desc=progress_label or "Testing",
                          enabled=progress_label is not None)
        self.model.eval()
        correct = 0
        for start in range(0, n, batch_size):
            logits = self.model.apply(self._to_device(x[start:start + batch_size]))
            correct += int(count_correct(logits, self._to_device(y[start:start + batch_size])))
            bar.update()
        bar.close()
        return correct / max(n, 1)
