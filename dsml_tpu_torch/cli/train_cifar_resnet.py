"""CIFAR-10 ResNet-18, data-parallel with the ring all-reduce and the
adaptive learning rate — the port's counterpart of
``examples/train_cifar_resnet.py`` (BASELINE config 4: "CIFAR-10
ResNet-18, ring AllReduce + adaptive LR scheduler").

The config-4 defaults: global batch 256, lr 0.1, momentum, the ``ring``
sync and the reduce-on-plateau scheduler (``--lr_schedule plateau``).
CIFAR-10's binary batches are read from ``--data_dir`` when present
(``data_batch_*.bin`` and ``test_batch.bin``, the 3073-byte records: a
label byte, then the 32x32x3 image CHW planar, turned NHWC in [0, 1]);
without them the run falls back to a synthetic 10-class image workload of
``--synth_n`` samples and logs a warning, as the JAX example does.

    python -m dsml_tpu_torch.cli.train_cifar_resnet --epochs 30
    python -m dsml_tpu_torch.cli.train_cifar_resnet --dp 2 --epochs 2
    python -m dsml_tpu_torch.cli.train_cifar_resnet --device cpu --epochs 1 --synth_n 64 \\
        --batch_size 16

Runs on the CUDA card unless ``--device cpu`` (never falling back);
``--dp N`` spawns N ranks as ``cli/train_mnist.py`` does.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from dsml_tpu_torch.cli.train_mnist import train
from dsml_tpu_torch.trainer import TrainConfig
from dsml_tpu_torch.utils.config import field


@dataclasses.dataclass
class CIFARConfig(TrainConfig):
    device: str = field("cuda", help="torch device: cuda | cpu (ranks on cuda:{r % device_count})")
    data_dir: str = field("data/cifar10", help="CIFAR-10 binary-batch directory")
    synth_n: int = field(4096, help="synthetic sample count when no dataset on disk")
    # config-4 defaults: ring gradient sync + adaptive LR
    batch_size: int = field(256, help="GLOBAL batch size")
    lr: float = field(0.1, help="base learning rate")
    optimizer: str = field("momentum", help="sgd | momentum | adam | adamw")
    algorithm: str = field("ring", help="gradient sync: xla | ring | naive (and the rest of the Trainer's)")
    lr_schedule: str = field("plateau", help="adaptive reduce-on-plateau (BASELINE config 4)")


def read_cifar_bin(path: str):
    """One CIFAR-10 binary batch → (x NHWC float32 in [0, 1], y int32)."""
    raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
    y = raw[:, 0].astype(np.int32)
    # stored CHW planar → NHWC float
    x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    return x, y


def load_cifar10(data_dir: str, synth_n: int, seed: int):
    """CIFAR-10 binary batches → ``Dataset``; the synthetic fallback
    without them."""
    from dsml_tpu_torch.utils.data import Dataset, synthetic_classification
    from dsml_tpu_torch.utils.logging import get_logger

    train_bins = sorted(glob.glob(os.path.join(data_dir, "data_batch_*.bin")))
    test_bin = os.path.join(data_dir, "test_batch.bin")
    if not train_bins or not os.path.exists(test_bin):
        get_logger("cifar").warning(
            "no CIFAR-10 binaries under %s; using a synthetic 10-class image workload", data_dir)
        return synthetic_classification(synth_n, 32 * 32 * 3, seed=seed, image_shape=(32, 32, 3))
    xs, ys = zip(*(read_cifar_bin(p) for p in train_bins))
    test_x, test_y = read_cifar_bin(test_bin)
    return Dataset(np.concatenate(xs), np.concatenate(ys), test_x, test_y)


def cifar_model(cfg: CIFARConfig, device):
    from dsml_tpu_torch.models import ResNet18

    return ResNet18(device=device)


def cifar_data(cfg: CIFARConfig):
    return load_cifar10(cfg.data_dir, cfg.synth_n, cfg.seed)


def main(argv=None) -> float:
    cfg = CIFARConfig.parse_args(argv)
    return train(cfg, cifar_model, cifar_data)["test_accuracy"]


if __name__ == "__main__":
    main()
