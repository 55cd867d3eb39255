"""Train the MNIST MLP or CNN data-parallel — the port's counterpart of
``examples/train_mnist.py``: the reference client's run (10 epochs, batch
64, SGD lr 0.01, per-epoch "Average Loss / Accuracy" lines, a final test
accuracy) through ``trainer.Trainer``, on one device or over ``--dp N``
ranks whose gradients sync for real.

    python -m dsml_tpu_torch.cli.train_mnist --epochs 10
    python -m dsml_tpu_torch.cli.train_mnist --model cnn --epochs 1 --lr 0.05 --optimizer momentum
    python -m dsml_tpu_torch.cli.train_mnist --dp 2 --algorithm ring
    python -m dsml_tpu_torch.cli.train_mnist --device cpu --model cnn --epochs 1

``--model mlp`` is the reference's 784-``--hidden``-10 MLP; ``--model cnn``
BASELINE config 3 (``models.cnn.CNN``). ``--dp N`` spawns one rank
(``torch.multiprocessing``) per position of a dp mesh, joined over gloo
through a rendezvous file in a temporary directory; each trains on its
rows of the same global batches and syncs with ``--algorithm``. Rank r runs
on ``cuda:{r % device_count}`` (ranks share a card when there are fewer
cards), or on the CPU with ``--device cpu``; rank 0 logs. Runs on the CUDA
card unless ``--device cpu``: without a card it raises, never falling back
to the CPU.

:func:`train` is the loop both this entry point and
``cli/train_cifar_resnet.py`` run: a model and a dataset factory, one
device or ``cfg.dp`` spawned ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable

import torch

from dsml_tpu_torch.trainer import TrainConfig
from dsml_tpu_torch.utils.config import field


@dataclasses.dataclass
class MNISTConfig(TrainConfig):
    device: str = field("cuda", help="torch device: cuda | cpu (ranks on cuda:{r % device_count})")
    data_dir: str = field("data/mnist", help="IDX data directory")
    model: str = field("mlp", help="mlp | cnn (BASELINE config 3: CNN + data-parallel gradient sync)")
    hidden: tuple[int, ...] = field(default_factory=lambda: (128, 64),
                                    help="hidden layer sizes (reference README documents 128,64)")


def mnist_model(cfg: MNISTConfig, device):
    from dsml_tpu_torch.models import CNN, MLP

    if cfg.model == "cnn":
        return CNN(device=device)
    if cfg.model == "mlp":
        return MLP(sizes=(784, *cfg.hidden, 10), device=device)
    raise SystemExit(f"unknown --model {cfg.model!r}; choose mlp | cnn")


def mnist_data(cfg: MNISTConfig):
    from dsml_tpu_torch.utils.data import load_mnist

    return load_mnist(cfg.data_dir)


def train(cfg, make_model: Callable, make_data: Callable) -> dict:
    """Train ``make_model(cfg, device)`` on ``make_data(cfg)`` with the
    ``Trainer`` on ``cfg.device``, or on ``cfg.dp`` spawned ranks (module-
    level factories: the ranks import them). Returns rank 0's
    ``{"test_accuracy", "history"}``."""
    if cfg.dp > 1:
        return _spawn(cfg, make_model, make_data)
    return _train(cfg, make_model, make_data, None)


def _train(cfg, make_model, make_data, mesh) -> dict:
    from dsml_tpu_torch.trainer import Trainer

    device = cfg.device if mesh is None else mesh.device
    data = make_data(cfg)
    _, history, test_acc = Trainer(make_model(cfg, device), cfg, mesh=mesh).train(data)
    return {"test_accuracy": test_acc, "history": history}


def _spawn(cfg, make_model, make_data) -> dict:
    """Run ``cfg.dp`` ranks of :func:`_rank` and return rank 0's result; a
    rank that raises fails the run."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dsml_ranks_") as tmp:
        mp.spawn(_rank, args=(cfg, make_model, make_data, tmp), nprocs=cfg.dp, join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            return json.load(f)


def _rank(rank: int, cfg, make_model, make_data, tmp: str) -> None:
    import torch.distributed as dist

    from dsml_tpu_torch.parallel.mesh import data_mesh
    from dsml_tpu_torch.utils.logging import get_logger

    # rank r on cuda:{r % device_count}: a placement, never a CPU fallback
    device = "cpu" if torch.device(cfg.device).type == "cpu" else None
    if device == "cpu":
        # the ranks share the host: half its cores split between them (more
        # threads a rank starve gloo's transport threads)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * cfg.dp)))
    mesh = data_mesh(cfg.dp, rank, os.path.join(tmp, "rendezvous"), device)
    get_logger("trainer").info("dp rank %d of %d on %s", rank, cfg.dp, mesh.device)
    try:
        out = _train(cfg, make_model, make_data, mesh)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        mesh.close()
        dist.destroy_process_group()


def main(argv=None) -> float:
    cfg = MNISTConfig.parse_args(argv)
    return train(cfg, mnist_model, mnist_data)["test_accuracy"]


if __name__ == "__main__":
    main()
