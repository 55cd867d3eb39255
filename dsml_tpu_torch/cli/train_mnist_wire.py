"""Train the MNIST MLP through the wire API — the port's counterpart of
``examples/train_mnist_wire.py``, the reference's own workload and
architecture with real semantics at every hop.

Per batch:
  1. shard the global batch over the ranks, ``Memcpy`` each shard H2D;
  2. ``RunForward`` on every device (the MLP's flat forward on its card);
  3. read the logits back, compute dL/dlogits on the host;
  4. ``Memcpy`` the dlogits, ``RunBackward`` → per-rank parameter gradients
     in device memory;
  5. the coordinator's ``AllReduceRing(AVG)`` over the per-rank gradients;
  6. read the reduced gradients once, SGD on the host, broadcast the new
     weights.

Boots its own cluster in this process by default (3 device servers, as the
reference's launcher, on the card unless ``--device cpu``); point
``--coordinator``/``--devices`` at live servers to drive an external one.
:func:`train_wire` is the loop, over a :class:`~dsml_tpu_torch.comm.client.
PipelineClient` or a :class:`LocalClient` (the same calls made on the
runtimes directly, without the wire).

    python -m dsml_tpu_torch.cli.train_mnist_wire --epochs 1
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from dsml_tpu_torch.utils.config import Config, field

INPUT_ADDR = 0x10000
LOGITS_ADDR = 0x20000
GRAD_ADDR = 0x1000  # the reference client's conventional addresses
WEIGHTS_ADDR = 0x2000
AVG = 4  # gpu_sim.ReduceOp.AVG


@dataclasses.dataclass
class WireConfig(Config):
    epochs: int = field(3, help="training epochs")
    batch_size: int = field(64, help="global batch size")
    lr: float = field(0.1, help="SGD learning rate")
    n_devices: int = field(3, help="device servers of the self-booted cluster")
    device: str = field("", help="torch device of the self-booted servers ('' = the card)")
    coordinator: str = field("", help="external coordinator address ('' = boot in-process)")
    devices: tuple[str, ...] = field(default_factory=tuple, help="external device addresses")
    data_dir: str = field("data/mnist", help="IDX data directory")


class LocalClient:
    """The :class:`PipelineClient` calls the wire loop makes, made on the
    runtimes directly (the calls the servicers make): the same bytes
    through the same device and coordinator code, without gRPC."""

    def __init__(self, coordinator, runtimes: list, comm_id: int):
        self.coordinator = coordinator
        self.runtimes = runtimes
        self.comm_id = comm_id
        self.devices = runtimes

    def write(self, rank: int, addr: int, data) -> None:
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data, np.float32).tobytes()
        rt = self.runtimes[rank]
        rt.bind_thread()
        rt.memcpy_h2d(addr, data)

    def read(self, rank: int, addr: int, num_bytes: int) -> bytes:
        return self.runtimes[rank].memcpy_d2h(addr, num_bytes or None)

    def broadcast_weights(self, weights: np.ndarray, addr: int = WEIGHTS_ADDR) -> None:
        data = np.ascontiguousarray(weights, np.float32).tobytes()
        for rank in range(len(self.runtimes)):
            self.write(rank, addr, data)

    def run_forward(self, rank: int, input_addr: int, output_addr: int) -> int:
        return self.runtimes[rank].run_forward(input_addr, output_addr)

    def run_backward(self, rank: int, gradient_addr: int) -> None:
        self.runtimes[rank].run_backward(gradient_addr)

    def all_reduce_ring(self, num_bytes: int, op: int = 0, mem_addrs: dict | None = None,
                        dtype: str = "") -> None:
        self.coordinator.all_reduce_ring(self.comm_id, num_bytes, op, mem_addrs or {}, dtype)


def _bytes_to_f32(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.float32).copy()


def wire_step(client, flat: np.ndarray, x: np.ndarray, y: np.ndarray, lr: float,
              n_out: int = 10) -> tuple[np.ndarray, list[float]]:
    """One batch of the wire loop (steps 1-6 of the module docstring);
    returns the new flat weights (already broadcast) and each rank's
    loss. The host arithmetic is the JAX example's, in float32."""
    n_ranks = len(client.devices)
    shard = x.shape[0] // n_ranks
    losses, dlogits = [], []
    for r in range(n_ranks):
        client.write(r, INPUT_ADDR, x[r * shard:(r + 1) * shard])
        client.run_forward(r, INPUT_ADDR, LOGITS_ADDR)
    for r in range(n_ranks):
        logits = _bytes_to_f32(client.read(r, LOGITS_ADDR, shard * n_out * 4)).reshape(shard, n_out)
        ys = y[r * shard:(r + 1) * shard]
        # the softmax cross-entropy gradient with respect to the logits,
        # mean over the shard
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        losses.append(float(-np.log(p[np.arange(shard), ys] + 1e-12).mean()))
        d = p
        d[np.arange(shard), ys] -= 1.0
        dlogits.append((d / shard).astype(np.float32))
    for r in range(n_ranks):
        client.write(r, GRAD_ADDR, dlogits[r])
        client.run_backward(r, GRAD_ADDR)
    client.all_reduce_ring(flat.nbytes, op=AVG, mem_addrs={r: GRAD_ADDR for r in range(n_ranks)})
    grads = _bytes_to_f32(client.read(0, GRAD_ADDR, flat.nbytes))
    flat = flat - lr * grads
    client.broadcast_weights(flat, WEIGHTS_ADDR)
    return flat, losses


def train_wire(client, data, flat: np.ndarray, epochs: int = 1, steps: int = 0,
               batch_size: int = 64, lr: float = 0.1, on_step=None) -> dict:
    """The wire loop from the flat weights ``flat`` over ``data``
    (``utils.data.Dataset``), batches in the JAX example's order (epoch e
    shuffled with seed e, the rows gathered by the native loader). Stops
    after ``steps`` steps when that is > 0. ``on_step(step, flat,
    losses)`` is called after each step. Returns ``{"flat", "losses"
    (per step, the ranks' mean), "steps", "seconds"}``."""
    from dsml_tpu_torch.utils.data import shard_batches

    flat = np.asarray(flat, np.float32)
    client.broadcast_weights(flat, WEIGHTS_ADDR)
    losses, step = [], 0
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        for x, y in shard_batches(data.train_x, data.train_y, batch_size, seed=epoch, native=True):
            if x.shape[0] // len(client.devices) == 0:
                continue
            flat, rank_losses = wire_step(client, flat, x, y, lr)
            losses.append(float(np.mean(rank_losses)))
            step += 1
            if on_step is not None:
                on_step(step, flat, rank_losses)
            if steps and step >= steps:
                break
        if steps and step >= steps:
            break
    return {"flat": flat, "losses": losses, "steps": step,
            "seconds": time.perf_counter() - t0}


def accuracy(model, flat: np.ndarray, x: np.ndarray, y: np.ndarray) -> float:
    """Share of ``x`` whose argmax logit under ``flat`` is its label,
    computed on the model's device."""
    import torch

    dev = model.device
    logits = model.forward_flat(torch.from_numpy(np.asarray(flat, np.float32)).to(dev),
                                torch.from_numpy(np.asarray(x, np.float32)).to(dev))
    return float((logits.argmax(-1).cpu().numpy() == y).mean())


def main(argv=None) -> float:
    cfg = WireConfig.parse_args(argv)
    from dsml_tpu_torch.comm.client import PipelineClient
    from dsml_tpu_torch.comm.coordinator import serve_coordinator
    from dsml_tpu_torch.comm.device_server import serve_local_devices
    from dsml_tpu_torch.models.mlp import MLP
    from dsml_tpu_torch.utils.data import load_mnist
    from dsml_tpu_torch.utils.logging import get_logger
    from dsml_tpu_torch.utils.platform import resolve_device

    log = get_logger("wire-train")
    device = resolve_device(cfg.device or None)
    model = MLP(device=device)  # 784-128-64-10
    handles, coordinator = [], None
    if cfg.coordinator:
        coord_addr, device_addrs = cfg.coordinator, list(cfg.devices)
    else:
        handles = serve_local_devices(cfg.n_devices, mem_size=0x1000000, model=model,
                                      device=cfg.device or None)
        coordinator = serve_coordinator()
        coord_addr, device_addrs = coordinator.address, [h.address for h in handles]
    client = PipelineClient.connect(coord_addr, device_addrs)
    data = load_mnist(cfg.data_dir)
    flat = model.init(0).flatten().cpu().numpy()
    t0 = time.monotonic()
    out = train_wire(client, data, flat, epochs=cfg.epochs, batch_size=cfg.batch_size,
                     lr=cfg.lr)
    log.info("%d steps: first loss %.4f, last loss %.4f", out["steps"], out["losses"][0],
             out["losses"][-1])
    acc = accuracy(model, out["flat"], data.test_x, data.test_y)
    log.info("Final Test Accuracy: %.2f%% (wall %.1fs)", acc * 100, time.monotonic() - t0)
    client.finalize()
    if coordinator is not None:
        coordinator.stop()
    for h in handles:
        h.stop()
    return acc


if __name__ == "__main__":
    main()
