"""Launch GPUDevice servers in one process — the port's counterpart of
``dsml_tpu/cli/launch_devices.py`` (the reference's
``DSML/cmd/gpu_device_server/main.go``: 3 servers on ports 5003-5005).

Each server fronts a torch device: the cards round-robin by default (on
one card every server shares ``cuda:0``), ``--device cpu`` when asked.

Usage:
    python -m dsml_tpu_torch.cli.launch_devices --num_devices 3 --base_port 5003
"""

from __future__ import annotations

import dataclasses
import json
import time

from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class DeviceHostConfig(Config):
    num_devices: int = field(0, help="number of device servers (0 = one per card)")
    base_port: int = field(5003, help="first port; server i binds base_port+i (0 = ephemeral)")
    base_device_id: int = field(1, help="deviceId of the first server (the reference uses 1..3)")
    # large enough for the MLP weight and gradient buffers (~437 KB each)
    mem_size: int = field(0x400000, help="per-device address-space size in bytes")
    host: str = field("127.0.0.1", help="bind address")
    mlp_sizes: tuple[int, ...] = field(default_factory=lambda: (784, 128, 64, 10),
                                       help="layer sizes of the on-device MLP "
                                       "(RunForward/RunBackward)")
    device: str = field("", help="torch device of every server ('' = the cards, round-robin)")


def main(argv=None) -> None:
    cfg = DeviceHostConfig.parse_args(argv)
    import torch

    from dsml_tpu_torch.comm.device_server import serve_local_devices
    from dsml_tpu_torch.models.mlp import MLP
    from dsml_tpu_torch.utils.logging import get_logger
    from dsml_tpu_torch.utils.platform import resolve_device

    log = get_logger("launch")
    device = cfg.device or None
    n = cfg.num_devices or (torch.cuda.device_count() if device is None else 1)
    ports = None if cfg.base_port == 0 else [cfg.base_port + i for i in range(n)]
    handles = serve_local_devices(n, base_device_id=cfg.base_device_id, mem_size=cfg.mem_size,
                                  ports=ports, device=device,
                                  model=MLP(cfg.mlp_sizes, device=resolve_device(device)))
    for h in handles:
        log.info("device %d on %s (torch device: %s)", h.runtime.device_id, h.address,
                 h.runtime.device)
    # one machine-readable line for launchers that bind ephemeral ports
    print(json.dumps({"devices": [h.address for h in handles]}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        for h in handles:
            h.stop()


if __name__ == "__main__":
    main()
