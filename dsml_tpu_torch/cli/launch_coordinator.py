"""Launch the GPUCoordinator server — the port's counterpart of
``dsml_tpu/cli/launch_coordinator.py`` (the reference's
``DSML/cmd/gpu_coordinator_server/main.go``, :50051). Health-loop cadence,
dial retries and the collective algorithm are flags.

Usage:
    python -m dsml_tpu_torch.cli.launch_coordinator --port 50051
"""

from __future__ import annotations

import dataclasses
import json
import time

from dsml_tpu_torch.comm.coordinator import CoordinatorConfig
from dsml_tpu_torch.utils.config import Config, field


@dataclasses.dataclass
class CoordinatorCLIConfig(Config):
    port: int = field(50051, help="bind port (the reference's default; 0 = ephemeral)")
    host: str = field("127.0.0.1", help="bind address")
    coordinator: CoordinatorConfig = field(default_factory=CoordinatorConfig)


def main(argv=None) -> None:
    cfg = CoordinatorCLIConfig.parse_args(argv)
    from dsml_tpu_torch.comm.coordinator import serve_coordinator
    from dsml_tpu_torch.utils.logging import get_logger

    handle = serve_coordinator(port=cfg.port, config=cfg.coordinator, host=cfg.host)
    get_logger("launch").info("coordinator on %s", handle.address)
    print(json.dumps({"coordinator": handle.address}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        handle.stop()


if __name__ == "__main__":
    main()
