"""numpy's names of torch dtypes: the names the JAX package writes where a
dtype crosses a process or a file (checkpoint manifests, migration
descriptors, the coordinator's AllReduceRing ``dtype``)."""

from __future__ import annotations

import torch

__all__ = ["DTYPE_NAMES", "TORCH_DTYPES"]

DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
TORCH_DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}
