"""Parameter trees between the JAX package and the port.

The JAX package keeps parameters as a nested tree of dicts and lists
(``{"wte": ..., "layers": [{"attn": {"wqkv": ...}}, ...]}``); the port's
modules name the same tensors by their dotted paths (``layers.0.attn.wqkv``),
with the same shapes. Arrays cross as numpy, so this module needs neither
package's model code: a test turns a JAX tree into numpy with
``jax.tree.map(np.asarray, params)`` and hands it over.

Quantized serving weights cross too: a JAX per-channel leaf is already a
``{"qw", "qs"}`` dict, and a JAX ``QuantizedWeight`` (recognised by its
``qw``/``qs``/``scheme``/``block``/``shape`` attributes, so nothing of the
JAX package is imported) becomes ``<path>.qw`` and ``<path>.qs`` entries,
which a twin from ``models.common.quantize_weights_blocked`` loads: both
packages can then serve from the same codes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def _leaf_to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same 16 bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _is_quantized_weight(node) -> bool:
    return all(hasattr(node, a) for a in ("qw", "qs", "scheme", "block", "shape"))


def params_from_jax(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts/lists of arrays → ``{dotted path: CPU tensor}``, the
    keys and shapes of the port's ``state_dict()``. Pass the result to
    ``load_state_dict``, which copies onto the module's device and type."""
    if _is_quantized_weight(tree):
        tree = {"qw": tree.qw, "qs": tree.qs}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _leaf_to_tensor(tree)}
    out: dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(params_from_jax(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def params_to_numpy(state: dict[str, torch.Tensor]):
    """``{dotted path: tensor}`` → the JAX package's nested tree of numpy
    arrays (a path segment that is an integer indexes a list). bf16 tensors
    come back as f32 arrays, which hold their values exactly."""
    root: dict = {}
    for path, t in state.items():
        t = t.detach().cpu()
        *parents, leaf = path.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..n-1 become lists, recursively."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
