"""Parameter trees between the JAX package and the port.

The JAX package keeps parameters as a nested tree of dicts and lists
(``{"wte": ..., "layers": [{"attn": {"wqkv": ...}}, ...]}``); the port's
modules name the same tensors by their dotted paths (``layers.0.attn.wqkv``;
ResNet-18's list of stages of lists of blocks as ``stages.1.0.conv1.w``),
with the same shapes. Arrays cross as numpy, so this module needs neither
package's model code: a test turns a JAX tree into numpy with
``jax.tree.map(np.asarray, params)`` and hands it over.

Quantized serving weights cross too: a JAX per-channel leaf is already a
``{"qw", "qs"}`` dict, and a JAX ``QuantizedWeight`` (recognised by its
``qw``/``qs``/``scheme``/``block``/``shape`` attributes, so nothing of the
JAX package is imported) becomes ``<path>.qw`` and ``<path>.qs`` entries,
which a twin from ``models.common.quantize_weights_blocked`` loads: both
packages can then serve from the same codes.

A rank of a model-parallel mesh takes its shard of a whole JAX tree
(``params_from_jax(tree, model=...)``): the Megatron cut of the model's
``param_specs`` (``wqkv [d, 3, d]`` on its last axis), the layers this
pipeline stage holds (from a list of layers, or from the JAX stacked form,
whose layer axis ``init_hybrid`` permuted for the interleaved schedule),
renamed to the stage's positions. :func:`zero2_shards_from_jax` cuts the
flat ZeRO-2 buckets as the JAX ``_local_shards`` does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mlp_flat_from_jax", "params_from_jax", "params_to_numpy", "zero2_shards_from_jax"]


def _leaf_to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same 16 bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _is_quantized_weight(node) -> bool:
    return all(hasattr(node, a) for a in ("qw", "qs", "scheme", "block", "shape"))


def params_from_jax(tree, prefix: str = "", model=None,
                    layer_order=None) -> dict[str, torch.Tensor]:
    """Nested dicts/lists of arrays → ``{dotted path: CPU tensor}``, the
    keys and shapes of the port's ``state_dict()``. Pass the result to
    ``load_state_dict``, which copies onto the module's device and type.

    With ``model`` (a tensor-parallel shard or pipeline stage of the port)
    the result is that rank's state dict: the whole tree's leaves (the
    layers a list, or stacked on a leading axis whose position i holds
    layer ``layer_order[i]``, default i) cut by ``model.param_specs()`` and
    renamed to the stage's layer positions."""
    if model is not None:
        full = params_from_jax({k: v for k, v in tree.items() if k != "layers"})
        layers = tree.get("layers")
        if isinstance(layers, dict):  # the JAX stacked form
            stacked = params_from_jax(layers)
            n = next(iter(stacked.values())).shape[0]
            for pos, lid in enumerate(range(n) if layer_order is None else layer_order):
                full.update({f"layers.{lid}.{k}": v[pos] for k, v in stacked.items()})
        elif layers is not None:
            full.update(params_from_jax(layers, "layers"))
        return {k: t.contiguous() for k, t in model.local_shards(full).items()}
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


def mlp_flat_from_jax(params, sizes=(784, 128, 64, 10)) -> torch.Tensor:
    """A JAX MLP's parameter dict (``w0, b0, w1, …`` as numpy) as the
    port's flat f32 vector ``[W0, b0, W1, b1, …]`` (``MLP.flatten``'s
    layout, the JAX ``MLP.flatten``'s too)."""
    n_layers = len(sizes) - 1
    leaves = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w, b = np.asarray(params[f"w{i}"], np.float32), np.asarray(params[f"b{i}"], np.float32)
        if w.shape != (fan_in, fan_out) or b.shape != (fan_out,):
            raise ValueError(f"layer {i} of {n_layers}: w{w.shape} b{b.shape}, expected "
                             f"({fan_in}, {fan_out}) and ({fan_out},)")
        leaves += [w.reshape(-1), b.reshape(-1)]
    return torch.from_numpy(np.concatenate(leaves))


def zero2_shards_from_jax(flat_buckets, n: int, rank: int) -> list[torch.Tensor]:
    """Rank ``rank``'s segment of every flat ZeRO-2 bucket (arrays of the
    JAX ``flatten_buckets``), zero-padded to a multiple of ``n`` first, as
    the JAX ``_local_shards``."""
    out = []
    for flat in flat_buckets:
        t = _leaf_to_tensor(flat)
        padded = -(-t.shape[0] // n) * n
        t = torch.cat([t, t.new_zeros(padded - t.shape[0])])
        seg = padded // n
        out.append(t[rank * seg:(rank + 1) * seg].clone())
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
