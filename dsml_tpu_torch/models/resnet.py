"""ResNet-18 for CIFAR-10, the counterpart of ``dsml_tpu/models/resnet.py``
(BASELINE config 4).

CIFAR-style ResNet-18: a 3x3 stem of 64 channels, no max-pool, four stages
of :attr:`ResNet18.BLOCKS_PER_STAGE` basic blocks over
:attr:`ResNet18.STAGES` channels, global average pool, ``fc`` from 512
features. The parameters keep the JAX tree's names and layouts
(``stem.w`` HWIO, ``stem.bn.{scale,bias}``, ``stages.<s>.<b>.{conv1,conv2,
down?}.{w,bn}``, ``fc.{w,b}``), and :meth:`ResNet18.init` draws from
``np.random.default_rng(seed)`` in the JAX order — stem, ``fc``, then each
block's conv1, conv2 and down (the JAX dict literal draws ``fc`` before
the stage loop) — so the same seed gives the JAX weights bit for bit. As
in the JAX init, the stem is 64 channels and ``fc`` reads 512 features
whatever ``STAGES`` says.

Convolutions take XLA's ``padding="SAME"``: at stride 2 on an even input a
3x3 pads (0, 1) — one row and column after, none before — which
``F.conv2d(padding=1)`` does not; ``models.common.same_conv`` pads as XLA
does.

Batch norm is always batch-stat, as the JAX model's: the mean, then the
population variance (the mean squared deviation from it), over N, H and
W, ``eps = 1e-5``, no running statistics. Which rows the statistics see is
the caller's: by default this process's rows; inside
:meth:`ResNet18.batch_stats_over` the rows of every rank of a dp group,
the moments summed over the group by a differentiable all-reduce (its
backward sums the cotangents too). The dp step takes the group's rows
under the ``"xla"`` sync and the eval always, as the JAX step and eval,
which see the global batch there; the explicit syncs (``ring``, ``naive``,
the quantized ones) normalise each rank's rows alone, as the JAX
``shard_map`` steps do.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from dsml_tpu_torch.models.common import count_correct, he_init, same_conv, softmax_xent
from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["ResNet18", "group_sum"]

BN_EPS = 1e-5


class _GroupSum(torch.autograd.Function):
    """Sum over a dp group, forward and backward: each rank's cotangent of
    the shared sum reaches every rank's terms."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def _sum(x, group):
    # CPU tensors over gloo in rank order; CUDA ones on the IPC ring
    return all_reduce(x.contiguous(), group, ReduceOp.SUM,
                      "xla" if x.device.type == "cpu" else "auto")


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiably (``x`` itself
    without a group or with one rank)."""
    return x if group is None or group.size == 1 else _GroupSum.apply(x, group)


class ResNet18(nn.Module):
    """CIFAR ResNet-18 on one device (``None`` = the CUDA card). Fill its
    weights with :meth:`init` or ``load_state_dict``."""

    STAGES = (64, 128, 256, 512)
    BLOCKS_PER_STAGE = 2

    def __init__(self, classes: int = 10, channels: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.classes = classes
        self.channels = channels
        self.device = resolve_device(device)
        self.stat_group = None  # the dp group the batch statistics span (None: these rows)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype, device=self.device))

        def conv(k, cin, cout):
            node = nn.Module()
            node.w = param(k, k, cin, cout)
            node.bn = nn.ParameterDict({"scale": param(cout), "bias": param(cout)})
            return node

        self.stem = conv(3, channels, 64)
        stages, in_c = [], 64
        for out_c in self.STAGES:
            blocks = []
            for b in range(self.BLOCKS_PER_STAGE):
                block = nn.Module()
                block.conv1 = conv(3, in_c, out_c)
                block.conv2 = conv(3, out_c, out_c)
                # the JAX init's rule (its stride here is not the forward's)
                if (b == 0 and out_c != 64) or in_c != out_c:
                    block.down = conv(1, in_c, out_c)
                blocks.append(block)
                in_c = out_c
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = nn.ParameterDict({"w": param(512, classes), "b": param(classes)})

    def _convs(self):
        """Every conv node with its fan-in, in the JAX draw order."""
        yield self.stem, 9 * self.channels
        yield None, 512  # fc, drawn before the stages
        for blocks in self.stages:
            for block in blocks:
                for name in ("conv1", "conv2", "down"):
                    node = getattr(block, name, None)
                    if node is not None:
                        k, _, cin, _ = node.w.shape
                        yield node, k * k * cin

    @torch.no_grad()
    def init(self, seed: int = 0) -> "ResNet18":
        """He-normal conv and ``fc`` weights from
        ``np.random.default_rng(seed)`` in the JAX draw order; batch-norm
        scales 1, biases 0. Returns ``self``."""
        rng = np.random.default_rng(seed)
        for node, fan_in in self._convs():
            if node is None:
                self.fc["w"].copy_(he_init(rng, *self.fc["w"].shape, fan_in=fan_in))
                self.fc["b"].zero_()
                continue
            node.w.copy_(he_init(rng, *node.w.shape, fan_in=fan_in))
            node.bn["scale"].fill_(1.0)
            node.bn["bias"].zero_()
        return self

    @contextlib.contextmanager
    def batch_stats_over(self, group):
        """Batch statistics over the rows of every rank of ``group`` inside
        the block (each rank passes its own rows)."""
        saved, self.stat_group = self.stat_group, group
        try:
            yield self
        finally:
            self.stat_group = saved

    def _batch_norm(self, x: torch.Tensor, bn) -> torch.Tensor:
        group = self.stat_group
        n = x.shape[0] * x.shape[2] * x.shape[3] * (1 if group is None else group.size)
        mean = group_sum(x.sum((0, 2, 3)), group) / n
        d = x - mean[:, None, None]
        var = group_sum((d * d).sum((0, 2, 3)), group) / n
        return (d * torch.rsqrt(var + BN_EPS)[:, None, None] * bn["scale"][:, None, None]
                + bn["bias"][:, None, None])

    def _conv_bn(self, node, h, stride=1):
        return self._batch_norm(same_conv(h, node.w, stride), node.bn)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x``: NHWC images or flat ``[B, H·W·C]`` (square)
        pixels."""
        if x.dim() == 2:
            side = int(np.sqrt(x.shape[1] // self.channels))
            x = x.reshape(-1, side, side, self.channels)
        h = x.to(self.stem.w.dtype).permute(0, 3, 1, 2)
        h = torch.relu(self._conv_bn(self.stem, h))
        for s, blocks in enumerate(self.stages):
            for b, block in enumerate(blocks):
                stride = 2 if (b == 0 and s != 0) else 1
                r = torch.relu(self._conv_bn(block.conv1, h, stride))
                r = self._conv_bn(block.conv2, r)
                down = getattr(block, "down", None)
                shortcut = h if down is None else self._conv_bn(down, h, stride)
                h = torch.relu(r + shortcut)
        h = h.mean((2, 3))  # global average pool
        return h @ self.fc["w"] + self.fc["b"]

    forward = apply

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy against integer labels ``y``."""
        return softmax_xent(self.apply(x), y)

    @torch.no_grad()
    def accuracy_count(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """How many rows of ``x`` have their argmax logit at ``y``."""
        return count_correct(self.apply(x), y)
