"""MNIST CNN (2×conv + 2×fc), the counterpart of ``dsml_tpu/models/cnn.py``
(BASELINE config 3).

The parameters keep the JAX package's names and layouts — ``conv1.w``
HWIO ``[3, 3, channels, 32]``, ``conv1.b``, ``conv2.*``, ``fc1.w``
``[flat, 128]`` used as ``x @ w + b``, ``fc2.*`` — so
``models.convert.params_from_jax``, ``checkpoint.optim_state.param_tree``
and checkpoints need no mapping; the convolutions permute the HWIO weight
to PyTorch's OIHW at the call (``models.common.same_conv``).
:meth:`CNN.init` draws from ``np.random.default_rng(seed)`` in the JAX
order (conv1, conv2, fc1, fc2): the same seed gives the JAX weights bit
for bit.

Activations run NCHW (cuDNN's layout); the pooled map is flattened in the
JAX package's NHWC order, so ``fc1`` sees the same vector.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsml_tpu_torch.models.common import count_correct, he_init, same_conv, softmax_xent
from dsml_tpu_torch.utils.platform import resolve_device

__all__ = ["CNN"]


class CNN(nn.Module):
    """conv3x3(32) → pool → conv3x3(64) → pool → fc(128) → fc(classes), on
    one device (``None`` = the CUDA card). Fill its weights with
    :meth:`init` or ``load_state_dict``."""

    def __init__(self, image_size: int = 28, channels: int = 1, classes: int = 10,
                 conv_features: tuple[int, int] = (32, 64), fc_width: int = 128,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.image_size = image_size
        self.channels = channels
        self.classes = classes
        self.conv_features = tuple(conv_features)
        self.fc_width = fc_width
        self.device = resolve_device(device)
        self._flat = (image_size // 4) * (image_size // 4) * self.conv_features[1]
        c1, c2 = self.conv_features

        def layer(*shape):
            return nn.ParameterDict({
                "w": nn.Parameter(torch.empty(*shape, dtype=dtype, device=self.device)),
                "b": nn.Parameter(torch.empty(shape[-1], dtype=dtype, device=self.device))})

        self.conv1 = layer(3, 3, channels, c1)
        self.conv2 = layer(3, 3, c1, c2)
        self.fc1 = layer(self._flat, fc_width)
        self.fc2 = layer(fc_width, classes)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "CNN":
        """He-normal weights from ``np.random.default_rng(seed)`` in the JAX
        draw order, zero biases. Returns ``self``."""
        rng = np.random.default_rng(seed)
        c1 = self.conv_features[0]
        for layer, fan_in in ((self.conv1, 9 * self.channels), (self.conv2, 9 * c1),
                              (self.fc1, self._flat), (self.fc2, self.fc_width)):
            layer["w"].copy_(he_init(rng, *layer["w"].shape, fan_in=fan_in))
            layer["b"].zero_()
        return self

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x``: NHWC images or flat ``[B, H·W·C]`` pixels."""
        h = x.to(self.conv1["w"].dtype).reshape(-1, self.image_size, self.image_size,
                                                 self.channels).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2):
            h = F.max_pool2d(torch.relu(same_conv(h, conv["w"]) + conv["b"][:, None, None]), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # the JAX NHWC flatten
        h = torch.relu(h @ self.fc1["w"] + self.fc1["b"])
        return h @ self.fc2["w"] + self.fc2["b"]

    forward = apply

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy against integer labels ``y``."""
        return softmax_xent(self.apply(x), y)

    @torch.no_grad()
    def accuracy_count(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """How many rows of ``x`` have their argmax logit at ``y``."""
        return count_correct(self.apply(x), y)
