"""AlexNet for ImageNet, the port of ``gtopkssgd_tpu/models/alexnet.py``
(the single-tower torchvision variant): five convs with bias, three 3x3/2
VALID max-pools, a 4096-4096-classes classifier with dropout, no
BatchNorm. NHWC input, as the JAX model takes; computes in ``dtype``
(``models.layers``), float32 logits.

flax infers the first Dense layer's input width from the input; here it
is computed from ``image_size`` (256 * 6 * 6 at 224). The features are
flattened in NHWC order, as JAX flattens, so the first Dense kernel's
rows are in (H, W, C) order in the flat gradient too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.models.layers import (
    Conv2d,
    Dropout,
    Linear,
    flax_init,
    float_logits,
    to_compute,
)

# (in, out, kernel, stride, padding) of each conv.
_CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
_POOL_AFTER = (0, 1, 4)  # a 3x3/2 max pool after these convs


def feature_side(image_size: int) -> int:
    """Height (= width) of the last pool's output for a square input."""
    side = image_size
    for i, (_, _, k, s, p) in enumerate(_CONVS):
        side = (side + 2 * p - k) // s + 1
        if i in _POOL_AFTER:
            side = (side - 3) // 2 + 1
    return side


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 image_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, k, stride=s, padding=p)
            for cin, cout, k, s, p in _CONVS)
        width = 256 * feature_side(image_size) ** 2
        self.fcs = nn.ModuleList([Linear(width, 4096),
                                  Linear(4096, 4096),
                                  Linear(4096, num_classes)])
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float32 -> logits f32[B, num_classes]."""
        x = to_compute(x.permute(0, 3, 1, 2), self.compute_dtype)
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten
        x = F.relu(self.fcs[0](self.dropout(x)))
        x = F.relu(self.fcs[1](self.dropout(x)))
        return float_logits(self.fcs[2](x))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
