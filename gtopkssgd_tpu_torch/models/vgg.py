"""VGG-16 for CIFAR-10, the port of ``gtopkssgd_tpu/models/vgg.py``:
configuration D, 13 bias-free 3x3 convs each followed by BatchNorm and
ReLU, five 2x2 max-pools down to 1x1x512, then 512 -> 512 -> classes with
dropout. NHWC input, as the JAX model takes; computes in ``dtype``
(``models.layers``), float32 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Dropout,
    Linear,
    flax_init,
    float_logits,
    to_compute,
)

# Configuration D feature stack; "M" = 2x2 max pool.
_CFG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        widths = [v for v in _CFG_D if v != "M"]
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, 3, padding=1, bias=False)
            for cin, cout in zip([3] + widths[:-1], widths))
        self.bns = nn.ModuleList(BatchNorm(w) for w in widths)
        # 512 features after five pools on 32x32 (flax infers the width).
        self.fcs = nn.ModuleList([Linear(512, 512),
                                  Linear(512, num_classes)])
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float32 -> logits f32[B, num_classes]."""
        x = to_compute(x.permute(0, 3, 1, 2), self.compute_dtype)
        layers = iter(zip(self.convs, self.bns))
        for v in _CFG_D:
            if v == "M":
                x = F.max_pool2d(x, 2)
            else:
                conv, bn = next(layers)
                x = F.relu(bn(conv(x)))
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten
        x = self.dropout(F.relu(self.fcs[0](x)))
        return float_logits(self.fcs[1](x))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
