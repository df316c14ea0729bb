"""ResNets, the port of ``gtopkssgd_tpu/models/resnet.py``: the CIFAR
ResNets (ResNet-20/56) and the ImageNet bottleneck ResNet (ResNet-50).

* ``ResNetCIFAR``: He et al.'s CIFAR design, 3x3 stem, three stages of
  basic blocks at widths 16/32/64, depth = 6n+2, global average pool,
  linear head.
* ``ResNetImageNet``: 7x7/2 stem (or the space-to-depth stem) and a 3x3/2
  max pool, stages [3, 4, 6, 3] of bottleneck blocks at widths
  256/512/1024/2048 for ResNet-50, the stride on the 3x3 conv, the last
  BatchNorm of each block starting at scale 0.

A 1x1 projection shortcut where the shape changes. The models take NHWC
input, as the JAX models do, and permute to NCHW once inside. ``dtype``
is flax's compute dtype (``models.layers``): the input is cast to it
once, every layer and BatchNorm output stays in it, and the logits come
back in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Linear,
    flax_init,
    float_logits,
    to_compute,
)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  bias=False)


def _shortcut(cin: int, filters: int, stride: int):
    if cin == filters and stride == 1:
        return None
    return nn.Sequential(_conv(cin, filters, 1, stride), BatchNorm(filters))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.shortcut = _shortcut(cin, filters, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """`filters` is the output width, 4x the inner width."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        inner = filters // 4
        self.conv1 = _conv(cin, inner, 1)
        self.bn1 = BatchNorm(inner)
        self.conv2 = _conv(inner, inner, 3, stride)
        self.bn2 = BatchNorm(inner)
        self.conv3 = _conv(inner, filters, 1)
        self.bn3 = BatchNorm(filters, zero_scale=True)
        self.shortcut = _shortcut(cin, filters, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


class ResNetCIFAR(nn.Module):
    def __init__(self, depth: int = 20, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        if (depth - 2) % 6 != 0:
            raise ValueError("CIFAR ResNet depth must be 6n+2")
        n = (depth - 2) // 6
        self.conv = _conv(3, 16, 3)
        self.bn = BatchNorm(16)
        blocks, cin = [], 16
        for stage, width in enumerate((16, 32, 64)):
            for block in range(n):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(cin, width, stride))
                cin = width
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float32 -> logits f32[B, num_classes]."""
        x = to_compute(x.permute(0, 3, 1, 2), self.compute_dtype)
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return float_logits(self.fc(x.mean(dim=(2, 3))))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class ResNetImageNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, space_to_depth: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.space_to_depth = space_to_depth
        self.compute_dtype = dtype
        if space_to_depth:
            # 2x2 pixel blocks as 12 channels, then a 4x4 VALID conv: the
            # same linear map as an 8x8/2 conv, a superset of the 7x7/2.
            self.conv = Conv2d(12, 64, 4, bias=False)
        else:
            self.conv = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn = BatchNorm(64)
        blocks, cin = [], 64
        for stage, size in enumerate(stage_sizes):
            width = 256 * 2 ** stage
            for block in range(size):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BottleneckBlock(cin, width, stride))
                cin = width
        self.bottlenecks = nn.ModuleList(blocks)
        self.fc = Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float32 -> logits f32[B, num_classes]."""
        if self.space_to_depth:
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"--s2d needs even input H/W (2x2 pixel "
                                 f"blocks), got {h}x{w}")
            # The JAX stem's NHWC rearrangement, so that the carried
            # (4, 4, 12, 64) kernel reads channels in (dy, dx, c) order.
            x = F.pad(x, (0, 0, 3, 3, 3, 3))
            x = x.reshape(b, (h + 6) // 2, 2, (w + 6) // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(
                b, (h + 6) // 2, (w + 6) // 2, 4 * c)
        x = to_compute(x.permute(0, 3, 1, 2), self.compute_dtype)
        x = F.relu(self.bn(self.conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.bottlenecks:
            x = block(x)
        return float_logits(self.fc(x.mean(dim=(2, 3))))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
