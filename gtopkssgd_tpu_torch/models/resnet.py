"""CIFAR ResNets (ResNet-20/56), the port of
``gtopkssgd_tpu/models/resnet.py``'s ``BasicBlock`` and ``ResNetCIFAR``.

He et al.'s CIFAR design: 3x3 stem, three stages of basic blocks at widths
16/32/64, depth = 6n+2, global average pool, linear head; a 1x1 projection
shortcut where the shape changes. The model takes NHWC input, as the JAX
model does, and permutes to NCHW once inside. Computation is float32.

``BatchNorm`` reproduces flax's ``nn.BatchNorm`` rather than
``torch.nn.BatchNorm2d``: running average with momentum 0.99 (flax's
convention: ra = 0.99*ra + 0.01*batch), eps 1e-5, and a BIASED batch
variance, both for normalizing and for the running average
(``BatchNorm2d`` stores the unbiased one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        # F.batch_norm normalizes with the biased batch variance but would
        # store the unbiased one, so the running stats are updated here.
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.shortcut = None
        if cin != filters or stride != 1:
            self.shortcut = nn.Sequential(_conv(cin, filters, 1, stride),
                                          BatchNorm(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


class ResNetCIFAR(nn.Module):
    def __init__(self, depth: int = 20, num_classes: int = 10):
        super().__init__()
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
        self.fc = nn.Linear(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float32 -> logits f32[B, num_classes]."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(2, 3)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from `generator`: LeCun-normal
        (truncated normal, variance 1/fan_in) for conv and dense kernels,
        zero biases, BatchNorm scale 1 and bias 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                # Truncation at +-2 std shrinks the variance by 0.7737.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
