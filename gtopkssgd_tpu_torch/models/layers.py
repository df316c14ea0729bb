"""The layers the zoo shares where flax and PyTorch differ: flax's
BatchNorm, flax's Dropout with an explicit generator, and flax's
initializers.

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
    """``zero_scale``: the scale starts at 0 under ``flax_init`` (flax's
    ``scale_init=zeros``, the last BatchNorm of a bottleneck block)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
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


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode each element is kept with
    probability 1 - rate and kept ones are divided by 1 - rate (inverted
    scaling); in eval mode, or at rate 0, the identity. The mask is drawn
    from ``self.generator``, a ``torch.Generator`` on the input's device
    that ``seed_dropout`` sets (``F.dropout`` takes no generator)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout has no generator; call "
                               "models.seed_dropout(model, seed) first")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def seed_dropout(model: nn.Module, seed: int) -> None:
    """Give every ``Dropout`` of `model` one shared generator on the
    model's device, seeded with `seed`; a model without dropout is left
    as it is."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    if not drops:
        return
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in drops:
        m.generator = gen


def flax_init(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers, drawn from `generator`: LeCun-normal
    (truncated normal, variance 1/fan_in) for conv and dense kernels,
    zero biases, BatchNorm scale 1 (0 where ``zero_scale``) and bias 0,
    running statistics 0 and 1."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            # Truncation at +-2 std shrinks the variance by 0.7737.
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                  2 * std, generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, BatchNorm):
            nn.init.constant_(mod.weight, 0.0 if mod.zero_scale else 1.0)
            nn.init.zeros_(mod.bias)
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
