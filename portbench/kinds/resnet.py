"""ResNet v1 with bottleneck blocks (``arch``: ``stage_sizes``,
``widths``), on ImageNet-shaped images.

Parameters by the flax paths of the model as the JAX package defines it
(``("BottleneckBlock_3", "Conv_1", "kernel")``); initialisation is
flax's: LeCun normal kernels, BatchNorm scale 1 (0 for the last
BatchNorm of a block) and bias 0, kernel by kernel in the order the
layers run (stem, blocks, head). BatchNorm normalises with the batch's
biased variance, eps 1e-5. The stride sits on the 3x3 conv.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from portbench.kinds import _image
from portbench.reference.models import Params, identity, lecun_normal
from portbench.yardstick import conv_macs, out_side

BN_EPS = 1e-5

pool = _image.pool


def init(config: Dict, seed: int) -> Params:
    arch = config["arch"]
    gen = torch.Generator().manual_seed(int(seed))
    p: Params = {}

    def conv(prefix, cin, cout, k):
        p[prefix + ("kernel",)] = lecun_normal(gen, (cout, cin, k, k))

    def bn(prefix, c, zero=False):
        p[prefix + ("scale",)] = torch.full((c,), 0.0 if zero else 1.0)
        p[prefix + ("bias",)] = torch.zeros(c)

    conv(("Conv_0",), config["channels"], 64, 7)
    bn(("BatchNorm_0",), 64)
    cin, b = 64, 0
    for stage, (size, width) in enumerate(zip(arch["stage_sizes"],
                                              arch["widths"])):
        inner = width // 4
        for block in range(size):
            stride = 2 if stage > 0 and block == 0 else 1
            pre = (f"BottleneckBlock_{b}",)
            conv(pre + ("Conv_0",), cin, inner, 1)
            bn(pre + ("BatchNorm_0",), inner)
            conv(pre + ("Conv_1",), inner, inner, 3)
            bn(pre + ("BatchNorm_1",), inner)
            conv(pre + ("Conv_2",), inner, width, 1)
            bn(pre + ("BatchNorm_2",), width, zero=True)
            if cin != width or stride != 1:
                conv(pre + ("Conv_3",), cin, width, 1)
                bn(pre + ("BatchNorm_3",), width)
            cin, b = width, b + 1
    p[("Dense_0", "kernel")] = lecun_normal(gen, (config["num_classes"], cin))
    p[("Dense_0", "bias")] = torch.zeros(config["num_classes"])
    return p


def _bn(x, p, prefix):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    scale = p[prefix + ("scale",)].view(1, -1, 1, 1)
    bias = p[prefix + ("bias",)].view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def forward(config: Dict, p: Params, x: torch.Tensor,
            quant: Callable = identity, **_) -> torch.Tensor:
    """x: normalised NCHW float32 -> logits."""
    arch = config["arch"]

    def conv(x, prefix, stride, pad):
        return F.conv2d(quant(x), quant(p[prefix + ("kernel",)]),
                        stride=stride, padding=pad)

    x = F.relu(_bn(conv(x, ("Conv_0",), 2, 3), p, ("BatchNorm_0",)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    cin, b = 64, 0
    for stage, (size, width) in enumerate(zip(arch["stage_sizes"],
                                              arch["widths"])):
        for block in range(size):
            stride = 2 if stage > 0 and block == 0 else 1
            pre = (f"BottleneckBlock_{b}",)
            y = F.relu(_bn(conv(x, pre + ("Conv_0",), 1, 0), p,
                           pre + ("BatchNorm_0",)))
            y = F.relu(_bn(conv(y, pre + ("Conv_1",), stride, 1), p,
                           pre + ("BatchNorm_1",)))
            y = _bn(conv(y, pre + ("Conv_2",), 1, 0), p,
                    pre + ("BatchNorm_2",))
            if cin != width or stride != 1:
                x = _bn(conv(x, pre + ("Conv_3",), stride, 0), p,
                        pre + ("BatchNorm_3",))
            x = F.relu(x + y)
            cin, b = width, b + 1
    x = x.mean(dim=(2, 3))
    return F.linear(quant(x), quant(p[("Dense_0", "kernel")]),
                    p[("Dense_0", "bias")])


def loss(config: Dict, params: Params, batch: Dict, quant: Callable,
         gen) -> torch.Tensor:
    return _image.loss(forward, config, params, batch, quant, gen)


def resnet_forward_macs(image_size: int, stage_sizes, widths,
                        num_classes: int, channels: int = 3) -> int:
    """7x7/2 stem, 3x3/2 max pool (padding 1), the blocks with a 1x1
    projection where the shape changes, global average pool, dense
    head."""
    macs, side = conv_macs(image_size, channels, 64, 7, 2, 3)
    side = out_side(side, 3, 2, 1)
    cin = 64
    for stage, (size, width) in enumerate(zip(stage_sizes, widths)):
        inner = width // 4
        for block in range(size):
            stride = 2 if stage > 0 and block == 0 else 1
            m, _ = conv_macs(side, cin, inner, 1, 1, 0)
            macs += m
            m, out = conv_macs(side, inner, inner, 3, stride, 1)
            macs += m
            m, _ = conv_macs(out, inner, width, 1, 1, 0)
            macs += m
            if cin != width or stride != 1:
                m, _ = conv_macs(side, cin, width, 1, stride, 0)
                macs += m
            side, cin = out, width
    return macs + cin * num_classes


def forward_macs(config: Dict) -> int:
    arch = config["arch"]
    return resnet_forward_macs(config["image_size"], arch["stage_sizes"],
                               arch["widths"], config["num_classes"],
                               config["channels"])
