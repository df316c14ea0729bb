"""ResNet-50 and AlexNet as plain functions of a parameter dict.

The parameters are kept by their flax paths (``("BottleneckBlock_3",
"Conv_1", "kernel")``), the names of the model as the JAX package defines
it, in PyTorch's layouts (conv OIHW, dense (out, in)). ``flat_order``
lays them out as the paper's flat gradient: paths sorted as strings at
each level, conv kernels as HWIO and dense kernels as (in, out), the
order in which ``ravel_pytree`` flattens a flax tree. The two-stage
selection buckets positions of that vector, so the order is part of the
selection's definition.

Initialisation is flax's: LeCun normal truncated at two standard
deviations (variance 1/fan_in) for every kernel, zero biases, BatchNorm
scale 1 (0 for the last BatchNorm of a bottleneck block) and bias 0,
drawn from one CPU ``torch.Generator`` seeded with the seed, kernel by
kernel in the order the layers run (stem, blocks, head). BatchNorm
normalises with the batch's biased variance, eps 1e-5.

``quant`` is applied to the operands of every convolution and dense
layer: the identity for the reference, a rounding to a lower precision
for the precision control (``lowp.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Path = Tuple[str, ...]
Params = Dict[Path, torch.Tensor]
# The ImageNet channel statistics the images are normalised with.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _kernel(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = int(np.prod(shape[1:]))
    std = math.sqrt(1.0 / fan_in) / TRUNC
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)
    return w


def resnet_init(config: Dict, seed: int) -> Params:
    arch = config["arch"]
    gen = torch.Generator().manual_seed(int(seed))
    p: Params = {}

    def conv(prefix, cin, cout, k):
        p[prefix + ("kernel",)] = _kernel(gen, (cout, cin, k, k))

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
    p[("Dense_0", "kernel")] = _kernel(gen, (config["num_classes"], cin))
    p[("Dense_0", "bias")] = torch.zeros(config["num_classes"])
    return p


def _bn(x, p, prefix):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    scale = p[prefix + ("scale",)].view(1, -1, 1, 1)
    bias = p[prefix + ("bias",)].view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def resnet_forward(config: Dict, p: Params, x: torch.Tensor,
                   quant: Callable = _identity, **_) -> torch.Tensor:
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


def alexnet_init(config: Dict, seed: int) -> Params:
    arch = config["arch"]
    gen = torch.Generator().manual_seed(int(seed))
    p: Params = {}
    for i, (cin, cout, k, _, _) in enumerate(arch["convs"]):
        p[(f"Conv_{i}", "kernel")] = _kernel(gen, (cout, cin, k, k))
        p[(f"Conv_{i}", "bias")] = torch.zeros(cout)
    side = config["image_size"]
    for i, (_, _, k, s, pad) in enumerate(arch["convs"]):
        side = (side + 2 * pad - k) // s + 1
        if i in arch["pool_after"]:
            side = (side - 3) // 2 + 1
    width = arch["convs"][-1][1] * side * side
    for i, f in enumerate(list(arch["fcs"]) + [config["num_classes"]]):
        p[(f"Dense_{i}", "kernel")] = _kernel(gen, (f, width))
        p[(f"Dense_{i}", "bias")] = torch.zeros(f)
        width = f
    return p


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate where a uniform
    draw from `gen` on x's device lies below it, kept values over
    1 - rate."""
    if rate == 0.0 or gen is None:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def alexnet_forward(config: Dict, p: Params, x: torch.Tensor,
                    quant: Callable = _identity,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: normalised NCHW float32 -> logits; dropout before the first two
    dense layers, masks drawn from `gen`."""
    arch = config["arch"]
    rate = float(arch["dropout"])
    for i, (_, _, _, s, pad) in enumerate(arch["convs"]):
        x = F.relu(F.conv2d(quant(x), quant(p[(f"Conv_{i}", "kernel")]),
                            p[(f"Conv_{i}", "bias")], stride=s,
                            padding=pad))
        if i in arch["pool_after"]:
            x = F.max_pool2d(x, 3, stride=2)
    x = x.permute(0, 2, 3, 1).flatten(1)  # flax flattens NHWC
    nfc = len(arch["fcs"]) + 1
    for i in range(nfc):
        if i < len(arch["fcs"]):
            x = dropout(x, rate, gen)
        x = F.linear(quant(x), quant(p[(f"Dense_{i}", "kernel")]),
                     p[(f"Dense_{i}", "bias")])
        if i < nfc - 1:
            x = F.relu(x)
    return x


MODELS = {"resnet": (resnet_init, resnet_forward),
          "alexnet": (alexnet_init, alexnet_forward)}


def init(config: Dict, seed: int) -> Params:
    return MODELS[config["arch"]["kind"]][0](config, seed)


def forward(config: Dict, p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    return MODELS[config["arch"]["kind"]][1](config, p, x, **kw)


def _to_flat_layout(t: torch.Tensor) -> torch.Tensor:
    """A tensor in the flat vector's layout: conv OIHW -> HWIO, dense
    (out, in) -> (in, out)."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.permute(1, 0)
    return t


def flat_order(p: Params) -> List[Path]:
    """The leaves in the flat vector's order: paths sorted."""
    return sorted(p)


def ravel(p: Params, order: List[Path]) -> torch.Tensor:
    return torch.cat([_to_flat_layout(p[k]).reshape(-1) for k in order])


def unravel(flat: torch.Tensor, like: Params, order: List[Path]) -> Params:
    out, off = {}, 0
    for k in order:
        t = like[k]
        n = t.numel()
        shape = _to_flat_layout(t).shape
        seg = flat[off:off + n].view(shape)
        if t.dim() == 4:
            seg = seg.permute(3, 2, 0, 1)
        elif t.dim() == 2:
            seg = seg.permute(1, 0)
        out[k] = seg
        off += n
    return out


def leaves(p: Params, order: List[Path]) -> List[Tuple[str, int, int]]:
    """(name, offset, size) of each leaf in the flat vector."""
    out, off = [], 0
    for k in order:
        n = p[k].numel()
        out.append(("/".join(k), off, n))
        off += n
    return out


def normalise(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, (x / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)
