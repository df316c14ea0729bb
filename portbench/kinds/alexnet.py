"""Single-tower AlexNet (``arch``: ``convs`` as (in, out, kernel,
stride, padding), ``pool_after``, ``fcs``, ``dropout``), on
ImageNet-shaped images.

Parameters by the flax paths (``("Conv_2", "kernel")``, ``("Dense_0",
"bias")``); LeCun normal kernels and zero biases, convs first, then the
dense layers. A 3x3/2 VALID max pool follows each conv in
``pool_after``; the last conv's output is flattened NHWC, as flax does;
dropout comes before the first two dense layers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from portbench.kinds import _image
from portbench.reference.models import Params, identity, lecun_normal
from portbench.yardstick import conv_macs, out_side

pool = _image.pool


def init(config: Dict, seed: int) -> Params:
    arch = config["arch"]
    gen = torch.Generator().manual_seed(int(seed))
    p: Params = {}
    for i, (cin, cout, k, _, _) in enumerate(arch["convs"]):
        p[(f"Conv_{i}", "kernel")] = lecun_normal(gen, (cout, cin, k, k))
        p[(f"Conv_{i}", "bias")] = torch.zeros(cout)
    side = config["image_size"]
    for i, (_, _, k, s, pad) in enumerate(arch["convs"]):
        side = (side + 2 * pad - k) // s + 1
        if i in arch["pool_after"]:
            side = (side - 3) // 2 + 1
    width = arch["convs"][-1][1] * side * side
    for i, f in enumerate(list(arch["fcs"]) + [config["num_classes"]]):
        p[(f"Dense_{i}", "kernel")] = lecun_normal(gen, (f, width))
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


def forward(config: Dict, p: Params, x: torch.Tensor,
            quant: Callable = identity,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: normalised NCHW float32 -> logits; dropout masks from `gen`."""
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


def loss(config: Dict, params: Params, batch: Dict, quant: Callable,
         gen) -> torch.Tensor:
    return _image.loss(forward, config, params, batch, quant, gen)


def alexnet_forward_macs(image_size: int, convs, pool_after,
                         fcs, num_classes: int) -> int:
    """The convs, a 3x3/2 VALID max pool after those in `pool_after`,
    then dense layers of widths `fcs` and the head."""
    macs, side = 0, image_size
    for i, (cin, cout, k, s, p) in enumerate(convs):
        m, side = conv_macs(side, cin, cout, k, s, p)
        macs += m
        if i in pool_after:
            side = out_side(side, 3, 2, 0)
    width = convs[-1][1] * side * side
    for f in list(fcs) + [num_classes]:
        macs += width * f
        width = f
    return macs


def forward_macs(config: Dict) -> int:
    arch = config["arch"]
    return alexnet_forward_macs(config["image_size"], arch["convs"],
                                arch["pool_after"], arch["fcs"],
                                config["num_classes"])
