"""The benchmark's frozen arithmetic: a model step's FLOPs from the
configuration's shapes, the selection's bytes from N and k, the published
peaks by card name and dtype. These are copies, kept here so that a change
to the port cannot move the yardstick.

* FLOPs: ``gtopkssgd_tpu_torch/benchmark.py`` takes them from
  ``torch.utils.flop_counter`` over a step (``obs/memwatch.py``
  ``step_flops``); here they are counted from the shapes alone:
  convolutions and matrix products, 2 FLOPs a multiply-add, forward once
  and backward twice.
* Peaks: ``gtopkssgd_tpu_torch/benchmark.py`` ``PEAK_FLOPS`` (NVIDIA's
  H100 SXM data sheet, dense rates); the HBM rate is the sheet's
  3.35 TB/s, the bound ``PERF.md``'s kernel table divides bytes by.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

# (card name substring, dtype) -> dense peak FLOP/s; first match wins, so
# the PCIe part is listed before the SXM part.
PEAK_FLOPS: List[Tuple[str, str, float]] = [
    ("H100 PCIe", "bfloat16", 756.5e12),
    ("H100 PCIe", "float32", 51.2e12),
    ("H100", "bfloat16", 989.4e12),
    ("H100", "float32", 66.9e12),
]
PEAK_BYTES: List[Tuple[str, float]] = [
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
]


def peak_flops(card: str, dtype: str) -> Optional[float]:
    for sub, dt, peak in PEAK_FLOPS:
        if sub in card and dt == dtype:
            return peak
    return None


def peak_bytes(card: str) -> Optional[float]:
    for sub, rate in PEAK_BYTES:
        if sub in card:
            return rate
    return None


def _out(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


def conv_macs(side: int, cin: int, cout: int, k: int, s: int, p: int
              ) -> Tuple[int, int]:
    """(multiply-adds, output side) of a square convolution."""
    o = _out(side, k, s, p)
    return o * o * cout * cin * k * k, o


def resnet_forward_macs(image_size: int, stage_sizes, widths,
                        num_classes: int, channels: int = 3) -> int:
    """ResNet v1 with bottleneck blocks, the stride on the 3x3 conv:
    7x7/2 stem, 3x3/2 max pool (padding 1), a 1x1 projection where the
    shape changes, global average pool, dense head."""
    macs, side = conv_macs(image_size, channels, 64, 7, 2, 3)
    side = _out(side, 3, 2, 1)
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


def alexnet_forward_macs(image_size: int, convs, pool_after,
                         fcs, num_classes: int) -> int:
    """Single-tower AlexNet: `convs` as (in, out, kernel, stride,
    padding), a 3x3/2 VALID max pool after the convs in `pool_after`,
    then dense layers of widths `fcs` and the head."""
    macs, side = 0, image_size
    for i, (cin, cout, k, s, p) in enumerate(convs):
        m, side = conv_macs(side, cin, cout, k, s, p)
        macs += m
        if i in pool_after:
            side = _out(side, 3, 2, 0)
    width = convs[-1][1] * side * side
    for f in list(fcs) + [num_classes]:
        macs += width * f
        width = f
    return macs


def forward_macs(config: Dict) -> int:
    """Multiply-adds of one sample's forward pass, from the
    configuration's shapes."""
    arch = config["arch"]
    if arch["kind"] == "resnet":
        return resnet_forward_macs(config["image_size"],
                                   arch["stage_sizes"], arch["widths"],
                                   config["num_classes"],
                                   config["channels"])
    if arch["kind"] == "alexnet":
        return alexnet_forward_macs(config["image_size"], arch["convs"],
                                    arch["pool_after"], arch["fcs"],
                                    config["num_classes"])
    raise ValueError(f"no FLOP count for arch {arch['kind']!r}")


def step_flops(config: Dict, batch: int) -> float:
    """FLOPs of one training step of one worker: 2 a multiply-add, the
    forward once and the backward twice."""
    return 3.0 * 2.0 * forward_macs(config) * batch


def k_for_density(n: int, density: float) -> int:
    """k = max(1, ceil(density * n)), the paper's choice."""
    return max(1, int(math.ceil(float(density) * n)))


def select_bytes(n: int, k: int) -> int:
    """The least HBM traffic of one selection over a float32 gradient of
    n elements with error feedback: the gradient and the residual read
    once, the new residual written once, k (index, value) pairs of 4
    bytes each written once."""
    return 12 * n + 8 * k
