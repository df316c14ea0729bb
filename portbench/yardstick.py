"""The benchmark's frozen arithmetic: a model step's FLOPs from the
configuration's shapes, the selection's bytes from N and k, the published
peaks by card name and dtype. These are copies, kept here so that a change
to the port cannot move the yardstick.

* FLOPs: ``gtopkssgd_tpu_torch/benchmark.py`` takes them from
  ``torch.utils.flop_counter`` over a step (``obs/memwatch.py``
  ``step_flops``); here they are counted from the shapes alone:
  convolutions and matrix products, 2 FLOPs a multiply-add, forward once
  and backward twice. Each kind of model counts its own forward pass
  in its module of ``portbench/kinds/`` (``forward_macs``: ResNet's in
  ``kinds/resnet.py``, AlexNet's in ``kinds/alexnet.py``), from the
  shared ``conv_macs`` below.
* Peaks: ``gtopkssgd_tpu_torch/benchmark.py`` ``PEAK_FLOPS`` (NVIDIA's
  H100 SXM data sheet, dense rates); the HBM rate is the sheet's
  3.35 TB/s, the bound ``PERF.md``'s kernel table divides bytes by.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from portbench import spec

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


def out_side(side: int, k: int, s: int, p: int) -> int:
    """The output side of a square window: kernel k, stride s, padding
    p."""
    return (side + 2 * p - k) // s + 1


def conv_macs(side: int, cin: int, cout: int, k: int, s: int, p: int
              ) -> Tuple[int, int]:
    """(multiply-adds, output side) of a square convolution."""
    o = out_side(side, k, s, p)
    return o * o * cout * cin * k * k, o


def forward_macs(config: Dict) -> int:
    """Multiply-adds of one sample's forward pass, from the
    configuration's shapes: its kind's count (``portbench/kinds/``)."""
    return spec.kind(config).forward_macs(config)


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
