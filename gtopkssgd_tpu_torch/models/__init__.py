"""Model zoo by the reference's ``--dnn`` flag string. The port has the
CIFAR ResNets so far (ResNet-20, ResNet-56)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from torch import nn

from gtopkssgd_tpu_torch.models.resnet import BasicBlock, ResNetCIFAR


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A zoo entry: constructor, canonical dataset, example input shape
    (NHWC, without the batch dimension)."""

    name: str
    build: Callable[[], nn.Module]
    dataset: str
    example_shape: Tuple[int, ...]


_ZOO: Dict[str, ModelSpec] = {
    "resnet20": ModelSpec("resnet20", lambda: ResNetCIFAR(depth=20),
                          "cifar10", (32, 32, 3)),
    "resnet56": ModelSpec("resnet56", lambda: ResNetCIFAR(depth=56),
                          "cifar10", (32, 32, 3)),
}


def get_model(dnn: str) -> Tuple[nn.Module, ModelSpec]:
    try:
        spec = _ZOO[dnn]
    except KeyError:
        raise ValueError(
            f"unknown dnn {dnn!r}; the port has {sorted(_ZOO)}") from None
    return spec.build(), spec


__all__ = ["BasicBlock", "ModelSpec", "ResNetCIFAR", "get_model"]
