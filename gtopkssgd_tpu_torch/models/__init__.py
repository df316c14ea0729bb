"""Model zoo by the reference's ``--dnn`` flag string: the vision zoo
(VGG-16 and the CIFAR ResNets on CIFAR-10, ResNet-50 and AlexNet on
ImageNet), the recurrent zoo (the 2-layer LSTM on PTB, the DeepSpeech
BiLSTM on AN4), and the language models, which the JAX package does not
have (``moonlight``: DeepSeek-V3's decoder as Moonlight-16B-A3B
configures it, on seeded token sequences), built from a configuration of
their published keys (``get_model(config=...)``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from gtopkssgd_tpu_torch.models.alexnet import AlexNet
from gtopkssgd_tpu_torch.models.deepseek_v3 import DeepSeekV3
from gtopkssgd_tpu_torch.models.layers import BatchNorm, Dropout, seed_dropout
from gtopkssgd_tpu_torch.models.lstm import PTBLSTM
from gtopkssgd_tpu_torch.models.lstman4 import DeepSpeechAN4
from gtopkssgd_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNetCIFAR,
    ResNetImageNet,
)
from gtopkssgd_tpu_torch.models.vgg import VGG16


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A zoo entry: constructor, canonical dataset, example input shape
    (NHWC for images, (T,) tokens, (T, bins) spectrograms; without the
    batch dimension), whether the model has BatchNorm statistics (the JAX
    zoo's field, held equal to it by the tests; the trainer averages
    whatever buffers a model has), and whether it is recurrent."""

    name: str
    build: Callable[..., nn.Module]
    dataset: str
    example_shape: Tuple[int, ...]
    has_batchnorm: bool = True
    recurrent: bool = False
    lm: bool = False


_ZOO: Dict[str, ModelSpec] = {spec.name: spec for spec in (
    ModelSpec("vgg16", VGG16, "cifar10", (32, 32, 3)),
    ModelSpec("resnet20", lambda **kw: ResNetCIFAR(depth=20, **kw),
              "cifar10", (32, 32, 3)),
    ModelSpec("resnet56", lambda **kw: ResNetCIFAR(depth=56, **kw),
              "cifar10", (32, 32, 3)),
    ModelSpec("resnet50", ResNetImageNet, "imagenet", (224, 224, 3)),
    ModelSpec("alexnet", AlexNet, "imagenet", (224, 224, 3),
              has_batchnorm=False),
    ModelSpec("lstm", PTBLSTM, "ptb", (35,), has_batchnorm=False,
              recurrent=True),
    ModelSpec("lstman4", DeepSpeechAN4, "an4", (200, 161), recurrent=True),
    ModelSpec("moonlight", DeepSeekV3, "tokens", (8192,),
              has_batchnorm=False, lm=True),
)}
#: The zoo entries the JAX package does not have.
PORT_ONLY = ("moonlight",)


def model_spec(dnn: str) -> ModelSpec:
    try:
        return _ZOO[dnn]
    except KeyError:
        raise ValueError(
            f"unknown dnn {dnn!r}; the port has {sorted(_ZOO)}") from None


# The compute dtypes by their ``--dtype`` names.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_model(dnn: str, space_to_depth: bool = False,
              dtype: str = "float32", config: Optional[dict] = None
              ) -> Tuple[nn.Module, ModelSpec]:
    """Build a zoo model by its ``--dnn`` flag string, computing in
    `dtype` (``--dtype``: float32 or bfloat16; the parameters are float32
    either way). Only resnet50 takes ``space_to_depth``; any other model
    rejects a true value with the JAX package's error. A language model
    (``ModelSpec.lm``) is built from `config`, its published keys and
    cut, and needs one; the other models take none."""
    spec = model_spec(dnn)
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(DTYPES)}")
    dtype = DTYPES[dtype]
    if spec.lm:
        if config is None:
            raise ValueError(f"--dnn {dnn} is built from a model "
                             "configuration (TrainConfig.model_config)")
        return spec.build(config, dtype=dtype), spec
    if config is not None:
        raise ValueError(f"--dnn {dnn} takes no model configuration")
    if not space_to_depth:
        return spec.build(dtype=dtype), spec
    if dnn != "resnet50":
        raise ValueError(
            f"--s2d is a resnet50 stem transform; --dnn {dnn} "
            "does not take it")
    return spec.build(space_to_depth=True, dtype=dtype), spec


def available_models():
    return sorted(_ZOO)


__all__ = ["AlexNet", "BasicBlock", "BatchNorm", "BottleneckBlock", "DTYPES",
           "DeepSeekV3", "DeepSpeechAN4", "Dropout", "ModelSpec", "PORT_ONLY",
           "PTBLSTM",
           "ResNetCIFAR", "ResNetImageNet", "VGG16", "available_models",
           "get_model", "model_spec", "seed_dropout"]
