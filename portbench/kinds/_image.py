"""What the image kinds share: the seeded pool of uint8 NHWC images and
int32 labels (the keys of the port's image datasets), the ImageNet
normalisation, and the cross-entropy loss over the classes."""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# A stream key of the pool's draws, apart from any other use of the seed.
POOL_STREAM = 0x9001
# The ImageNet channel statistics the images are normalised with.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pool(config: Dict, seed: int, rank: int, count: int, batch: int
         ) -> List[Dict[str, np.ndarray]]:
    """`count` batches of `batch` images and labels at the
    configuration's shapes, a pure function of (seed, rank), drawn in one
    call each."""
    side, channels = int(config["image_size"]), int(config["channels"])
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(rank), POOL_STREAM]))
    images = rng.integers(0, 256, (count, batch, side, side, channels),
                          dtype=np.uint8)
    labels = rng.integers(0, int(config["num_classes"]), (count, batch),
                          dtype=np.int32)
    return [{"image": images[i], "label": labels[i]} for i in range(count)]


def normalise(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, (x / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)


def loss(forward: Callable, config: Dict, params, batch: Dict, quant,
         gen) -> torch.Tensor:
    """The cross-entropy of `forward`'s logits on the normalised images
    against the labels."""
    x = normalise(batch["image"])
    y = batch["label"].long()
    logits = forward(config, params, x, quant=quant, gen=gen)
    return F.cross_entropy(logits, y)
