"""Data pipelines by the reference's ``--dataset`` flag string: CIFAR-10
(real pickles or the synthetic stand-in), ImageNet (the synthetic
stand-in), PTB and AN4 (real files or synthetic stand-ins), and the
language models' seeded token sequences (``tokens``, which the JAX
package does not have)."""

from __future__ import annotations

from typing import Any, Optional

from gtopkssgd_tpu_torch.data.an4 import AN4Dataset
from gtopkssgd_tpu_torch.data.cifar import CIFAR10Dataset
from gtopkssgd_tpu_torch.data.imagenet import ImageNetDataset
from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    partition_indices,
)
from gtopkssgd_tpu_torch.data.ptb import PTBDataset
from gtopkssgd_tpu_torch.data.tokens import TokenDataset

_DATASETS = {"cifar10": CIFAR10Dataset, "imagenet": ImageNetDataset,
             "ptb": PTBDataset, "an4": AN4Dataset, "tokens": TokenDataset}
#: The datasets the JAX package does not have.
PORT_ONLY = ("tokens",)


def get_dataset(name: str, *, split: str = "train", batch_size: int = 32,
                rank: int = 0, nworkers: int = 1,
                data_dir: Optional[str] = None, seed: int = 0,
                **kwargs: Any):
    """A dataset by name; `kwargs` go to its constructor (``bptt`` for
    ptb, ``max_frames`` and ``max_label_len`` for an4, ``seq_len`` and
    ``vocab_size`` for tokens)."""
    try:
        cls = _DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; the port has {sorted(_DATASETS)}"
        ) from None
    return cls(split=split, batch_size=batch_size, rank=rank,
               nworkers=nworkers, data_dir=data_dir, seed=seed, **kwargs)


def available_datasets():
    return sorted(_DATASETS)


__all__ = ["AN4Dataset", "CIFAR10Dataset", "DataPartitioner",
           "ImageNetDataset", "PORT_ONLY", "PTBDataset", "TokenDataset",
           "available_datasets",
           "get_dataset", "partition_indices"]
