"""Data pipelines by the reference's ``--dataset`` flag string. The port has
CIFAR-10 (real pickles or the synthetic stand-in) and ImageNet (the
synthetic stand-in) so far."""

from __future__ import annotations

from typing import Optional

from gtopkssgd_tpu_torch.data.cifar import CIFAR10Dataset
from gtopkssgd_tpu_torch.data.imagenet import ImageNetDataset
from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    partition_indices,
)

_DATASETS = {"cifar10": CIFAR10Dataset, "imagenet": ImageNetDataset}


def get_dataset(name: str, *, split: str = "train", batch_size: int = 32,
                rank: int = 0, nworkers: int = 1,
                data_dir: Optional[str] = None, seed: int = 0):
    try:
        cls = _DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; the port has {sorted(_DATASETS)}"
        ) from None
    return cls(split=split, batch_size=batch_size, rank=rank,
               nworkers=nworkers, data_dir=data_dir, seed=seed)


__all__ = ["CIFAR10Dataset", "DataPartitioner", "ImageNetDataset",
           "get_dataset", "partition_indices"]
