"""The port's real CIFAR-10 path (``data/cifar.py``'s pickle loader) on
the committed fixture ``tests/fixtures/cifar`` (five train batches of 8
images and a test batch of 8, in the ``cifar-10-batches-py`` format):
the twins of the JAX package's ``tests/test_real_data.py`` CIFAR tests,
and every batch of an epoch bitwise equal to the JAX loader's, over both
splits, epochs 0 and 1, one rank and rank 1 of 2, with ``synth_hard`` on
and off (the flag shapes only the synthetic stand-in, so the real path
must ignore it).
"""

import os

import numpy as np
import pytest

from gtopkssgd_tpu.data import get_dataset as jax_get_dataset
from gtopkssgd_tpu_torch.data import get_dataset

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "cifar")


def test_cifar_real_pickle_parses():
    ds = get_dataset("cifar10", split="train", batch_size=4, data_dir=FIX)
    assert not ds.synthetic
    assert ds.images.shape == (40, 32, 32, 3)  # 5 batch files x 8 images
    assert ds.images.dtype == np.uint8  # raw pixels; the device normalizes
    assert ds.labels.shape == (40,) and ds.labels.dtype == np.int32
    batch = next(iter(ds.epoch(0)))
    assert batch["image"].shape == (4, 32, 32, 3)
    assert batch["label"].shape == (4,)


def test_cifar_real_test_split_and_determinism():
    kw = dict(split="test", batch_size=4, data_dir=FIX)
    a = get_dataset("cifar10", **kw)
    b = get_dataset("cifar10", **kw)
    assert a.images.shape[0] == 8
    ba, bb = next(iter(a.epoch(0))), next(iter(b.epoch(0)))
    np.testing.assert_array_equal(ba["image"], bb["image"])
    np.testing.assert_array_equal(ba["label"], bb["label"])


def test_cifar_real_rank_shards_are_disjoint():
    kw = dict(split="train", batch_size=4, nworkers=2, data_dir=FIX)
    r0 = get_dataset("cifar10", rank=0, **kw)
    r1 = get_dataset("cifar10", rank=1, **kw)
    i0 = set(r0.partitioner.indices(0).tolist())
    i1 = set(r1.partitioner.indices(0).tolist())
    assert not (i0 & i1) and len(i0 | i1) == 40


@pytest.mark.parametrize("synth_hard", [False, True])
@pytest.mark.parametrize("rank,nworkers", [(0, 1), (1, 2)])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar_real_batches_match_the_jax_loader(split, epoch, rank,
                                                 nworkers, synth_hard):
    kw = dict(split=split, batch_size=4, rank=rank, nworkers=nworkers,
              data_dir=FIX, seed=3, synth_hard=synth_hard)
    ours = get_dataset("cifar10", **kw)
    ref = jax_get_dataset("cifar10", **kw)
    assert not ours.synthetic and not ref.synthetic
    got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
    assert len(got) == len(want) == (40 if split == "train" else 8) \
        // nworkers // 4
    for b, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"image", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, (b, key)
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg=f"batch {b} {key}")
