"""The port's ImageNet JPEG path against the JAX package's, on the fixture
ImageFolder (``tests/fixtures/imagenet``: 2 classes, 6 train and 4 val
JPEGs): the same batches, bitwise, train and val, at 0, 1 and 2 decode
workers, over whole epochs and after a mid-epoch ``batches=`` seek; the
decode pool refcounted and released by ``close()``; PIL imported only
inside the decode function; the command line training ResNet-50 on the
folder through the pool."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gtopkssgd_tpu.data import get_dataset as jax_dataset
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.data import imagenet

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures", "imagenet")


def _pair(split, workers, seed=3, batch_size=2):
    kw = dict(split=split, batch_size=batch_size, data_dir=FIX, seed=seed,
              decode_workers=workers)
    return get_dataset("imagenet", **kw), jax_dataset("imagenet", **kw)


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a["image"].dtype == b["image"].dtype == np.uint8
        assert a["image"].shape == b["image"].shape
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("workers", [0, 1, 2])
@pytest.mark.parametrize("split", ["train", "test"])
def test_batches_bitwise_the_jax_dataset(split, workers):
    port, ref = _pair(split, workers)
    try:
        assert not port.synthetic and port.num_classes == ref.num_classes
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in (0, 1):
            _assert_same(list(port.epoch(epoch)), list(ref.epoch(epoch)))
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_mid_epoch_seek_decodes_the_listed_batches(workers):
    """``epoch(e, batches=range(1, 3))`` is batches 1 and 2 of the JAX
    epoch, and decodes only those: the decode calls count them."""
    port, ref = _pair("train", workers, seed=5, batch_size=2)
    try:
        want = list(ref.epoch(1))[1:3]
        _assert_same(list(port.epoch(1, range(1, 3))), want)
    finally:
        port.close()
        ref.close()
    calls = []
    seq, _ = _pair("train", 0, seed=5, batch_size=2)
    real = imagenet._decode_seeded
    imagenet._decode_seeded = lambda job: calls.append(job) or real(job)
    try:
        list(seq.epoch(1, range(1, 3)))
    finally:
        imagenet._decode_seeded = real
    assert len(calls) == 4  # two batches of two


def test_rank_shards_match_the_jax_shards():
    kw = dict(split="train", batch_size=1, data_dir=FIX, seed=7)
    for rank in range(2):
        ours = get_dataset("imagenet", rank=rank, nworkers=2, **kw)
        theirs = jax_dataset("imagenet", rank=rank, nworkers=2, **kw)
        _assert_same(list(ours.epoch(0)), list(theirs.epoch(0)))


def test_close_releases_the_shared_pool():
    """Every dataset of a process shares one pool, sized by the first;
    ``close()`` drops a reference (twice is harmless) and the last one
    terminates the pool."""
    assert imagenet.decode_pool_refs() == 0
    a = get_dataset("imagenet", split="train", batch_size=2, data_dir=FIX,
                    decode_workers=2)
    b = get_dataset("imagenet", split="test", batch_size=2, data_dir=FIX,
                    decode_workers=3)
    assert imagenet.decode_pool_refs() == 2 and a._pool is b._pool
    a.close()
    a.close()
    assert imagenet.decode_pool_refs() == 1 and imagenet._pool is not None
    b.close()
    assert imagenet.decode_pool_refs() == 0 and imagenet._pool is None
    release = imagenet.prefork_decode_pool(2)
    assert imagenet.decode_pool_refs() == 1
    release()
    assert imagenet._pool is None
    assert imagenet.prefork_decode_pool(0)() is None


def test_synthetic_without_the_folder_and_bad_workers_refused(tmp_path):
    ds = get_dataset("imagenet", split="train", batch_size=2,
                     data_dir=str(tmp_path), decode_workers=2)
    assert ds.synthetic and ds.decode_workers == 0 and ds._pool is None
    with pytest.raises(ValueError, match="decode_workers"):
        get_dataset("imagenet", split="train", batch_size=2, data_dir=FIX,
                    decode_workers=-1)


def test_pil_is_imported_only_to_decode():
    code = ("import sys\n"
            "from gtopkssgd_tpu_torch.data import imagenet, get_dataset\n"
            f"ds = get_dataset('imagenet', split='test', batch_size=2, "
            f"data_dir={FIX!r})\n"
            "assert 'PIL' not in sys.modules\n"
            "next(ds.epoch(0))\n"
            "assert 'PIL' in sys.modules\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.dirname(HERE), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_trains_resnet50_on_the_folder(capsys):
    """``--data-dir`` with ``train/`` and ``val/`` and ``--decode-workers
    2``: ResNet-50 takes a step on decoded JPEGs, evaluates, and the
    pool is released when the trainer closes."""
    rc = dist_trainer.main([
        "--dnn", "resnet50", "--data-dir", FIX, "--decode-workers", "2",
        "--batch-size", "2", "--num-iters", "1", "--eval-batches", "1",
        "--compression", "gtopk", "--topk-method", "twostage", "--prefetch",
        "0", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 1 and np.isfinite(out["losses"][0])
    assert np.isfinite(out["val_loss"])
    assert imagenet.decode_pool_refs() == 0
    assert dist_trainer.decode_pool_size(dist_trainer.config_from_args(
        dist_trainer.build_argparser().parse_args(
            ["--dnn", "resnet50", "--data-dir", FIX, "--decode-workers",
             "2", "--nworkers", "1"]))) == 2
