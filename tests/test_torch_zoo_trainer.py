"""The port's trainer on the vision zoo against the JAX trainer, on the
CPU: two gTop-k steps of VGG-16 (cifar10, batch 8), of AlexNet at full
size (imagenet, batch 2, N = 61,100,840; marked slow) and at 64x64 with
10 classes, and of ResNet-50's design with one block a stage (imagenet,
224x224, batch 2); the imagenet lr
schedules; ``test()`` and ``fit()``; the CLI; and at P = 2 AlexNet, which
has no BatchNorm, over gloo.

Both zoos' entries are patched in these tests only (``monkeypatch`` on
the two ``_ZOO`` dicts): dropout at rate 0, as flax and the port draw
their masks from different generators, and ResNet-50 at one block a
stage; for the 64x64 AlexNet also both dataset registries' imagenet. Both sides select with ``threshold``, the multisection bracket in
plain operations (Pallas in interpret mode at these N would take
minutes, and XLA's exact top-k on the CPU 22 s a step at AlexNet's N;
the kernels' twins are held to Pallas in ``tests/test_torch_ops.py`` and
``tests/test_torch_multisection.py``).

Each port step starts from the JAX trainer's state, as in
``tests/test_torch_slice.py`` (selection is discontinuous): losses within
1e-3 relative and keep sets with a Jaccard index of at least 0.98, as
``tests/test_torch_dist.py`` holds them per step. ``test()`` from the same
weights: ``val_loss`` within 1e-5 relative, ``val_top1`` and ``val_top5``
equal.
"""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtopkssgd_tpu.data as jax_data
import gtopkssgd_tpu.models as jax_models
import test_torch_rank_programs as programs
from gtopkssgd_tpu.models.resnet import ResNetImageNet as JaxResNet
from gtopkssgd_tpu.models.vgg import VGG16 as JaxVGG
from gtopkssgd_tpu.models.alexnet import AlexNet as JaxAlexNet
from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from test_torch_slice import jax_state_as_numpy
import gtopkssgd_tpu_torch.data as port_data
import gtopkssgd_tpu_torch.models as port_models
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.convert import load_jax_state
from gtopkssgd_tpu_torch.models import AlexNet, ResNetImageNet, VGG16
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
LOSS_RTOL = 1e-3
MIN_JACCARD = 0.98
VAL_RTOL = 1e-5

SMALL = (1, 1, 1, 1)
# case: (dnn, flax build, port build, trainer settings, synthetic
# ImageNet's image size and classes, or None for the dataset as it is)
RUNS = {
    "vgg16": ("vgg16", functools.partial(JaxVGG, dropout_rate=0.0),
              functools.partial(VGG16, dropout_rate=0.0),
              dict(batch_size=8, eval_batches=None), None),
    "alexnet": ("alexnet", functools.partial(JaxAlexNet, dropout_rate=0.0),
                functools.partial(AlexNet, dropout_rate=0.0),
                dict(batch_size=2, eval_batches=3), None),
    "alexnet-64": ("alexnet",
                   functools.partial(JaxAlexNet, num_classes=10,
                                     dropout_rate=0.0),
                   functools.partial(AlexNet, num_classes=10,
                                     image_size=64, dropout_rate=0.0),
                   dict(batch_size=2, eval_batches=3), (64, 10)),
    "resnet50": ("resnet50", functools.partial(JaxResNet, stage_sizes=SMALL),
                 functools.partial(ResNetImageNet, stage_sizes=SMALL),
                 dict(batch_size=2, eval_batches=3), None),
}


def _patch_zoos(monkeypatch, dnn, jax_build, port_build, imagenet):
    for zoo, build in ((jax_models._ZOO, jax_build),
                       (port_models._ZOO, port_build)):
        monkeypatch.setitem(zoo, dnn,
                            dataclasses.replace(zoo[dnn], build=build))
    if imagenet is not None:
        size, classes = imagenet
        for registry in (jax_data._DATASETS, port_data._DATASETS):
            monkeypatch.setitem(registry, "imagenet", functools.partial(
                registry["imagenet"], image_size=size, num_classes=classes))


@pytest.mark.parametrize("case", [
    # Full-size AlexNet (N = 61,100,840) takes 35-100 s on the CPU;
    # "alexnet-64" is its tier-1 case.
    pytest.param(case, marks=pytest.mark.slow) if case == "alexnet"
    else case for case in RUNS])
def test_two_steps_and_test_match_the_jax_trainer(monkeypatch, case):
    dnn, jax_build, port_build, extra, imagenet = RUNS[case]
    _patch_zoos(monkeypatch, dnn, jax_build, port_build, imagenet)
    common = dict(dnn=dnn, compression="gtopk", density=0.001,
                  topk_method="threshold", max_epochs=1, seed=3,
                  **extra)
    jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, log_interval=1,
                              **common))
    pt = Trainer(TrainConfig(device="cpu", **common))
    assert pt.num_params == jt.num_params
    assert pt.cfg.lr == jt.cfg.lr and pt.cfg.weight_decay == \
        jt.cfg.weight_decay
    k = -(-pt.num_params // 1000)
    for step in range(2):
        load_jax_state(pt, **jax_state_as_numpy(jt))
        jloss = jt.train(1)["loss"]
        ploss = pt.train(1)["loss"]
        assert np.isfinite(ploss)
        np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        jkeep = np.asarray(jt.state.opt_state.residual) == 0
        pkeep = pt.optimizer.state["residual"].numpy() == 0
        inter, union = np.sum(jkeep & pkeep), np.sum(jkeep | pkeep)
        assert union >= k
        assert inter / union >= MIN_JACCARD, (step, inter, union)
    load_jax_state(pt, **jax_state_as_numpy(jt))
    want, got = jt.test(), pt.test()
    assert set(got) == {"val_loss", "val_top1", "val_top5"}
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=VAL_RTOL)
    assert got["val_top1"] == want["val_top1"]
    assert got["val_top5"] == want["val_top5"]
    assert pt.model.training  # test() leaves train mode on


@pytest.mark.parametrize("dnn,lr", [("resnet50", 0.1), ("alexnet", 0.01)])
def test_imagenet_schedule_is_bitwise_the_jax_schedule(dnn, lr):
    """Base lr by model (AlexNet 0.01) and x0.1 at epochs 30, 60 and 80,
    against the JAX trainer's schedule, jitted, at the steps around each
    boundary."""
    cfg = TrainConfig(dnn=dnn, device="cpu").resolved()
    jcfg = JaxConfig(dnn=dnn).resolved()
    assert cfg.dataset == jcfg.dataset == "imagenet"
    assert cfg.lr == jcfg.lr == lr
    assert cfg.weight_decay == jcfg.weight_decay == 1e-4
    spe = 32  # 1024 synthetic images, batch 32
    stub = types.SimpleNamespace(cfg=cfg, steps_per_epoch=spe)
    stub._dataset_schedule = lambda base: Trainer._dataset_schedule(
        stub, base)
    jstub = types.SimpleNamespace(cfg=jcfg, steps_per_epoch=spe)
    jstub._dataset_schedule = lambda base, s: JaxTrainer._dataset_schedule(
        jstub, base, s)
    counts = np.array([0, 1] + [e * spe + d for e in (30, 60, 80)
                                for d in (-1, 0, 1)] + [100 * spe],
                      dtype=np.int32)
    jsched = JaxTrainer._lr_schedule(jstub)
    want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(counts)),
                      dtype=np.float32)
    sched = Trainer.lr_schedule(stub)
    got = np.array([sched(int(c)) for c in counts], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert len(set(got.tolist())) == 4


def test_fit_trains_and_evaluates_each_epoch():
    pt = Trainer(TrainConfig(batch_size=64, eval_batches=2, device="cpu"))
    spe = pt.steps_per_epoch
    assert spe == 32
    out = pt.fit(1)
    assert pt.step == spe and len(out["losses"]) == spe
    assert {"loss", "throughput", "val_loss", "val_top1",
            "val_top5"} <= set(out)
    assert np.isfinite(out["val_loss"])
    assert 0.0 <= out["val_top1"] <= out["val_top5"] <= 1.0
    assert pt.fit(1) == {}  # epoch 1 is done


def test_cli_evaluates_after_num_iters(capsys):
    rc = dist_trainer.main([
        "--dnn", "vgg16", "--device", "cpu", "--num-iters", "1",
        "--eval-batches", "1", "--batch-size", "4", "--compression",
        "gtopk", "--topk-method", "twostage"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dnn"] == "vgg16" and out["num_params"] == 14_986_698
    assert len(out["losses"]) == 1 and np.isfinite(out["val_loss"])
    assert 0.0 <= out["val_top1"] <= out["val_top5"] <= 1.0
    with pytest.raises(ValueError) as want:
        jax_models.get_model("vgg16", space_to_depth=True)
    with pytest.raises(ValueError) as got:
        dist_trainer.main(["--dnn", "vgg16", "--s2d", "--device", "cpu",
                           "--num-iters", "1"])
    assert str(got.value) == str(want.value)


def test_alexnet_at_p2_evaluates_as_one_rank():
    """AlexNet (no BatchNorm to average) at 64x64 with 10 classes, P = 2
    over gloo, 3 gTop-k steps with dropout on: the parameters are bitwise
    equal on both ranks; ``test()`` over 5 batches (rank 0 makes and
    takes three, rank 1 two) returns the same metrics on both ranks, equal
    to a P = 1 trainer's ``test()`` of the same weights."""
    got = spawn(programs.small_alexnet_steps_and_test, 2,
                dict(dnn="alexnet", batch_size=4, compression="gtopk",
                     density=0.001, topk_method="twostage", nworkers=2,
                     eval_batches=5, seed=1), 3,
                backend="gloo", device="cpu", timeout=180)
    r0, r1 = got
    np.testing.assert_array_equal(r0["params"], r1["params"])
    assert len(r0["losses"]) == 3 and np.all(np.isfinite(r0["losses"]))
    assert r0["metrics"] == r1["metrics"] == r0["p1_metrics"] == \
        r1["p1_metrics"]
    assert set(r0["metrics"]) == {"val_loss", "val_top1", "val_top5"}
    assert (r0["val_batches_made"], r1["val_batches_made"]) == (3, 2)
