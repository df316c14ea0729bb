"""The port's trainer against the JAX package's, end to end on the CPU:
ResNet-20 on synthetic CIFAR-10, batch 8, flat gTop-k at density 0.01,
selection method ``pallas`` (the JAX side runs the Pallas count kernel in
interpret mode, the port its CUDA kernel's plain twin), from the same seed
and the same converted initial weights, through three steps.

Each port step starts from the JAX trainer's state (params, batch stats,
momentum, residual): top-k selection is discontinuous, so one coordinate
that flips at tau moves one weight by lr*|acc|, and the next gradients
move by percents (measured: 2 flips at step 0 became 548 of 2725 at step
1 when the two ran free). What is held is each step's agreement.

Tolerances: per-step losses within 1e-3 relative -- the two frameworks'
float32 convolutions and BatchNorm reductions sum in different orders;
keep sets (residual == 0) with a Jaccard index of at least 0.99 -- that
rounding can flip coordinates whose |acc| sits at tau.

Also here: the CLI, and that the port never imports jax or the JAX package
(every module, ``parallel/`` included).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.convert import load_jax_state
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-3
MIN_JACCARD = 0.99


def jax_state_as_numpy(jt: JaxTrainer) -> dict:
    """The JAX trainer's whole training state as numpy trees, in the
    arguments of ``convert.load_jax_state``: the BPTT carry too (the PTB
    model's (c, h) pair of f32[P, B, H] per layer; empty otherwise)."""
    st = jt.state
    trace = next((s.trace for s in st.opt_state.inner[1]
                  if hasattr(s, "trace")), None)  # None: no SGD momentum
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(params=to_np(st.params), batch_stats=to_np(st.batch_stats),
                momentum=None if trace is None else to_np(trace),
                residual=to_np(st.opt_state.residual),
                count=int(st.opt_state.count), carry=to_np(jt.carry))


def _load_jax_state(pt: Trainer, jt: JaxTrainer) -> None:
    """Copy the JAX trainer's whole training state into the port's."""
    load_jax_state(pt, **jax_state_as_numpy(jt))


def test_three_steps_match_the_jax_trainer():
    common = dict(dnn="resnet20", batch_size=8, compression="gtopk",
                  density=0.01, topk_method="pallas", max_epochs=1, seed=3)
    jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, log_interval=1,
                              **common))
    pt = Trainer(TrainConfig(device="cpu", **common))
    assert pt.num_params == jt.num_params == 272_474
    for step in range(3):
        _load_jax_state(pt, jt)
        jloss = jt.train(1)["loss"]
        ploss = pt.train(1)["loss"]
        assert np.isfinite(ploss)
        np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        jkeep = np.asarray(jt.state.opt_state.residual) == 0
        pkeep = pt.optimizer.state["residual"].numpy() == 0
        inter = np.sum(jkeep & pkeep)
        union = np.sum(jkeep | pkeep)
        assert union >= 2725  # k = ceil(0.01 * 272474)
        assert inter / union >= MIN_JACCARD, (step, inter, union)


@pytest.mark.parametrize("split,epoch", [("train", 0), ("train", 1),
                                         ("test", 0)])
def test_cifar_batches_match_the_jax_pipeline(split, epoch):
    """The port's copy of the CIFAR pipeline draws the JAX pipeline's
    batches (synthetic images, shard order, augmentation), bit for bit."""
    from gtopkssgd_tpu.data.cifar import CIFAR10Dataset as JaxCifar
    from gtopkssgd_tpu_torch.data import get_dataset

    kw = dict(split=split, batch_size=16, rank=1, nworkers=2, seed=5)
    jb = JaxCifar(**kw).epoch(epoch)
    tb = get_dataset("cifar10", **kw).epoch(epoch)
    for _ in range(3):
        a, b = next(jb), next(tb)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_cli_trains_on_cpu(capsys):
    rc = dist_trainer.main([
        "--compression", "gtopk", "--density", "0.001", "--topk-method",
        "twostage", "--num-iters", "2", "--batch-size", "4",
        "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_params"] == 272_474 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    # NCCL needs the card: asked for on the CPU, the CLI refuses before
    # it spawns a rank (gloo is never chosen in its place).
    with pytest.raises(SystemExit, match="nccl"):
        dist_trainer.main(["--nworkers", "2", "--device", "cpu",
                           "--dist-backend", "nccl"])


def test_dense_trainer_steps_and_schedule():
    pt = Trainer(TrainConfig(batch_size=4, nsteps_update=2, device="cpu",
                             max_epochs=4))
    assert pt.cfg.lr == 0.1 and pt.cfg.weight_decay == 5e-4
    spe = pt.steps_per_epoch  # 2048 // 4 // 2
    assert spe == 256
    sched = pt.lr_schedule()
    assert sched(0) == sched(2 * spe - 1) == float(np.float32(0.1))
    assert sched(2 * spe) == float(np.float32(0.1) * np.float32(0.1))
    assert sched(3 * spe) < sched(2 * spe)
    stats = pt.train(2)
    assert len(stats["losses"]) == 2 and np.all(np.isfinite(stats["losses"]))
    assert pt.optimizer.last_keep is None and pt.step == 2


def test_port_never_imports_jax_or_the_jax_package():
    """Import the port and every one of its modules in a clean process:
    neither jax, orbax nor gtopkssgd_tpu may be loaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import gtopkssgd_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) >= 70, names\n"
        "assert {'gtopkssgd_tpu_torch.benchmark',\n"
        "        'gtopkssgd_tpu_torch.exit_codes',\n"
        "        'gtopkssgd_tpu_torch.obs.calib',\n"
        "        'gtopkssgd_tpu_torch.obs.counters',\n"
        "        'gtopkssgd_tpu_torch.obs.critpath',\n"
        "        'gtopkssgd_tpu_torch.obs.events',\n"
        "        'gtopkssgd_tpu_torch.obs.exporter',\n"
        "        'gtopkssgd_tpu_torch.obs.fleet',\n"
        "        'gtopkssgd_tpu_torch.obs.forecast',\n"
        "        'gtopkssgd_tpu_torch.obs.goodput',\n"
        "        'gtopkssgd_tpu_torch.obs.ledger',\n"
        "        'gtopkssgd_tpu_torch.obs.linkmap',\n"
        "        'gtopkssgd_tpu_torch.obs.memwatch',\n"
        "        'gtopkssgd_tpu_torch.obs.registry',\n"
        "        'gtopkssgd_tpu_torch.obs.report',\n"
        "        'gtopkssgd_tpu_torch.obs.timeline',\n"
        "        'gtopkssgd_tpu_torch.obs.trace_attr',\n"
        "        'gtopkssgd_tpu_torch.obs.tracing',\n"
        "        'gtopkssgd_tpu_torch.obs.watchdog',\n"
        "        'gtopkssgd_tpu_torch.obs_probe',\n"
        "        'gtopkssgd_tpu_torch.resilience.policy',\n"
        "        'gtopkssgd_tpu_torch.ops.prng',\n"
        "        'gtopkssgd_tpu_torch.resilience.elastic',\n"
        "        'gtopkssgd_tpu_torch.resilience.inject',\n"
        "        'gtopkssgd_tpu_torch.resilience.preempt',\n"
        "        'gtopkssgd_tpu_torch.select_probe',\n"
        "        'gtopkssgd_tpu_torch.native',\n"
        "        'gtopkssgd_tpu_torch.utils.checkpoint',\n"
        "        'gtopkssgd_tpu_torch.utils.manifest',\n"
        "        'gtopkssgd_tpu_torch.utils.metrics',\n"
        "        'gtopkssgd_tpu_torch.utils.prefetch'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'orbax',\n"
        "             'gtopkssgd_tpu') or m.startswith(('jax.', 'orbax.',\n"
        "             'gtopkssgd_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
