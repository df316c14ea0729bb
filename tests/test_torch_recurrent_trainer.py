"""The port's trainer on the recurrent zoo against the JAX trainer, on the
CPU: two gTop-k steps of the PTB LSTM at full width (N = 19,775,200,
batch 4) and of the AN4 DeepSpeech model at hidden 32 with two
bidirectional layers (batch 4, 140 frames); ``test()``; the schedules and
defaults; the PTB carry through ``fit()``; the CLI; and PTB at P = 2 over
gloo.

Both zoos' entries are patched in these tests only (``monkeypatch`` on the
two ``_ZOO`` dicts; for AN4 both dataset registries' ``an4`` too, whose
synthetic utterances hold 24-132 frames): dropout at rate 0, as flax and
the port draw their masks from different generators. Both sides select
with ``threshold``, and clip before compression as the datasets' defaults
say (PTB 0.25, AN4 400).

Each port step starts from the JAX trainer's state, the BPTT carry
included (selection is discontinuous; ``tests/test_torch_slice.py``):
losses within 1e-3 relative and keep sets with a Jaccard index of at least
0.98. The keep sets are taken over the coordinates whose accumulator is
nonzero: every embedding row a batch does not touch has gradient 0 and
residual 0 on both sides, so ``residual == 0`` (the other parity tests'
keep set) would count millions of such rows as agreeing picks and hide a
wrong selection. The port's keep set is ``optimizer.last_keep``, the JAX
trainer's ``residual == 0`` restricted to ``acc != 0``. ``test()`` from
the same weights: ``val_loss`` and ``val_ppl`` within 1e-5 relative, the
CER and WER (ratios of equal integer counts) equal.
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
from gtopkssgd_tpu.models.lstm import PTBLSTM as JaxPTBLSTM
from gtopkssgd_tpu.models.lstman4 import DeepSpeechAN4 as JaxAN4
from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from gtopkssgd_tpu.trainer import shard_steps_per_epoch as jax_spe
from test_torch_slice import jax_state_as_numpy
import gtopkssgd_tpu_torch.data as port_data
import gtopkssgd_tpu_torch.models as port_models
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.convert import load_jax_state
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.models import DeepSpeechAN4, PTBLSTM
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import (
    TrainConfig,
    Trainer,
    shard_steps_per_epoch,
)

torch.set_num_threads(2)
LOSS_RTOL = 1e-3
MIN_JACCARD = 0.98
VAL_RTOL = 1e-5

# case: (dnn, flax build, port build, an4 dataset keywords or None)
RUNS = {
    "lstm": ("lstm", functools.partial(JaxPTBLSTM, dropout_rate=0.0),
             functools.partial(PTBLSTM, dropout_rate=0.0), None),
    "lstman4-small": ("lstman4",
                      functools.partial(JaxAN4, rnn_hidden=32, rnn_layers=2),
                      functools.partial(DeepSpeechAN4, rnn_hidden=32,
                                        rnn_layers=2),
                      dict(max_frames=140)),
}


def _patch(monkeypatch, dnn, jax_build, port_build, an4):
    for zoo, build in ((jax_models._ZOO, jax_build),
                       (port_models._ZOO, port_build)):
        monkeypatch.setitem(zoo, dnn,
                            dataclasses.replace(zoo[dnn], build=build))
    if an4 is not None:
        for registry in (jax_data._DATASETS, port_data._DATASETS):
            monkeypatch.setitem(registry, "an4", functools.partial(
                registry["an4"], **an4))


@pytest.mark.parametrize("case", list(RUNS))
def test_two_steps_and_test_match_the_jax_trainer(monkeypatch, case):
    dnn, jax_build, port_build, an4 = RUNS[case]
    _patch(monkeypatch, dnn, jax_build, port_build, an4)
    common = dict(dnn=dnn, batch_size=4, compression="gtopk", density=0.001,
                  topk_method="threshold", max_epochs=1, seed=3,
                  eval_batches=2)
    jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, log_interval=1,
                              **common))
    pt = Trainer(TrainConfig(device="cpu", **common))
    assert pt.num_params == jt.num_params
    if dnn == "lstm":
        assert pt.num_params == 19_775_200
    assert (pt.cfg.lr, pt.cfg.weight_decay, pt.cfg.clip_grad_norm) == (
        jt.cfg.lr, jt.cfg.weight_decay, jt.cfg.clip_grad_norm)
    assert pt.steps_per_epoch == jt.steps_per_epoch
    k = -(-pt.num_params // 1000)
    for step in range(2):
        state = jax_state_as_numpy(jt)
        load_jax_state(pt, **state)
        if dnn == "lstm":
            for (jc, jh), (tc, th) in zip(state["carry"], pt.carry):
                np.testing.assert_array_equal(tc.numpy(), jc[0])
                np.testing.assert_array_equal(th.numpy(), jh[0])
            assert step == 0 or np.abs(state["carry"][1][1]).max() > 0
        res_in = pt.optimizer.state["residual"].clone()
        jloss = jt.train(1)["loss"]
        ploss = pt.train(1)["loss"]
        assert np.isfinite(ploss)
        np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        nonzero = (pt.optimizer.flat_grad + res_in != 0).numpy()
        jkeep = (np.asarray(jt.state.opt_state.residual) == 0) & nonzero
        pkeep = pt.optimizer.last_keep.numpy()
        assert not np.any(pkeep & ~nonzero)
        inter, union = np.sum(jkeep & pkeep), np.sum(jkeep | pkeep)
        assert union >= k
        assert inter / union >= MIN_JACCARD, (step, inter, union)
        if dnn == "lstm":  # most of the flat vector is exact zeros
            assert nonzero.sum() < 0.8 * pt.num_params
    load_jax_state(pt, **jax_state_as_numpy(jt))
    want, got = jt.test(), pt.test()
    assert set(got) == set(want) == ({"val_loss", "val_ppl"} if dnn == "lstm"
                                     else {"val_loss", "val_cer",
                                           "val_wer"})
    for key in got:
        if key in ("val_cer", "val_wer"):
            assert got[key] == want[key]
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=VAL_RTOL,
                                       err_msg=key)
    assert pt.model.training  # test() leaves train mode on


@pytest.mark.parametrize("dnn", ["lstm", "lstman4"])
def test_recurrent_schedule_and_defaults_are_the_jax_ones(dnn):
    """lr, weight decay and clip by dataset; the PTB decay (x0.8 an epoch
    from epoch 6 on) and the AN4 anneal (x1/1.01 an epoch) against the JAX
    trainer's schedule, jitted, bitwise at every epoch 0-20 and at the
    steps around each boundary, at the default lr and at another."""
    cfg = TrainConfig(dnn=dnn, device="cpu").resolved()
    jcfg = JaxConfig(dnn=dnn).resolved()
    assert cfg.dataset == jcfg.dataset
    assert (cfg.lr, cfg.weight_decay, cfg.clip_grad_norm) == (
        jcfg.lr, jcfg.weight_decay, jcfg.clip_grad_norm) == (
        {"lstm": (1.0, 0.0, 0.25), "lstman4": (3e-4, 0.0, 400.0)}[dnn])
    spe = 7
    counts = np.array([e * spe + d for e in range(21) for d in (-1, 0, 1)
                       if e * spe + d >= 0], dtype=np.int32)
    for lr in (cfg.lr, 0.37):
        cfg.lr = jcfg.lr = lr
        stub = types.SimpleNamespace(cfg=cfg, steps_per_epoch=spe)
        stub._dataset_schedule = lambda base: Trainer._dataset_schedule(
            stub, base)
        jstub = types.SimpleNamespace(cfg=jcfg, steps_per_epoch=spe)
        jstub._dataset_schedule = (
            lambda base, s: JaxTrainer._dataset_schedule(jstub, base, s))
        jsched = JaxTrainer._lr_schedule(jstub)
        want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(counts)),
                          dtype=np.float32)
        sched = Trainer.lr_schedule(stub)
        got = np.array([sched(int(c)) for c in counts], dtype=np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        distinct = 16 if dnn == "lstm" else 21
        assert len(set(got.tolist())) == distinct


@pytest.mark.parametrize("dataset,p", [("ptb", 1), ("ptb", 2), ("an4", 1),
                                       ("an4", 3)])
def test_steps_per_epoch_with_and_without_a_partitioner(dataset, p):
    """PTB has no partitioner: its windows count; AN4's smallest shard
    counts at P > 1 -- as the JAX trainer's ``shard_steps_per_epoch``."""
    for rank in range(p):
        kw = dict(split="train", batch_size=8, rank=rank, nworkers=p,
                  seed=2)
        want = jax_spe(jax_data.get_dataset(dataset, **kw), 8, 2)
        assert shard_steps_per_epoch(get_dataset(dataset, **kw), 8, 2) == \
            want


def test_fit_zeroes_the_carry_each_epoch(monkeypatch):
    """``fit()`` starts every epoch from a zero carry, ``train`` threads
    it through consecutive windows, and ``test()`` leaves it as it was."""
    monkeypatch.setitem(port_models._ZOO, "lstm", dataclasses.replace(
        port_models._ZOO["lstm"],
        build=functools.partial(PTBLSTM, hidden_size=8)))
    pt = Trainer(TrainConfig(dnn="lstm", batch_size=4, eval_batches=1,
                             device="cpu"))
    pt.steps_per_epoch = 2
    starts = []
    train = pt.train

    def recording_train(n):
        starts.append(max(float(h.abs().max()) for _, h in pt.carry))
        return train(n)

    monkeypatch.setattr(pt, "train", recording_train)
    out = pt.fit(2)
    assert starts == [0.0, 0.0] and pt.step == 4
    assert max(float(h.abs().max()) for _, h in pt.carry) > 0
    carry = pt.carry
    pt.test()  # evaluates on a carry of its own
    assert pt.carry is carry
    assert {"loss", "ppl", "val_loss", "val_ppl"} <= set(out)
    np.testing.assert_allclose(out["val_ppl"], np.exp(out["val_loss"]))


@pytest.mark.parametrize("dnn,keys", [
    ("lstm", {"val_loss", "val_ppl"}),
    ("lstman4", {"val_loss", "val_cer", "val_wer"})])
def test_cli_trains_and_evaluates_the_recurrent_models(capsys, dnn, keys):
    rc = dist_trainer.main([
        "--dnn", dnn, "--device", "cpu", "--num-iters", "1",
        "--eval-batches", "1", "--batch-size", "2", "--compression",
        "gtopk", "--topk-method", "twostage"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dnn"] == dnn
    assert out["num_params"] == {"lstm": 19_775_200,
                                 "lstman4": 20_340_477}[dnn]
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert keys <= set(out) and np.isfinite(out["val_loss"])


def test_ptb_at_p2_global_sets_agree_and_evaluates_as_one_rank():
    """The PTB LSTM at hidden 64, P = 2 over gloo, 3 gTop-k ``pallas``
    steps with dropout on: the global index set is bitwise equal on both
    ranks at every step, the parameters too; each rank carries its own
    stream rows; ``test()`` returns the same metrics on both ranks, equal
    to a P = 1 trainer's ``test()`` of the same weights."""
    got = spawn(programs.small_ptb_steps_and_test, 2,
                dict(dnn="lstm", batch_size=4, compression="gtopk",
                     density=0.001, topk_method="pallas", nworkers=2,
                     eval_batches=3, seed=1), 3,
                backend="gloo", device="cpu", timeout=180)
    r0, r1 = got
    assert len(r0["gidx"]) == 3
    for a, b in zip(r0["gidx"], r1["gidx"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r0["params"], r1["params"])
    assert not np.array_equal(r0["carry"][0][1], r1["carry"][0][1])
    assert len(r0["losses"]) == 3 and np.all(np.isfinite(r0["losses"]))
    assert r0["losses"] == r1["losses"]  # averaged over the ranks
    assert r0["metrics"] == r1["metrics"] == r0["p1_metrics"] == \
        r1["p1_metrics"]
    assert set(r0["metrics"]) == {"val_loss", "val_ppl"}
