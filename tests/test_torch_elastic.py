"""The port's elastic resize against the JAX package's: ``repartition_buffer``
and ``repartition_residual`` bitwise over (old P, new P) pairs, and
``source_rows`` adding up to the same rows; the lineage file's round
trip; the checkpoint manager's restore at another world size for every
residual layout (flat, and ``v``/``u`` under momentum correction); and,
through the command line over gloo on the CPU, a shrink 2 -> 1 (exit 46,
``elastic.json``, the relaunch's residual the fold of the two saved rows
and training on) and a grow 1 -> 2 (the new rank's residual zero)."""

import json
import os

import numpy as np
import pytest
import torch

from gtopkssgd_tpu.resilience import elastic as jax_elastic
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.resilience import elastic
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer
from gtopkssgd_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    state_digest,
)
from gtopkssgd_tpu_torch.utils.manifest import config_hash

import test_torch_rank_programs as programs

PAIRS = [(1, 2), (2, 1), (2, 2), (4, 2), (4, 3), (3, 4), (5, 2), (8, 3),
         (3, 1), (1, 4)]
CFG = dict(dnn="resnet20", batch_size=4, compression="gtopk", density=0.01,
           eval_batches=1, prefetch=1)
CLI = ["--dnn", "resnet20", "--batch-size", "4", "--compression", "gtopk",
       "--density", "0.01", "--eval-batches", "1", "--prefetch", "1",
       "--device", "cpu"]


def _rows(old_p, n=1000, seed=0):
    return np.random.default_rng(seed + old_p).standard_normal(
        (old_p, n)).astype(np.float32)


# ------------------------------------------------------ re-partitioning

@pytest.mark.parametrize("old_p,new_p", PAIRS)
def test_repartition_buffer_bitwise_jax(old_p, new_p):
    buf = _rows(old_p)
    ours = elastic.repartition_buffer(buf, new_p)
    theirs = jax_elastic.repartition_buffer(buf, new_p)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32))
    # the pending mass: every column sum kept up to float32 rounding
    np.testing.assert_allclose(ours.astype(np.float64).sum(0),
                               buf.astype(np.float64).sum(0),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("old_p,new_p", PAIRS)
def test_source_rows_add_up_to_the_repartition(old_p, new_p):
    """What a restoring rank adds, in its order, is its row of
    ``repartition_buffer``, bitwise; a rank a grow adds has no rows."""
    buf = _rows(old_p, seed=1)
    want = elastic.repartition_buffer(buf, new_p)
    for rank in range(new_p):
        rows = elastic.source_rows(rank, old_p, new_p)
        got = torch.zeros(buf.shape[1])
        if rows:
            got = torch.from_numpy(buf[rows[0]].copy())
            for r in rows[1:]:
                got += torch.from_numpy(buf[r])
        np.testing.assert_array_equal(got.numpy(), want[rank])
        assert bool(rows) == (rank < old_p)


def test_repartition_residual_over_layouts_as_jax():
    tree = {"v": _rows(3, 50, 2), "u": _rows(3, 50, 3)}
    ours = elastic.repartition_residual(tree, 2)
    theirs = jax_elastic.repartition_residual(tree, 2)
    for key in tree:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]))
    pair = (_rows(2, 10, 4), _rows(2, 20, 5))
    got = elastic.repartition_residual(pair, 3)
    assert isinstance(got, tuple) and got[1].shape == (3, 20)
    with pytest.raises(ValueError):
        elastic.repartition_buffer(np.float32(1.0), 2)
    with pytest.raises(ValueError):
        elastic.repartition_buffer(_rows(2), 0)


def test_surviving_ranks_and_lineage_round_trip(tmp_path):
    for old_p, gone in ((4, [1]), (4, []), (3, [0, 2])):
        assert elastic.surviving_ranks(old_p, gone) == \
            jax_elastic.surviving_ranks(old_p, gone)
    assert elastic.load_lineage(None) is None
    assert elastic.load_lineage(str(tmp_path)) is None
    lid = elastic.mint_lineage_id()
    assert len(lid) == 16 and lid != elastic.mint_lineage_id()
    rec = elastic.write_lineage(str(tmp_path), lineage_id=lid,
                                resize_epoch=2, p=3)
    assert elastic.load_lineage(str(tmp_path)) == rec
    assert jax_elastic.load_lineage(str(tmp_path)) == rec  # one format
    (tmp_path / elastic.LINEAGE_FILE).write_text("{torn")
    assert elastic.load_lineage(str(tmp_path)) is None


# ----------------------------------------------- the checkpoint manager

def _save_world(directory, world, states, step=3):
    """Write `states` (one a rank) as a `world`-rank save of `step`."""
    for rank in reversed(range(world)):  # rank 0 writes the sidecar last
        m = CheckpointManager(directory, rank=rank, config_hash="h")
        m.world = world
        m.save(step, states[rank])


@pytest.mark.parametrize("old_p,new_p", [(3, 1), (2, 1), (1, 2), (2, 3)])
def test_restore_at_another_world_folds_every_layout(tmp_path, old_p,
                                                     new_p):
    rng = np.random.default_rng(old_p * 10 + new_p)
    states = [{"step": torch.tensor(3),
               "model.w": torch.ones(4),
               "residual.v": torch.from_numpy(
                   rng.standard_normal(6).astype(np.float32)),
               "residual.u": torch.from_numpy(
                   rng.standard_normal(6).astype(np.float32)),
               "dropout_rng": torch.tensor([r], dtype=torch.uint8)}
              for r in range(old_p)]
    d = str(tmp_path / "ckpt")
    _save_world(d, old_p, states)
    digest = state_digest(states[0])
    for rank in range(new_p):
        m = CheckpointManager(d, rank=rank, config_hash="h")
        m.world = new_p
        with pytest.raises(ValueError, match="--elastic"):
            m.restore(digest)
        got = m.restore(digest, elastic=True, rank_local=("dropout_rng",))
        assert m.last_restored_world == old_p
        for key in ("residual.v", "residual.u"):
            buf = np.stack([s[key].numpy() for s in states])
            np.testing.assert_array_equal(
                got[key].numpy(), elastic.repartition_buffer(buf, new_p)[rank])
        assert torch.equal(got["model.w"], torch.ones(4))
        if rank < old_p:
            assert int(got["dropout_rng"][0]) == rank
        else:
            assert "dropout_rng" not in got


# ------------------------------------------------- through the command line

def _ckpt(out_dir, step, rank=0):
    return torch.load(os.path.join(out_dir, "ckpt", str(step),
                                   f"rank{rank}.pt"), weights_only=True)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_shrink_two_to_one_over_gloo(tmp_path):
    """P = 2 ``pallas`` with ``--elastic --inject resize@2:1`` exits 46,
    with step 2 saved by both ranks, ``elastic.json`` naming P = 1 and a
    "resize" record on each rank; the relaunch at P = 1 restores the fold
    of the two rows (each column's sum, bitwise the float32 sum) and
    trains on; the lineage id is kept."""
    out = str(tmp_path / "run")
    cli = CLI + ["--topk-method", "pallas", "--out-dir", out, "--elastic"]
    assert dist_trainer.main(cli + ["--nworkers", "2", "--num-iters", "4",
                                    "--inject", "resize@2:1"]) == 46
    with open(os.path.join(out, "elastic.json")) as fh:
        lineage = json.load(fh)
    assert (lineage["p"], lineage["prev_p"], lineage["drained_step"],
            lineage["resize_epoch"], lineage["reason"]) == (1, 2, 2, 1,
                                                             "inject")
    for rank in range(2):
        recs = _records(os.path.join(out, f"metrics.rank{rank}.jsonl"))
        assert recs[0]["lineage_id"] == lineage["lineage_id"]
        resize = [r for r in recs if r["kind"] == "resize"]
        assert [(r["old_p"], r["new_p"], r["step"]) for r in resize] == [
            (2, 1, 2)]
    rows = [_ckpt(out, 2, r)["residual"] for r in range(2)]
    with Trainer(TrainConfig(device="cpu", topk_method="pallas",
                             out_dir=out, resume=True, elastic=True,
                             **CFG)) as t:
        assert t.step == 2 and t._ckpt.last_restored_world == 2
        assert torch.equal(t.optimizer.state["residual"], rows[0] + rows[1])
        assert t.manifest["lineage_id"] == lineage["lineage_id"]
    assert dist_trainer.main(cli + ["--nworkers", "1", "--num-iters", "2",
                                    "--resume"]) == 0
    assert os.path.exists(os.path.join(out, "ckpt", "4", "rank0.pt"))
    with open(os.path.join(out, "elastic.json")) as fh:
        assert json.load(fh)["lineage_id"] == lineage["lineage_id"]


def test_grow_one_to_two_over_gloo(tmp_path):
    """P = 1 with ``resize@2:2`` exits 46; two ranks restoring it: rank 0
    holds the saved residual, rank 1's is zero; both hold the saved
    weights; the relaunch at P = 2 trains on. Without ``--elastic`` the
    P = 2 resume is refused."""
    out = str(tmp_path / "run")
    cli = CLI + ["--topk-method", "twostage", "--out-dir", out]
    assert dist_trainer.main(cli + ["--elastic", "--num-iters", "4",
                                    "--inject", "resize@2:2"]) == 46
    saved = _ckpt(out, 2)
    ranks = spawn(programs.elastic_restore, 2,
                  dict(CFG, topk_method="twostage", nworkers=2), out,
                  backend="gloo", device="cpu", timeout=300)
    assert [r["step"] for r in ranks] == [2, 2]
    assert [r["world"] for r in ranks] == [1, 1]
    np.testing.assert_array_equal(ranks[0]["residual"]["residual"],
                                  saved["residual"].numpy())
    assert not np.any(ranks[1]["residual"]["residual"])
    assert ranks[0]["manifest"]["lineage_id"] == \
        ranks[1]["manifest"]["lineage_id"]
    with pytest.raises(RuntimeError, match="--elastic"):
        dist_trainer.main(cli + ["--nworkers", "2", "--num-iters", "1",
                                 "--resume"])
    assert dist_trainer.main(cli + ["--elastic", "--nworkers", "2",
                                    "--num-iters", "2", "--resume"]) == 0


def test_resize_without_elastic_is_ignored_and_hash_nulls_the_fleet(
        tmp_path):
    """A resize fault without ``--elastic`` is recorded and training goes
    on. The checkpoint's config hash nulls the injected faults, and under
    ``elastic`` also the fleet size, the elastic knobs and the out dir
    (the shrink and grow tests resume across P on it)."""
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path / "a"),
                             inject="resize@1:2", **CFG)) as t:
        t.train(2)
        assert t.step == 2 and t.injector.summary() == {"resize": 1}
        plain = dict(allow_ckpt_mismatch=False, resume=False, inject=None)
        assert t._ckpt.config_hash == config_hash(t._identity(**plain))
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path / "b"),
                             elastic=True, **CFG)) as t:
        fleet = dict(plain, nworkers=0, elastic=False, min_fleet=1,
                     out_dir=None)
        assert t._ckpt.config_hash == config_hash(t._identity(**fleet))
        assert t._ckpt.config_hash != config_hash(t._identity(**plain))
        assert t.manifest["resize_epoch"] == 0


def test_min_fleet_turns_a_preemption_into_exit_45(tmp_path):
    """Under ``elastic`` a preemption at P = 1 would resize to 0, below
    ``--min-fleet``: the emergency save and exit 45 instead."""
    out = str(tmp_path / "run")
    assert dist_trainer.main(CLI + ["--topk-method", "twostage",
                                    "--out-dir", out, "--elastic",
                                    "--num-iters", "3", "--inject",
                                    "preempt@1"]) == 45
    assert os.path.exists(os.path.join(out, "ckpt", "integrity-1.json"))
    with pytest.raises(ValueError, match="min_fleet"):
        TrainConfig(min_fleet=0, device="cpu").resolved()
