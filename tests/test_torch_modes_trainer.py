"""The port's trainer in modes ``gtopk_layerwise`` and ``gtopk_hier`` at
P = 2 and 4 (spawned gloo ranks) against the JAX trainer on the
8-device CPU mesh, and their command-line flags.

Each step starts the port from the JAX trainer's state
(``convert.load_jax_state``, which carries the layer-wise residual's
per-leaf tuple into the flat buffer through ``layerwise_residual``).
Tolerances are those of ``tests/test_torch_dist.py``'s P = 2 trainer
test, for the reasons given there: losses within 1e-3 relative, global
keep sets (the coordinates some rank shipped and the global set kept)
with a Jaccard index >= 0.98 at each step and >= 0.99 on the mean;
global sets bitwise equal across the port's ranks, and under
``gtopk_hier`` the residual bitwise equal across the ranks of a slice.
Both sides price the plan and the buckets with the JAX package's probe
fit (``--comm-model-fit``).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax

import test_torch_rank_programs as programs
from test_torch_dist import LOSS_RTOL, MIN_JACCARD, MIN_STEP_JACCARD
from test_torch_slice import jax_state_as_numpy
from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.convert import layerwise_residual, load_jax_state
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel import comm_bytes_per_step
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
JAX_FIT = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                       "results", "dcn_probe_4proc.json")
STEPS = 2
# name -> (P, config on top of the common one)
# Per-leaf selection at P > 1 runs one selection a leaf (65 at ResNet-20):
# 'exact' there, where the JAX side would interpret 65 Pallas kernels.
CASES = {
    "layerwise_p2": (2, dict(compression="gtopk_layerwise",
                             topk_method="exact")),
    "layerwise_b3_p4": (4, dict(compression="gtopk_layerwise",
                                buckets="3")),
    "hier_p2_one_slice": (2, dict(compression="gtopk_hier", hier_ici=2)),
    "hier_p4": (4, dict(compression="gtopk_hier", hier_ici=2)),
}


def _per_bucket(gidx):
    return gidx if isinstance(gidx, list) else [gidx]


def _rows(residual):
    """The JAX trainer's residual as f32[P, N] (per-leaf buffers joined in
    leaf order under gtopk_layerwise)."""
    if isinstance(residual, (tuple, list)):
        return np.concatenate([np.asarray(x) for x in residual], axis=1)
    return np.asarray(residual)


@pytest.mark.parametrize("name", CASES)
def test_trainer_matches_the_jax_trainer(name):
    p, extra = CASES[name]
    common = dict(dnn="resnet20", batch_size=4, density=0.01,
                  topk_method="pallas", max_epochs=1, seed=3, nworkers=p,
                  comm_model_fit=JAX_FIT)
    common.update(extra)
    jt = JaxTrainer(JaxConfig(prefetch=0, log_interval=1, **common))
    states, want = [], []
    for _ in range(STEPS):
        states.append(jax_state_as_numpy(jt))
        loss = jt.train(1)["loss"]
        res = _rows(jax.tree.map(np.asarray, jt.state.opt_state.residual))
        want.append(dict(loss=loss, keep=np.any(res == 0, axis=0)))
    got = spawn(programs.trainer_steps_from_states, p, dict(common), states,
                backend="gloo", device="cpu", timeout=300)
    jaccards = []
    for step, w in enumerate(want):
        ranks = [got[r][step] for r in range(p)]
        np.testing.assert_allclose(ranks[0]["loss"], w["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
        for r in ranks[1:]:
            assert r["loss"] == ranks[0]["loss"]
            for a, b in zip(_per_bucket(r["gidx"]),
                            _per_bucket(ranks[0]["gidx"])):
                np.testing.assert_array_equal(a, b)
        if extra.get("hier_ici", 1) > 1:
            ici = extra["hier_ici"]
            for r in range(p):
                np.testing.assert_array_equal(
                    ranks[r]["residual"], ranks[r - r % ici]["residual"])
        keep = np.any(np.stack([r["residual"] for r in ranks]) == 0, axis=0)
        inter, union = np.sum(keep & w["keep"]), np.sum(keep | w["keep"])
        assert union >= 2725  # k = ceil(0.01 * 272474)
        assert inter / union >= MIN_STEP_JACCARD, (step, inter, union)
        jaccards.append(inter / union)
    assert np.mean(jaccards) >= MIN_JACCARD, jaccards


def test_load_jax_state_carries_a_layerwise_residual():
    """A JAX layer-wise trainer's state (a tuple of per-leaf residuals, and
    {"v": tuple, "u": tuple} under momentum correction) lands in the
    port's flat buffer in layout order."""
    for correction in (False, True):
        cfg = dict(dnn="resnet20", batch_size=4, compression="gtopk_layerwise",
                   density=0.01, topk_method="exact", max_epochs=1, seed=1,
                   momentum_correction=correction)
        jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, log_interval=1,
                                  **cfg))
        jt.train(1)
        state = jax_state_as_numpy(jt)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # layerwise x correction
            pt = Trainer(TrainConfig(device="cpu", **cfg))
        load_jax_state(pt, **state)
        res = pt.optimizer.state["residual"]
        want = layerwise_residual(state["residual"])
        if correction:
            for key in "vu":
                np.testing.assert_array_equal(res[key].numpy(), want[key])
                assert res[key].shape == (pt.num_params,)
        else:
            np.testing.assert_array_equal(res.numpy(), want)
        assert pt.optimizer.state["count"] == 1
    rows = (np.arange(6, dtype=np.float32).reshape(2, 3),
            np.full((2, 2), 7, np.float32))
    np.testing.assert_array_equal(layerwise_residual(rows, rank=1),
                                  [3, 4, 5, 7, 7])


def test_layerwise_with_correction_warns_as_jax():
    with pytest.warns(UserWarning, match="WORSE than either alone"):
        GTopKSGD([torch.nn.Parameter(torch.zeros(8))], 0.1,
                 compression="gtopk_layerwise", momentum_correction=True)


CLI_RUNS = {
    "layerwise-b2": (["--compression", "gtopk_layerwise", "--buckets", "2",
                      "--comm-plan", "balanced"], 2),
    "hier": (["--compression", "gtopk_hier", "--hier-ici", "2"], 4),
    "layerwise-leaf-fit": (["--compression", "gtopk_layerwise", "--buckets",
                            "leaf", "--comm-model-fit", JAX_FIT], 2),
}


@pytest.mark.parametrize("run", CLI_RUNS)
def test_cli_new_modes_train_on_cpu(capsys, run):
    extra, p = CLI_RUNS[run]
    rc = dist_trainer.main([
        "--nworkers", str(p), "--device", "cpu", "--density", "0.001",
        "--topk-method", "pallas", "--num-iters", "2", "--batch-size", "2",
        "--eval-batches", "1"] + extra)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nworkers"] == p and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    n = 272_474
    if run == "hier":
        assert out["comm_plan"] == "hier" and out["buckets"] is None
        assert out["wire_bytes_per_step"] == comm_bytes_per_step(
            "gtopk_hier", n, 273, p, ici_size=2)
    else:
        assert out["compression"] == "gtopk_layerwise"
        schedule = "balanced" if "balanced" in extra else None
        assert out["comm_plan"] == (schedule or "tree")
        want = sum(comm_bytes_per_step("gtopk_layerwise", nb, kb, p,
                                       schedule=schedule)
                   for nb, kb in out["buckets"])
        assert out["wire_bytes_per_step"] == want
        assert len(out["buckets"]) == (2 if run == "layerwise-b2" else 65)


def test_cli_flags_parse_and_refuse_as_jax():
    args = dist_trainer.build_argparser().parse_args([
        "--compression", "gtopk_layerwise", "--buckets", "auto",
        "--pipeline", "serial", "--comm-plan", "tree", "--comm-model-fit",
        "fit.json", "--hier-ici", "1"])
    cfg = dist_trainer.config_from_args(args)
    assert (cfg.buckets, cfg.pipeline, cfg.comm_plan, cfg.comm_model_fit,
            cfg.hier_ici) == ("auto", "serial", "tree", "fit.json", 1)
    defaults = dist_trainer.config_from_args(
        dist_trainer.build_argparser().parse_args([]))
    assert (defaults.buckets, defaults.pipeline, defaults.comm_plan,
            defaults.comm_model_fit, defaults.hier_ici) == (
        "concat", "serial", "auto", None, 1)
    base = ["--device", "cpu", "--num-iters", "1", "--batch-size", "2"]
    for extra, match in (
            (["--compression", "gtopk_layerwise", "--pipeline", "overlap"],
             "requires a bucketed layerwise wire"),
            (["--compression", "gtopk_layerwise", "--buckets", "2",
              "--pipeline", "auto"], "select_probe"),
            (["--compression", "gtopk", "--buckets", "leaf"],
             "only applies to the layerwise mode"),
            (["--compression", "gtopk", "--hier-ici", "2"],
             "only applies to hierarchical modes"),
            (["--compression", "gtopk_hier", "--hier-ici", "2",
              "--nworkers", "3"], "not divisible by hier_ici_size=2"),
            (["--compression", "gtopk_hier", "--comm-plan", "balanced"],
             "does not realize mode")):
        with pytest.raises(ValueError, match=match):
            dist_trainer.main(base + extra)
