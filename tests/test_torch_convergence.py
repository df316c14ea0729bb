"""The port's twin of the reference's convergence gate
(``tests/test_convergence.py``, SURVEY.md section 4): ResNet-20 trained
free on a fixed batch, 4-way data-parallel, 40 steps, with the
reference's setup, arms and thresholds.

* P = 4 gloo ranks on the CPU (``parallel.dist.spawn``), batch 8 a rank:
  X f32[4, 8, 32, 32, 3] standard normal and Y i32[4, 8] in [0, 10), both
  from ``np.random.default_rng(1)``; rank r trains on row r every step.
* ``GTopKSGD`` at lr 0.05, momentum 0.9, no weight decay; after each step
  the BatchNorm statistics are averaged over the ranks (the reference's
  ``pmean``) and the loss recorded is the mean of the ranks' losses.
* Every arm starts from the reference's own initial state:
  ``get_model("resnet20")`` initialised with ``PRNGKey(0)``, handed to
  the ranks as numpy trees and loaded with ``convert.load_jax_state``.
  The rank program (``test_torch_rank_programs.convergence_arms``)
  imports no jax.
* Arms: dense must reach 0.35 x its first loss; ``gtopk`` (``auto``),
  ``allgather``, ``gtopk_hier`` (slices of 2) and ``gtopk`` with
  ``approx`` selection at rho = 0.01 half their first loss, and the
  ``gtopk`` family below dense's first loss. ``approx`` is the port's
  ``twostage`` path; on the CPU it runs the stage-1 kernel's plain twin.
  All five run in one spawn, each test reading its arm.
* The anchor: the port's step-0 loss, the mean over the ranks, against
  the JAX model's train-mode forward on the same four batches from the
  same state, within 1e-5 relative. It shows both gates pose the same
  problem. After step 0 the runs are free: top-k selection is
  discontinuous, so no later step is compared.

The ``slow`` arm is the twin of ``test_gtopk_rho001_long_horizon``: 300
steps at rho = 0.001.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import test_torch_rank_programs as programs
from gtopkssgd_tpu.models import get_model
from gtopkssgd_tpu_torch.parallel.dist import spawn

PDEV, BATCH, STEPS = 4, 8, 40
LOSS_RTOL = 1e-5
ARMS = {
    "dense": dict(compression="dense", density=1.0),
    "gtopk": dict(compression="gtopk", density=0.01),
    "allgather": dict(compression="allgather", density=0.01),
    "hier": dict(compression="gtopk_hier", density=0.01, hier_ici=2),
    "approx": dict(compression="gtopk", density=0.01, topk_method="approx"),
}


def _train_kwargs(arm: dict) -> dict:
    return {"topk_method": "auto", "batch_size": BATCH, "lr": 0.05,
            "momentum": 0.9, "weight_decay": 0.0, **arm}


@pytest.fixture(scope="module")
def problem():
    """The reference's initial state as numpy trees, and its inputs."""
    model, _ = get_model("resnet20")
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 32, 32, 3)))
    npr = np.random.default_rng(1)
    x = npr.standard_normal((PDEV, BATCH, 32, 32, 3)).astype(np.float32)
    y = npr.integers(0, 10, (PDEV, BATCH)).astype(np.int32)
    state = {key: jax.tree.map(np.asarray, variables[key])
             for key in ("params", "batch_stats")}
    return model, variables, state, x, y


def _run(problem, arms: dict) -> dict:
    """{name: (arm, steps)} on P gloo ranks; the losses by name (every
    rank records the same means)."""
    _, _, state, x, y = problem
    ranks = spawn(programs.convergence_arms, PDEV, state, x, y,
                  {name: (_train_kwargs(arm), steps)
                   for name, (arm, steps) in arms.items()},
                  backend="gloo", device="cpu", timeout=600)
    for r in ranks[1:]:
        assert r == ranks[0]
    return ranks[0]


@pytest.fixture(scope="module")
def losses(problem):
    return _run(problem, {name: (arm, STEPS) for name, arm in ARMS.items()})


def test_step0_loss_matches_the_jax_forward(problem, losses):
    """Every arm's step-0 loss (before any update) is the JAX model's
    train-mode loss on the same batches from the same state."""
    model, variables, _, x, y = problem
    per_rank = []
    for r in range(PDEV):
        out, _ = model.apply(variables, jnp.asarray(x[r]), train=True,
                             mutable=["batch_stats"])
        per_rank.append(optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y[r])).mean())
    want = float(jnp.mean(jnp.stack(per_rank)))
    for name, arm in losses.items():
        assert len(arm) == STEPS
        np.testing.assert_allclose(arm[0], want, rtol=LOSS_RTOL,
                                   err_msg=name)


def test_dense_overfits(losses):
    dense = losses["dense"]
    assert dense[-1] < 0.35 * dense[0], dense[::10]


def test_gtopk_tracks_dense(losses):
    gtopk = losses["gtopk"]
    # error feedback at 1% density: slower but must clearly converge
    assert gtopk[-1] < 0.5 * gtopk[0], gtopk[::10]
    assert gtopk[-1] < losses["dense"][0]


def test_allgather_tracks_dense(losses):
    dgc = losses["allgather"]
    assert dgc[-1] < 0.5 * dgc[0], dgc[::10]


def test_hier_tracks_dense(losses):
    """Dense within slices of 2 ranks, gTop-k across them: the global set
    is the gTop-k of slice sums, between local and exact top-k."""
    hier = losses["hier"]
    assert hier[-1] < 0.5 * hier[0], hier[::10]
    assert hier[-1] < losses["dense"][0]


def test_gtopk_converges_under_approx_selection(losses):
    """``approx`` through the optimizer end to end: in the port the
    ``twostage`` path (the stage-1 kernel's candidates, then the exact
    top-k of them), whose CPU run is the kernel's plain twin."""
    approx = losses["approx"]
    assert approx[-1] < 0.5 * approx[0], approx[::10]
    assert approx[-1] < losses["dense"][0]


@pytest.mark.slow  # 300 steps at P = 4; rho = 0.01 stays in tier-1 above
def test_gtopk_rho001_long_horizon(problem):
    """The paper's operating point (rho = 0.001, k = 273 of 272,474) over
    300 steps, with the reference's thresholds: loss[150] below half the
    first loss, the last below 0.05 x the first."""
    gtopk = _run(problem, {"gtopk": (dict(compression="gtopk",
                                          density=0.001), 300)})["gtopk"]
    assert gtopk[150] < 0.5 * gtopk[0], gtopk[::25]
    assert gtopk[-1] < 0.05 * gtopk[0], gtopk[::25]
