"""``--steps-per-dispatch K`` in the port: the stated rule that picks a
CUDA graph or the staged loop (``trainer.dispatch_rule``), the staged
loop against K = 1 (bitwise: the same ops on the same values, only the
host batches are staged and the host syncs once a dispatch), against the
JAX trainer's ``steps_per_dispatch`` (its own test's tolerance, rtol
2e-5 and atol 2e-6, ``tests/test_trainer.py``), the JAX trainer's errors
for a ragged ``num_iters`` and for ``fit()``, and on the card (skipped
here) the graph against the eager step.
"""

import numpy as np
import pytest
import torch

import test_torch_rank_programs as programs
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer, dispatch_rule

torch.set_num_threads(2)
SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", eval_batches=1)


@pytest.mark.parametrize("cfg,want", [
    (dict(), "staged"),
    (dict(steps_per_dispatch=4), "graph"),
    (dict(steps_per_dispatch=4, topk_method="pallas"), "graph"),
    (dict(steps_per_dispatch=4, topk_method="auto"), "graph"),
    (dict(steps_per_dispatch=4, compression=None), "graph"),
    (dict(steps_per_dispatch=4, compression="gtopk_layerwise"), "graph"),
    (dict(steps_per_dispatch=4, topk_method="threshold"), "staged"),
    (dict(steps_per_dispatch=4, nworkers=2), "staged"),
    (dict(steps_per_dispatch=4, compression="allgather"), "staged"),
    (dict(steps_per_dispatch=4, compression="gtopk_layerwise",
          buckets="leaf", pipeline="overlap"), "staged"),
    (dict(steps_per_dispatch=4, device="cpu"), "staged"),
])
def test_dispatch_rule(cfg, want):
    full = TrainConfig(**{**SMALL, "device": "cuda", **cfg})
    assert dispatch_rule(full) == want
    # AN4's CTC reads its lengths back to the host: never a graph.
    an4 = TrainConfig(**{**SMALL, "device": "cuda", **cfg, "dnn": "lstman4"})
    assert dispatch_rule(an4) == "staged"


@pytest.mark.parametrize("extra", [
    dict(),
    dict(topk_method="pallas", momentum_correction=True, nsteps_update=2),
    dict(compression=None, warmup_epochs=1),
], ids=["twostage", "pallas-correction-accumulate", "dense-ramp"])
def test_staged_dispatch_equals_one_step_a_dispatch(extra):
    """8 steps at K = 1 and at K = 4 on the CPU: every loss and every
    tensor of the state bitwise equal."""
    out = programs.dispatch_runs("cpu", {**SMALL, **extra}, 8, (1, 4))
    assert out[1]["dispatch"] == out[4]["dispatch"] == "staged"
    assert out[1]["losses"] == out[4]["losses"]
    for name, t in out[1]["state"].items():
        assert torch.equal(t, out[4]["state"][name]), name


def test_staged_dispatch_at_two_ranks():
    """P = 2 over gloo, K = 2 against K = 1 on each rank, bitwise."""
    ranks = spawn(programs.dispatch_runs, 2, dict(SMALL, nworkers=2), 4,
                  (1, 2), backend="gloo", device="cpu", timeout=300)
    for out in ranks:
        assert out[2]["dispatch"] == "staged"
        assert out[1]["losses"] == out[2]["losses"]
        for name, t in out[1]["state"].items():
            np.testing.assert_array_equal(t, out[2]["state"][name],
                                          err_msg=name)


@pytest.mark.parametrize("compression,method", [(None, "exact"),
                                                ("gtopk", "pallas")])
def test_dispatch_semantics_match_the_jax_trainer(compression, method):
    """From one state (the JAX trainer's, carried into the port), four
    steps as one dispatch and as four on each side. The JAX trainer's
    ``steps_per_dispatch=4`` equals its per-step path within its own
    test's tolerance (rtol 2e-5, atol 2e-6) in the parameters, the SGD
    momentum, the residual and the reported loss (the dispatch's last
    step's); the port's is bitwise its per-step path, well within that.
    Across the frameworks the first step agrees within the slice test's
    1e-3: two trainers run free diverge (measured here: 1.4% in the
    loss by step 4, dense, batch 4), so no cross-framework state after
    four steps is held to 2e-5."""
    import jax
    from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
    from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
    from jax.flatten_util import ravel_pytree
    from test_torch_slice import jax_state_as_numpy
    from gtopkssgd_tpu_torch.convert import load_jax_state

    common = dict(dnn="resnet20", batch_size=4, compression=compression,
                  density=0.01, topk_method=method, lr=0.05, max_epochs=1)
    jax_runs, port_runs = {}, {}
    init = None
    for k in (1, 4):
        jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, obs_counters=False,
                                  obs_goodput=False, steps_per_dispatch=k,
                                  **common))
        init = init or jax_state_as_numpy(jt)
        with Trainer(TrainConfig(device="cpu", steps_per_dispatch=k,
                                 **common)) as pt:
            load_jax_state(pt, **init)
            stats = pt.train(4)
            port_runs[k] = (stats, pt.checkpoint_state())
        losses = [jt.train(k)["loss"] for _ in range(4 // k)]
        st = jax_state_as_numpy(jt)
        jax_runs[k] = (losses[-1], [
            ravel_pytree(st["params"])[0], ravel_pytree(st["momentum"])[0]]
            + jax.tree.leaves(st["residual"]))
        if k == 1:
            jfirst = losses[0]
    (want_loss, want), (got_loss, got) = jax_runs[1], jax_runs[4]
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-5, atol=2e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    one, four = port_runs[1], port_runs[4]
    assert four[0]["dispatch"] == "staged"
    assert four[0]["loss"] == one[0]["losses"][-1]
    assert four[0]["losses"] == one[0]["losses"]
    for name, t in one[1].items():
        assert torch.equal(t, four[1][name]), name
    np.testing.assert_allclose(one[0]["losses"][0], jfirst, rtol=1e-3)


def test_ragged_num_iters_and_fit_refused():
    with Trainer(TrainConfig(device="cpu", steps_per_dispatch=4,
                             **SMALL)) as t:
        with pytest.raises(ValueError, match="multiple of"):
            t.train(6)
    with Trainer(TrainConfig(device="cpu", steps_per_dispatch=3,
                             **SMALL)) as t:
        assert t.steps_per_epoch % 3  # 512
        with pytest.raises(ValueError, match="must divide"):
            t.fit(1)
    with pytest.raises(ValueError, match=">= 1"):
        Trainer(TrainConfig(device="cpu", steps_per_dispatch=0, **SMALL))


@pytest.mark.cuda
@pytest.mark.parametrize("method,steps,captures", [
    ("twostage", 16, 1), ("pallas", 16, 1), ("twostage", 80, 2)],
    ids=["twostage", "pallas", "lr-boundary"])
def test_graph_dispatch_equals_eager_steps_on_card(method, steps, captures):
    """On a CUDA card, under deterministic algorithms (cuDNN's default
    convolution backward is not): `steps` steps at K = 8 replay a
    captured graph and equal as many eager steps, bitwise; the selection
    kernel, the threshold apply and the SGD apply are recorded once a
    capture and replayed at every step but the first (eager: SGD makes
    its momentum buffers). Batch 32, max_epochs
    2: an epoch is 64 steps and the cifar10 schedule cuts the lr at step
    64, so 80 steps capture a second graph there. chip_smoke.py phase 11d
    runs the first two at full batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    from gtopkssgd_tpu_torch.ops import cuda_topk

    cfg = dict(SMALL, topk_method=method, device="cuda", batch_size=32,
               max_epochs=2)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with Trainer(TrainConfig(**cfg)) as eager:
            assert eager.steps_per_epoch == 64
            want = eager.train(steps)["losses"]
            want_state = eager.checkpoint_state()
            want_lr = eager.optimizer.param_groups[0]["lr"]
        cuda_topk.reset_launches()
        with Trainer(TrainConfig(steps_per_dispatch=8, **cfg)) as graph:
            got = graph.train(steps)
            got_lr = graph.optimizer.param_groups[0]["lr"]
            got_state = graph.checkpoint_state()
            stats = graph.graph_stats
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    assert got["dispatch"] == "graph" and got["losses"] == want
    assert got_lr == want_lr
    for name, t in got_state.items():
        assert torch.equal(t, want_state[name]), name
    kernel = {"twostage": "fused_stage1_candidates",
              "pallas": "multisection_tau_lo[residual]"}[method]
    assert stats["replays"] == steps - 1 and stats["captures"] == captures
    # the selection's kernel, the threshold apply and the SGD apply, once
    # a step each
    assert stats["captured"] == {kernel: captures,
                                 "threshold_apply": captures,
                                 "sgd_apply": captures}
    assert stats["replayed"] == {kernel: steps - 1,
                                 "threshold_apply": steps - 1,
                                 "sgd_apply": steps - 1}
    # the first step's launch and one a record
    assert cuda_topk.launches[kernel] == 1 + captures
    assert cuda_topk.launches["threshold_apply"] == 1 + captures
    assert cuda_topk.launches["sgd_apply"] == 1 + captures
