"""The options of the flat path against the JAX package's ``gtopk_sgd``, on
the CPU: clip before compress, the dense warm-up, DGC momentum correction
(and its ablation knob), Nesterov, the wire codecs with their error fold,
and the allgather modes; at P = 1 in this process and at P = 4 on spawned
gloo ranks (one world for the file) against the 8-device CPU mesh.

Tolerances are those of ``tests/test_torch_optimizer.py`` and
``tests/test_torch_dist.py``: what was selected and exchanged is held
bitwise -- the zero patterns of the residual and of the velocity (the keep
and masking decisions), the global sets, the dense unions -- and the
parameters, residuals and velocities within 1e-6 (XLA and PyTorch may
fuse the sums of the SGD step, the clip norm and the velocity recursion
into FMAs or reduce in other orders, an ulp a step).

Also: the optimizer's argument errors, the trainer's lr ramp (bitwise the
JAX schedule), and a momentum-corrected JAX trainer state carried into
the port's trainer for one step.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_rank_programs as programs
from test_torch_dist import _jax_optimizer_run
from test_torch_slice import MIN_JACCARD, jax_state_as_numpy
from gtopkssgd_tpu.optimizer import gtopk_sgd
from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from gtopkssgd_tpu_torch.convert import load_jax_state
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
SGD_TOL = 1e-6
LOSS_RTOL = 1e-3
STEPS = 4
BASE = dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
            density=0.01)
# name -> gtopk_sgd options on top of BASE. The clip binds: ||g|| is
# about sqrt(N) = 173 here.
CASES = {
    "clip": dict(compression="gtopk", topk_method="pallas",
                 clip_grad_norm=50.0),
    "warmup": dict(compression="gtopk", topk_method="pallas",
                   warmup_dense_steps=2),
    "correction": dict(compression="gtopk", topk_method="pallas",
                       momentum_correction=True),
    "correction_restore": dict(compression="gtopk", topk_method="exact",
                               momentum_correction=True,
                               _restore_rejected_u=True),
    "correction_warmup_clip": dict(compression="gtopk",
                                   topk_method="exact",
                                   momentum_correction=True,
                                   warmup_dense_steps=2,
                                   clip_grad_norm=50.0),
    "nesterov": dict(compression="gtopk", topk_method="exact",
                     nesterov=True),
    "int8": dict(compression="gtopk", topk_method="exact",
                 wire_codec="int8"),
    "allgather_int8": dict(compression="allgather", topk_method="exact",
                           wire_codec="int8"),
    "topk_int8": dict(compression="topk", topk_method="exact",
                      wire_codec="int8"),
}
P1_CASES = dict(CASES, nesterov_dense=dict(compression="dense",
                                           topk_method="exact",
                                           nesterov=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_kwargs(kw):
    return {("lr" if key == "learning_rate" else key): v
            for key, v in kw.items()}


def _split(residual):
    """(v, u) of a residual: u is None without momentum correction."""
    if isinstance(residual, dict):
        return residual["v"], residual["u"]
    return residual, None


def _assert_state_matches(got_res, want_res, msg):
    """Residual and velocity within SGD_TOL, their zero patterns (what
    was kept and masked) bitwise."""
    (gv, gu), (wv, wu) = _split(got_res), _split(want_res)
    assert (gu is None) == (wu is None), msg
    for got, want in ((gv, wv), (gu, wu)):
        if got is None:
            continue
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=msg)
        np.testing.assert_allclose(got, want, rtol=0, atol=SGD_TOL,
                                   err_msg=msg)


def _grads(p, n, steps, seed):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(n).astype(np.float32)
    shape = (p, n) if p > 1 else (n,)
    return p0, [rng.standard_normal(shape).astype(np.float32)
                for _ in range(steps)]


@pytest.mark.parametrize("case", P1_CASES)
def test_options_at_p1_match_jax(case):
    kw = dict(BASE, **P1_CASES[case])
    n = 30_000
    p0, grads = _grads(1, n, STEPS, seed=11)
    tx = gtopk_sgd(axis_name=None, **kw)
    jparams = {"w": jnp.asarray(p0)}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    p = torch.nn.Parameter(_t(p0.copy()))
    opt = GTopKSGD([p], **_port_kwargs(kw))
    warmup = kw.get("warmup_dense_steps", 0)
    for step, g in enumerate(grads):
        upd, jstate = update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        p.grad = _t(g.copy())
        opt.step()
        msg = f"{case} step {step}"
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=0,
                                   atol=SGD_TOL, err_msg=msg)
        if kw["compression"] == "dense":
            continue
        _assert_state_matches(
            opt.state["residual"],
            jax.tree.map(np.asarray, jstate.residual), msg)
        # A keep mask exactly at the sparse steps; kept coordinates have
        # a zero residual (and a zero velocity).
        assert (opt.last_keep is None) == (step < warmup), msg
        if opt.last_keep is not None:
            v, u = _split(opt.state["residual"])
            assert torch.all(v[opt.last_keep] == 0), msg
            if u is not None:
                assert torch.all(u[opt.last_keep] == 0), msg
    assert opt.state["count"] == STEPS
    if kw.get("momentum_correction"):  # the SGD step keeps no momentum
        assert "momentum_buffer" not in opt.state[p]
        assert opt.param_groups[0]["momentum"] == 0.0


@pytest.fixture(scope="module")
def port_at_p4():
    """Every case of CASES on 4 gloo ranks, from one spawn."""
    p, n = 4, 30_000
    p0, grads = _grads(p, n, STEPS, seed=12)
    cases = {name: _port_kwargs(dict(BASE, **kw))
             for name, kw in CASES.items()}
    got = spawn(programs.optimizer_cases, p, p0, grads, cases,
                backend="gloo", device="cpu", timeout=300)
    return p, p0, grads, got


@pytest.mark.parametrize("case", CASES)
def test_options_at_p4_match_jax(port_at_p4, case):
    p, p0, grads, got = port_at_p4
    kw = dict(BASE, **CASES[case])
    want = _jax_optimizer_run(p0, grads, p, kw)
    allgather = kw["compression"] != "gtopk"
    for step, w in enumerate(want):
        for r in range(p):
            g = got[r][case][step]
            msg = f"{case} step {step} rank {r}"
            np.testing.assert_allclose(g["params"], w["params"], rtol=0,
                                       atol=SGD_TOL, err_msg=msg)
            # Replicas stay bitwise equal.
            np.testing.assert_array_equal(g["params"],
                                          got[0][case][step]["params"])
            _assert_state_matches(g["residual"],
                                  jax.tree.map(lambda x: x[r], w["residual"]),
                                  msg)
            if w["sent"] is None:  # dense warm-up step
                assert g["gidx"] is None and g["union"] is None, msg
            elif allgather:
                assert g["gidx"] is None, msg
                np.testing.assert_array_equal(g["union"], w["sent"],
                                              err_msg=msg)
            else:
                assert g["union"] is None, msg
                np.testing.assert_array_equal(g["gidx"], w["sent"][1],
                                              err_msg=msg)
                if "clip_grad_norm" in kw:
                    # The clip scale comes from a norm that XLA and torch
                    # sum in different orders: the values carry its ulp.
                    np.testing.assert_allclose(g["gvals"], w["sent"][0],
                                               rtol=0, atol=SGD_TOL,
                                               err_msg=msg)
                else:
                    np.testing.assert_array_equal(g["gvals"], w["sent"][0],
                                                  err_msg=msg)


# (gtopk_sgd kwargs, what both must refuse) -- the JAX optimizer's checks,
# in its order; the messages must be the same.
BAD = [
    dict(compression="dense", momentum_correction=True),
    dict(compression="gtopk", momentum_correction=True, momentum=0.0),
    dict(compression="gtopk", momentum_correction=True, nesterov=True),
    dict(compression="gtopk", nesterov=True, momentum=0.0),
    dict(compression="gtopk", warmup_dense_steps=-1),
    dict(compression="gtopk", _restore_rejected_u=True),
    dict(compression="gtopk", wire_codec="int4"),
    dict(compression="nope"),
    dict(compression="gtopk_hier", hier_ici_size=0),
    dict(compression="gtopk", hier_ici_size=2),
    dict(compression="gtopk", buckets="leaf"),
    dict(compression="gtopk_layerwise", buckets=0),
    dict(compression="gtopk_hier", comm_plan="balanced"),
    dict(compression="allgather", comm_plan="tree"),
]


@pytest.mark.parametrize("bad", range(len(BAD)))
def test_option_errors_match_jax(bad):
    kw = BAD[bad]
    with pytest.raises(ValueError) as want:
        gtopk_sgd(0.1, **{"momentum": 0.9, **kw})
    with pytest.raises(ValueError) as got:
        GTopKSGD([torch.nn.Parameter(torch.zeros(8))], 0.1,
                 **{"momentum": 0.9, **kw})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["gtopk_hier", "gtopk_layerwise"])
def test_later_modes_are_refused_by_the_optimizer(mode):
    """Both modes are in the port (tests/test_torch_layerwise.py), and so
    are the bucketed wire's ``overlap`` and ``auto`` pipelines
    (tests/test_torch_pipeline.py). What is refused, with the JAX
    optimizer's message: ``overlap`` without buckets (a concat wire, or a
    mode with one set a step). ``auto`` there is 'serial'."""
    params = [torch.nn.Parameter(torch.zeros(8))]
    assert GTopKSGD(params, 0.1, compression=mode).mode == mode
    assert GTopKSGD(params, 0.1, compression=mode,
                    pipeline="auto").bucket_plan is None
    with pytest.raises(ValueError) as want:
        gtopk_sgd(0.1, compression=mode, pipeline="overlap")
    with pytest.raises(ValueError) as got:
        GTopKSGD(params, 0.1, compression=mode, pipeline="overlap")
    assert str(got.value) == str(want.value)
    assert "requires a bucketed layerwise wire" in str(got.value)


def test_lr_ramp_is_bitwise_the_jax_schedule():
    pt = Trainer(TrainConfig(batch_size=32, warmup_epochs=1, max_epochs=4,
                             device="cpu"))
    spe = pt.steps_per_epoch
    assert spe == 64
    stub = types.SimpleNamespace(cfg=pt.cfg, steps_per_epoch=spe)
    stub._dataset_schedule = lambda base, s: JaxTrainer._dataset_schedule(
        stub, base, s)
    jsched = JaxTrainer._lr_schedule(stub)
    counts = np.arange(4 * spe, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(counts)))
    assert want.dtype == np.float32
    sched = pt.lr_schedule()
    got = np.array([sched(int(c)) for c in counts], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == np.float32(0.1) * np.float32(0.1)  # ramp from lr/10
    assert got[spe] == np.float32(0.1)                  # ramp done
    assert got[2 * spe] < got[2 * spe - 1]              # the cifar step


def test_trainer_step_from_a_corrected_jax_state():
    """A momentum-corrected JAX trainer's state ({"v", "u"} residual, no
    SGD momentum) carried into the port's trainer: one step matches the
    JAX step (loss within 1e-3; keep sets, from v == 0, with a Jaccard
    index >= 0.99, as in tests/test_torch_slice.py)."""
    common = dict(dnn="resnet20", batch_size=8, compression="gtopk",
                  density=0.01, topk_method="pallas", max_epochs=1, seed=3,
                  momentum_correction=True)
    jt = JaxTrainer(JaxConfig(nworkers=1, prefetch=0, log_interval=1,
                              **common))
    pt = Trainer(TrainConfig(device="cpu", **common))
    jt.train(1)  # a state with a nonzero v and u
    pt.train(1)  # the same batch drawn, so step 2 reads the same batch
    state = jax_state_as_numpy(jt)
    assert state["momentum"] is None and set(state["residual"]) == {"v",
                                                                    "u"}
    load_jax_state(pt, **state)
    res = pt.optimizer.state["residual"]
    np.testing.assert_array_equal(res["u"].numpy(), state["residual"]["u"])
    assert pt.optimizer.state["count"] == 1
    jloss = jt.train(1)["loss"]
    ploss = pt.train(1)["loss"]
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    jres = jt.state.opt_state.residual
    jkeep = np.asarray(jres["v"]) == 0
    pres = pt.optimizer.state["residual"]
    pkeep = pres["v"].numpy() == 0
    inter, union = np.sum(jkeep & pkeep), np.sum(jkeep | pkeep)
    assert union >= 2725  # k = ceil(0.01 * 272474)
    assert inter / union >= MIN_JACCARD, (inter, union)
    # Both masked the velocity where they kept.
    keep = pt.optimizer.last_keep.numpy()
    assert np.all(pres["u"].numpy()[keep] == 0)
    assert np.all(np.asarray(jres["u"])[jkeep & (np.asarray(jres["v"]) == 0)]
                  == 0)
