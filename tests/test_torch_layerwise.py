"""``GTopKSGD`` in modes ``gtopk_layerwise`` (every ``--buckets`` spec,
both schedules) and ``gtopk_hier`` against the JAX package's
``gtopk_sgd``, step by step on the CPU: at P = 1 in this process, at
P = 4 on spawned gloo ranks (one world for the file) against the
8-device CPU mesh.

The parameters are seven leaves of sizes 10 to 4,608 (one parameter
each, the layout's order being the JAX tree's); the gradients are given,
so each step starts both sides from inputs that agree. Held: the global
sets of every merge (every bucket) bitwise, read out of the JAX
optimizer where it calls ``sparse_allreduce``; the residual -- the JAX
package's tuple of per-leaf buffers carried into the port's flat layout
by ``convert.layerwise_residual`` -- bitwise, and within 1e-6 under the
clip (its norm is summed in another order); the parameters within 1e-6,
as in ``tests/test_torch_options.py`` (XLA and PyTorch may fuse the SGD
sums into FMAs differently, an ulp a step). Selection is ``exact``,
``threshold`` or ``pallas`` (the JAX side runs the Pallas count kernel in
interpret mode, the port the CUDA kernel's plain twin); ``twostage``
selects in another layout off the TPU and is held to itself instead: a
bucketed step with one bucket is bitwise the flat ``gtopk`` step.
"""

import os
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import gtopkssgd_tpu.optimizer as jopt
import test_torch_rank_programs as programs
from gtopkssgd_tpu.optimizer import GTopKSGDState, gtopk_sgd
from gtopkssgd_tpu.parallel import make_mesh
from gtopkssgd_tpu_torch.convert import layerwise_residual
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.dist import spawn

torch.set_num_threads(2)
SGD_TOL = 1e-6
STEPS = 3
LEAVES = (10, 640, 37, 4608, 300, 2048, 16)
# The JAX optimizer prices its bucket DP with the JAX package's probe fit;
# the port prices with the same file.
JAX_FIT = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                       "results", "dcn_probe_4proc.json")
BASE = dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
            density=0.01)


def _problem(p, seed):
    rng = np.random.default_rng(seed)
    leaves0 = [rng.standard_normal(s).astype(np.float32) for s in LEAVES]
    grads = [[(rng.standard_normal((p, s)) * (1 + 3 * (i % 2))).astype(
        np.float32) for i, s in enumerate(LEAVES)] for _ in range(STEPS)]
    return leaves0, grads


def _jax_run(leaves0, grads, p, kw):
    """The JAX optimizer on the leaves, one step per entry of `grads`; per
    step the flat parameters, each device's residual (numpy, the JAX
    layout) and the global sets each device got from each
    ``sparse_allreduce`` call, in call order."""
    names = [f"l{i}" for i in range(len(leaves0))]
    captured, sites = {}, []
    original = jopt.sparse_allreduce

    def capture(*args, **kwargs):
        out = original(*args, **kwargs)
        site = len(sites)
        sites.append(site)

        def keep(rank, v, i):
            captured[(site, int(rank))] = (np.asarray(v), np.asarray(i))

        jax.debug.callback(keep, lax.axis_index("dp"), out[0], out[1])
        return out

    params = {name: jnp.asarray(x) for name, x in zip(names, leaves0)}
    out = []
    with mock.patch.object(jopt, "sparse_allreduce", capture), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tx = gtopk_sgd(axis_name="dp" if p > 1 else None, axis_size=p,
                       **kw)
    state = tx.init(params)
    if p == 1:
        def step(params, state, g):
            upd, state = tx.update(g, state, params)
            return optax.apply_updates(params, upd), state
    else:
        res_spec = jax.tree.map(lambda _: P("dp"), state.residual)
        spec = GTopKSGDState(count=P(), residual=res_spec, inner=P(),
                             telemetry=P())

        def body(params, state, g):
            row = jax.tree.map(lambda x: x[0], state.residual)
            upd, state = tx.update(jax.tree.map(lambda x: x[0], g),
                                   state._replace(residual=row), params)
            return (optax.apply_updates(params, upd),
                    state._replace(residual=jax.tree.map(
                        lambda x: x[None], state.residual)))

        step = jax.shard_map(body, mesh=make_mesh(p),
                             in_specs=(P(), spec, P("dp")),
                             out_specs=(P(), spec), check_vma=False)
        state = state._replace(residual=jax.tree.map(
            lambda x: jnp.zeros((p,) + x.shape, x.dtype), state.residual))
    with mock.patch.object(jopt, "sparse_allreduce", capture):
        step = jax.jit(step)
        for g in grads:
            captured.clear()
            gtree = {name: jnp.asarray(x) for name, x in zip(names, g)}
            params, state = step(params, state, gtree)
            jax.block_until_ready(params)
            jax.effects_barrier()
            order = sorted({site for site, _ in captured})
            out.append({
                "params": np.concatenate([np.asarray(params[name])
                                          for name in names]),
                "residual": jax.tree.map(np.asarray, state.residual),
                "sets": [[captured[(site, r)] for site in order]
                         for r in range(p)]})
    return out


def _flat_residual(residual, rank, p):
    """The JAX residual of device `rank` in the port's flat layout."""
    if isinstance(residual, dict) and not isinstance(residual["v"],
                                                     (tuple, list)):
        return {key: np.asarray(residual[key])[rank] if p > 1
                else np.asarray(residual[key]) for key in "vu"}
    if isinstance(residual, (tuple, list, dict)):
        return layerwise_residual(residual, rank)
    residual = np.asarray(residual)
    return residual[rank] if p > 1 else residual


def _sets(port_global):
    if port_global is None:
        return []
    if isinstance(port_global, list):
        return [tuple(np.asarray(x) for x in s) for s in port_global]
    return [tuple(np.asarray(x) for x in port_global)]


def _check(got_steps, want_steps, rank, p, kw, name):
    exact_values = kw.get("clip_grad_norm") is None
    for step, (g, w) in enumerate(zip(got_steps, want_steps)):
        msg = f"{name} step {step} rank {rank}"
        np.testing.assert_allclose(np.asarray(g["params"]), w["params"],
                                   rtol=0, atol=SGD_TOL, err_msg=msg)
        want_res = _flat_residual(w["residual"], rank, p)
        got_res = g["residual"]
        pairs = ([(got_res[key], want_res[key]) for key in "vu"]
                 if isinstance(want_res, dict) else [(got_res, want_res)])
        for a, b in pairs:
            a = np.asarray(a)
            np.testing.assert_array_equal(a == 0, b == 0, err_msg=msg)
            if exact_values:
                np.testing.assert_array_equal(a.view(np.int32),
                                              b.view(np.int32), err_msg=msg)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=SGD_TOL,
                                           err_msg=msg)
        got_sets = _sets(g["global"])
        want_sets = w["sets"][rank] if p > 1 else []
        assert len(got_sets) == len(want_sets), msg
        for (gv, gi), (wv, wi) in zip(got_sets, want_sets):
            np.testing.assert_array_equal(gi, wi, err_msg=msg)
            if exact_values:
                np.testing.assert_array_equal(gv.view(np.int32),
                                              wv.view(np.int32),
                                              err_msg=msg)
            else:
                np.testing.assert_allclose(gv, wv, rtol=0, atol=SGD_TOL)


def _port_kw(kw):
    out = {("lr" if key == "learning_rate" else key): v
           for key, v in {**BASE, **kw}.items()}
    out.setdefault("comm_model_fit", JAX_FIT)
    return out


LW = dict(compression="gtopk_layerwise")
P1_CASES = {
    "concat_exact": dict(LW, topk_method="exact"),
    "concat_pallas": dict(LW, topk_method="pallas"),
    "concat_threshold": dict(LW, topk_method="threshold"),
    "leaf_exact": dict(LW, topk_method="exact", buckets="leaf"),
    "b3_pallas": dict(LW, topk_method="pallas", buckets=3),
    "clip": dict(LW, topk_method="exact", clip_grad_norm=5.0),
    "correction": dict(LW, topk_method="exact", momentum_correction=True),
    "warmup_b3": dict(LW, topk_method="exact", buckets=3,
                      warmup_dense_steps=1),
    "hier": dict(compression="gtopk_hier", topk_method="exact"),
}


@pytest.mark.parametrize("name", P1_CASES)
def test_p1_matches_jax(name):
    kw = P1_CASES[name]
    leaves0, grads = _problem(1, seed=len(name))
    grads = [[g[0] for g in step] for step in grads]
    want = _jax_run(leaves0, grads, 1, {**BASE, **kw})
    params = [torch.nn.Parameter(torch.from_numpy(x.copy()))
              for x in leaves0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = GTopKSGD(params, **_port_kw(kw))
    got = []
    for step_grads in grads:
        for prm, g in zip(params, step_grads):
            prm.grad = torch.from_numpy(g.copy())
        opt.step()
        got.append({"params": torch.cat([x.detach().reshape(-1)
                                         for x in params]),
                    "residual": programs._cpu(opt.state["residual"]),
                    "global": None})
    _check(got, want, 0, 1, kw, name)


P4_CASES = {
    "concat_tree": dict(LW, topk_method="exact"),
    "concat_balanced": dict(LW, topk_method="exact", comm_plan="balanced"),
    "leaf_tree": dict(LW, topk_method="exact", buckets="leaf"),
    "leaf_balanced": dict(LW, topk_method="exact", buckets="leaf",
                          comm_plan="balanced"),
    "b3_tree": dict(LW, topk_method="pallas", buckets=3),
    "b3_balanced_fp8": dict(LW, topk_method="exact", buckets=3,
                            comm_plan="balanced", wire_codec="fp8:32"),
    "concat_int8": dict(LW, topk_method="exact", wire_codec="int8"),
    "concat_clip": dict(LW, topk_method="exact", clip_grad_norm=5.0),
    "concat_correction_restore": dict(LW, topk_method="exact",
                                      momentum_correction=True,
                                      _restore_rejected_u=True),
    "b3_warmup_correction": dict(LW, topk_method="exact", buckets=3,
                                 warmup_dense_steps=1,
                                 momentum_correction=True),
    "gtopk_balanced_int8": dict(compression="gtopk", topk_method="exact",
                                comm_plan="balanced", wire_codec="int8"),
    "hier2": dict(compression="gtopk_hier", topk_method="exact",
                  hier_ici_size=2),
    "hier2_int8_warmup": dict(compression="gtopk_hier", topk_method="exact",
                              hier_ici_size=2, wire_codec="int8",
                              warmup_dense_steps=1),
}
# Bitwise twins on the port alone: B = 1 against the flat gtopk step.
TWIN_CASES = {
    "b1_twostage": dict(LW, topk_method="twostage", buckets=1),
    "flat_twostage": dict(compression="gtopk", topk_method="twostage"),
}


@pytest.fixture(scope="module")
def port_p4():
    leaves0, grads = _problem(4, seed=44)
    cases = {name: _port_kw(kw) for name, kw in {**P4_CASES,
                                                  **TWIN_CASES}.items()}
    got = spawn(programs.leaf_optimizer_cases, 4, leaves0, grads, cases,
                backend="gloo", device="cpu", timeout=300)
    return leaves0, grads, got


@pytest.mark.parametrize("name", P4_CASES)
def test_p4_matches_jax_on_every_rank(port_p4, name):
    leaves0, grads, got = port_p4
    kw = P4_CASES[name]
    want = _jax_run(leaves0, grads, 4, {**BASE, **kw})
    for r in range(4):
        _check(got[r][name], want, r, 4, kw, name)
        assert got[r][name][0]["plan"] == (kw.get("comm_plan")
                                           or ("hier" if "hier" in name
                                               else "tree"))


def test_one_bucket_is_bitwise_the_flat_step(port_p4):
    _, _, got = port_p4
    for r in range(4):
        for a, b in zip(got[r]["b1_twostage"], got[r]["flat_twostage"]):
            np.testing.assert_array_equal(a["params"], b["params"])
            np.testing.assert_array_equal(a["residual"], b["residual"])
            (gv, gi), = a["global"]
            np.testing.assert_array_equal(gi, b["global"][1])
            np.testing.assert_array_equal(gv, b["global"][0])


@pytest.mark.parametrize("method", ["twostage", "pallas", "exact"])
def test_one_bucket_is_bitwise_the_flat_step_at_p1(method):
    leaves0, grads = _problem(1, seed=5)
    runs = []
    for kw in (dict(LW, buckets=1), dict(compression="gtopk")):
        params = [torch.nn.Parameter(torch.from_numpy(x.copy()))
                  for x in leaves0]
        opt = GTopKSGD(params, **_port_kw(dict(kw, topk_method=method)))
        out = []
        for step_grads in grads:
            for prm, g in zip(params, step_grads):
                prm.grad = torch.from_numpy(g[0].copy())
            opt.step()
            out.append((torch.cat([x.detach().reshape(-1) for x in params]),
                        opt.state["residual"].clone(), opt.last_keep))
        runs.append(out)
    for (pa, ra, ka), (pb, rb, kb) in zip(*runs):
        assert torch.equal(pa, pb) and torch.equal(ra, rb)
        assert torch.equal(ka, kb)
