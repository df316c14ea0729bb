"""The port's compressor and optimizer against the JAX package's, on the
same numpy inputs.

Selection decisions (keep masks, index sets) and the residual of one
compression are bitwise: they are comparisons and copies of the same f32
values. Over optimizer steps the params and residual are held within 1e-6:
the SGD sums (g + wd*p, momentum*buf + g, p - lr*buf) may be fused into
FMAs differently by XLA and by PyTorch, an ulp per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gtopkssgd_tpu.compression import TopKCompressor as JaxTopK
from gtopkssgd_tpu.optimizer import gtopk_sgd
from gtopkssgd_tpu_torch.compression import (
    NoneCompressor,
    TopKCompressor,
    get_compressor,
)
from gtopkssgd_tpu_torch.ops import scatter_add_dense
from gtopkssgd_tpu_torch.ops import topk as ttopk
from gtopkssgd_tpu_torch.optimizer import FlatLayout, GTopKSGD

torch.set_num_threads(2)
SGD_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_registry():
    assert isinstance(get_compressor(None), NoneCompressor)
    assert isinstance(get_compressor("dense"), NoneCompressor)
    c = get_compressor("gtopk", density=0.01, method="pallas")
    assert isinstance(c, TopKCompressor) and c.method == "pallas"
    for mode in ("allgather", "topk", "topkA", "topk_allgather"):
        assert get_compressor(mode, density=0.01) == TopKCompressor(0.01)
    # As in the JAX registry: every sparse mode selects with top-k.
    for mode in ("gtopk_hier", "gtopk_layerwise"):
        assert get_compressor(mode, density=0.01) == TopKCompressor(0.01)
    with pytest.raises(ValueError):
        get_compressor("nope")


@pytest.mark.parametrize("method", ["exact", "threshold", "pallas",
                                    "twostage"])
def test_compress_by_threshold_bitwise(method, monkeypatch):
    rng = np.random.default_rng(1)
    n = 50_000
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    jc = JaxTopK(density=0.002, method=method)
    tc = TopKCompressor(density=0.002, method=method)
    if method == "twostage":
        # Off the TPU the JAX compressor runs the stride-L layout; the
        # kernel's tile layout is held to Pallas in test_torch_ops.py.
        orig = ttopk._twostage_candidates
        monkeypatch.setattr(ttopk, "_twostage_candidates", lambda *a, **kw:
                            orig(*a, **{**kw, "layout": "stride"}))
    acc_j = jnp.asarray(g) + jnp.asarray(r)
    jk, jres, jtau = jc.compress_by_threshold(
        acc_j, grad=jnp.asarray(g), residual=jnp.asarray(r))
    acc_t = tc.accumulate(_t(g), _t(r))
    tk, tres, ttau = tc.compress_by_threshold(
        acc_t, grad=_t(g), residual=_t(r))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(ttau.numpy(), np.asarray(jtau))
    assert int(tk.sum()) >= tc.k(n)
    # Mass conservation: kept + residual == acc, elementwise.
    kept = torch.where(tk, acc_t, torch.zeros_like(acc_t))
    assert torch.equal(kept + tres, acc_t)


def test_compress_by_threshold_tau_zero_keeps_only_nonzeros():
    acc = torch.zeros(100)
    acc[[3, 50]] = torch.tensor([1.0, -2.0])
    keep, res, kept_tau = TopKCompressor(density=0.1,
                                         method="exact").compress_by_threshold(
        acc)
    assert keep.nonzero().flatten().tolist() == [3, 50]
    assert float(kept_tau) == 1.0 and torch.all(res == 0)


@pytest.mark.parametrize("method", ["exact", "threshold", "pallas"])
def test_compress_and_repair_bitwise(method):
    rng = np.random.default_rng(2)
    n = 4096
    acc = rng.standard_normal(n).astype(np.float32)
    jc = JaxTopK(density=0.01, method=method)
    tc = TopKCompressor(density=0.01, method=method)
    jv, ji, jres = jc.compress(jnp.asarray(acc))
    tv, ti, tres = tc.compress(_t(acc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    sent = scatter_add_dense(n, ti, tv)
    assert torch.equal(sent + tres, _t(acc))  # mass conservation
    # A "global" set that keeps half the local picks plus foreign indices
    # and a padding slot: the rejected half goes back to the residual.
    gidx = np.concatenate([np.asarray(ji)[::2],
                           rng.choice(n, 10), [n]]).astype(np.int32)
    jrep = jc.repair(jres, jv, ji, jnp.asarray(gidx))
    trep = tc.repair(tres, tv, ti, _t(gidx))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    # Mass: the residual plus the delivered picks is acc again.
    survived = torch.isin(ti, _t(gidx))
    delivered = scatter_add_dense(n, ti[survived], tv[survived])
    assert torch.equal(trep + delivered, _t(acc))


@pytest.mark.parametrize("mode,method", [("dense", "exact"),
                                         ("gtopk", "exact"),
                                         ("gtopk", "threshold"),
                                         ("gtopk", "pallas")])
def test_optimizer_three_steps_match_jax(mode, method):
    rng = np.random.default_rng(5)
    n, lr, wd = 30_000, 0.1, 5e-4
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]

    tx = gtopk_sgd(lr, momentum=0.9, weight_decay=wd, compression=mode,
                   density=0.01, topk_method=method, axis_name=None)
    jparams = {"w": jnp.asarray(p0)}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)

    p = torch.nn.Parameter(_t(p0.copy()))
    opt = GTopKSGD([p], lr, momentum=0.9, weight_decay=wd,
                   compression=mode, density=0.01, topk_method=method)
    for g in grads:
        jres_in = np.asarray(jstate.residual)
        upd, jstate = update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        p.grad = _t(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams["w"]),
                                   rtol=0, atol=SGD_TOL)
        if mode == "dense":
            assert opt.last_keep is None
            continue
        jres = np.asarray(jstate.residual)
        tres = opt.state["residual"].numpy()
        np.testing.assert_allclose(tres, jres, rtol=0, atol=SGD_TOL)
        jkeep = (jres == 0) & ((g + jres_in) != 0)
        np.testing.assert_array_equal(opt.last_keep.numpy(), jkeep)
    assert opt.state["count"] == 3


def test_optimizer_state_dict_keeps_residual_and_schedule():
    p = torch.nn.Parameter(torch.randn(1000))
    opt = GTopKSGD([p], lambda count: 0.1 * 0.5 ** count,
                   compression="gtopk", density=0.01, topk_method="exact")
    p.grad = torch.randn(1000)
    opt.step()
    assert opt.param_groups[0]["lr"] == 0.1
    p.grad = torch.randn(1000)
    opt.step()
    assert opt.param_groups[0]["lr"] == 0.05
    sd = opt.state_dict()
    opt2 = GTopKSGD([p], 0.1, compression="gtopk", density=0.01)
    opt2.load_state_dict(sd)
    assert torch.equal(opt2.state["residual"], opt.state["residual"])
    assert opt2.state["count"] == 2


def test_flat_layout_permutes_and_round_trips():
    a = torch.arange(24.0).view(2, 3, 4)
    b = torch.arange(6.0).view(2, 3)
    lay = FlatLayout([(a, (2, 0, 1)), (b, (1, 0))])
    assert lay.n == 30 and lay.offsets == [0, 24]
    flat = lay.ravel([a, b])
    assert torch.equal(flat[:24], a.permute(2, 0, 1).reshape(-1))
    assert torch.equal(flat[24:], b.t().reshape(-1))
    out = [torch.empty_like(a), torch.empty_like(b)]
    lay.unravel_into(flat, out)
    assert torch.equal(out[0], a) and torch.equal(out[1], b)
    # Pricing the overlap order needs the selection's cost: the CPU has
    # no measured fit, so the optimizer names the probe.
    with pytest.raises(ValueError, match="select_probe"):
        GTopKSGD([torch.nn.Parameter(a)], 0.1, compression="gtopk_layerwise",
                 buckets=2, pipeline="overlap")
