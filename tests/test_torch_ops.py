"""The port's top-k ops against the JAX package's, on the same numpy inputs.

The kernels' plain twins (what the port's wrappers run on CPU tensors) are
held BITWISE to the Pallas kernels run in interpret mode, as
tests/test_pallas_topk.py runs them; the selection functions are held
bitwise to the JAX ones. Integer counts and index sets are exact by
construction, and the values are copies of input elements or single f32
adds, so no tolerance applies anywhere in this file.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gtopkssgd_tpu.ops import pallas_topk as jpk
from gtopkssgd_tpu.ops import topk as jtopk
from gtopkssgd_tpu_torch.ops import kernel_cases
from gtopkssgd_tpu_torch.ops import cuda_topk, topk

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _thresholds(mag, rng):
    """8 thresholds spread over the magnitudes, two equal to data values
    (the >= boundary), all > 0."""
    q = np.quantile(mag, [0.05, 0.3, 0.5, 0.7, 0.9, 0.99])
    return np.concatenate([q, rng.choice(mag[mag > 0], 2)]).astype(np.float32)


@pytest.mark.parametrize("n", [1000, 262_144, 262_145])
def test_multi_threshold_count_twin_bitwise(n):
    rng = np.random.default_rng(n)
    mag = np.abs(rng.standard_normal(n)).astype(np.float32)
    thr = _thresholds(mag, rng)
    want = jpk.multi_threshold_count(jnp.asarray(mag), jnp.asarray(thr),
                                     interpret=True)
    got = cuda_topk.multi_threshold_count(_t(mag), _t(thr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,with_residual",
                         [(1000, True), (262_145, True), (262_145, False)])
def test_fused_multi_threshold_count_twin_bitwise(n, with_residual):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.5 * rng.standard_normal(n)).astype(np.float32)
    thr = _thresholds(np.abs(g + r), rng)
    res_j = jnp.asarray(r) if with_residual else None
    res_t = _t(r) if with_residual else None
    want = jpk.fused_multi_threshold_count(
        jnp.asarray(g), jnp.asarray(thr), res_j, interpret=True)
    got = cuda_topk.fused_multi_threshold_count(_t(g), _t(thr), res_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Every residual/thresholds combination at the block edge, then the small
# and just-past-the-edge sizes with both operands, then the extreme
# groups: one bucket of 2048 rows a lane, and buckets of one row.
_STAGE1_CASES = (
    [(262_144, 8, res, cnt) for res in (False, True) for cnt in (False, True)]
    + [(n, g, True, True) for n in (1000, 262_145) for g in (8, 64)]
    + [(262_144, 64, True, False)]
    + [(n, g, True, cnt) for n in (1000, 262_145) for g in (1, 2048)
       for cnt in (False, True)]
)


@pytest.mark.parametrize("n,groups,with_residual,with_counts", _STAGE1_CASES)
def test_fused_stage1_candidates_twin_bitwise(n, groups, with_residual,
                                              with_counts):
    rng = np.random.default_rng(n + groups)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.5 * rng.standard_normal(n)).astype(np.float32)
    thr = _thresholds(np.abs(g + r), rng)
    jv, ji, jc = jpk.fused_stage1_candidates(
        jnp.asarray(g),
        jnp.asarray(thr) if with_counts else None,
        jnp.asarray(r) if with_residual else None,
        groups=groups, interpret=True)
    tv, ti, tc = cuda_topk.fused_stage1_candidates(
        _t(g), _t(thr) if with_counts else None,
        _t(r) if with_residual else None, groups=groups)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if with_counts:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        assert tc is None and jc is None


@pytest.mark.parametrize("groups", [1, 8, 64, 2048])
def test_fused_stage1_candidates_ties_twin_bitwise(groups):
    """Repeated magnitudes of both signs in every bucket, and equal maxima
    of opposite signs at rows 0 and rpg - 1 and at rpg/2 - 1 and rpg/2:
    the first row's signed value must win, as in the Pallas kernel."""
    g, r = kernel_cases.tie_input(272_474, groups)
    thr = _thresholds(np.abs(g + r), np.random.default_rng(groups))
    jv, ji, jc = jpk.fused_stage1_candidates(
        jnp.asarray(g), jnp.asarray(thr), jnp.asarray(r), groups=groups,
        interpret=True)
    tv, ti, tc = cuda_topk.fused_stage1_candidates(
        _t(g), _t(thr), _t(r), groups=groups)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_wrappers_take_the_twin_for_cpu_tensors():
    cuda_topk.reset_launches()
    x = torch.randn(3000)
    thr = torch.linspace(0.1, 2.0, 8)
    cuda_topk.multi_threshold_count(x.abs(), thr)
    cuda_topk.fused_multi_threshold_count(x, thr, x)
    cuda_topk.fused_stage1_candidates(x, thr, x, groups=8)
    cuda_topk.threshold_apply(x, x, thr[3], True)
    assert set(cuda_topk.launches.values()) == {0}
    with pytest.raises(ValueError, match="must divide"):
        cuda_topk.fused_stage1_candidates(x, groups=3)


def _apply_before(src, res_in, tau):
    """The P = 1 step after tau as the optimizer computed it before the
    one-pass apply: ``accumulate``, ``compress_by_threshold``'s masks and
    kept tau, then ``acc - residual``."""
    acc = src if res_in is None else src + res_in
    mag = acc.abs()
    keep = (mag >= tau) & (mag > 0.0)
    kept_tau = torch.where(keep, mag, torch.inf).min()
    kept_tau = torch.where(torch.isfinite(kept_tau), kept_tau,
                           torch.zeros_like(kept_tau))
    residual = torch.where(keep, torch.zeros_like(acc), acc)
    return keep, residual, acc - residual, kept_tau, acc


def _case_id(label: str) -> str:
    return re.sub(r"[^0-9A-Za-z=-]+", "_", label)


@pytest.mark.parametrize("case", kernel_cases.APPLY_CASES, ids=_case_id)
def test_threshold_apply_twin_bitwise(case):
    """The threshold apply's twin (what ``threshold_apply`` runs on CPU
    tensors, and what the kernel is held to on the card) bitwise, NaNs as
    bits, against the expressions it replaced, with and without acc."""
    src, res_in, tau = next(c[1:] for c in kernel_cases.apply_cases("cpu")
                            if c[0] == case)
    want = _apply_before(src, res_in, tau)
    for want_acc in (True, False):
        got = cuda_topk.threshold_apply(src, res_in, tau, want_acc)
        for name, a, b in zip(("keep", "residual", "update", "kept_tau"),
                              got, want):
            assert kernel_cases.same_bits(a, b), (case, name)
        assert (got[4] is None) != want_acc
        if want_acc:
            assert kernel_cases.same_bits(got[4], want[4])
    # The partition: a kept entry moves whole into the update.
    keep, residual, update, kept_tau, _ = got
    assert torch.equal(update[keep], want[4][keep])
    assert bool((residual[keep] == 0).all())
    assert float(kept_tau) >= 0.0


@pytest.mark.parametrize("n,k", [(5000, 50), (300_000, 300)])
def test_stride_layout_twin_matches_xla_candidates(n, k):
    rng = np.random.default_rng(k)
    g = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    jv, ji = jtopk._twostage_candidates(
        jnp.asarray(g), k, residual=jnp.asarray(r), use_pallas=False)
    tv, ti = topk._twostage_candidates(_t(g), k, residual=_t(r),
                                       layout="stride")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _jax_tau(method, g, r, k):
    if method == "twostage":
        n = g.shape[0]
        groups = jtopk._twostage_pallas_groups(
            n, k, jtopk.TWOSTAGE_OVERSAMPLE)
        cv, _, _ = jpk.fused_stage1_candidates(
            jnp.asarray(g), residual=jnp.asarray(r), groups=groups,
            interpret=True)
        return lax.top_k(jnp.abs(cv), k)[0][k - 1]
    return jax.jit(lambda a, b: jtopk.select_tau(
        a, k, method, residual=b))(jnp.asarray(g), jnp.asarray(r))


@pytest.mark.parametrize("method", ["exact", "threshold", "pallas",
                                    "twostage"])
@pytest.mark.parametrize("n,k", [(20_000, 20), (272_474, 273)])
def test_select_tau_bitwise(method, n, k):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    want = _jax_tau(method, g, r, k)
    got = topk.select_tau(_t(g), k, method, residual=_t(r))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _inputs(kind, n, rng):
    if kind == "random":
        return rng.standard_normal(n).astype(np.float32)
    # Tie-heavy: a handful of magnitudes, both signs, many zeros.
    levels = np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    return (rng.choice(levels, n) * rng.choice([-1, 1], n)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n,k", [(1000, 10), (65_536, 64), (100_000, 1000)])
def test_topk_abs_and_threshold_topk_abs_bitwise(kind, n, k):
    rng = np.random.default_rng(n + k)
    x = _inputs(kind, n, rng)
    for jfn, tfn in ((jtopk.topk_abs, topk.topk_abs),
                     (jtopk.threshold_topk_abs, topk.threshold_topk_abs)):
        jv, ji = jax.jit(lambda a: jfn(a, k))(jnp.asarray(x))
        tv, ti = tfn(_t(x), k)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("method", ["exact", "threshold", "pallas"])
def test_select_topk_bitwise(method):
    rng = np.random.default_rng(7)
    n, k = 40_000, 40
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    jv, ji = jtopk.select_topk(jnp.asarray(g), k, method,
                               residual=jnp.asarray(r))
    tv, ti = topk.select_topk(_t(g), k, method, residual=_t(r))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("layout", ["tile", "stride"])
def test_twostage_topk_abs_bitwise(layout):
    rng = np.random.default_rng(11)
    n, k = 270_000, 270
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.3 * rng.standard_normal(n)).astype(np.float32)
    tile = layout == "tile"
    jv, ji = jtopk.twostage_topk_abs(
        jnp.asarray(g), k, residual=jnp.asarray(r), use_pallas=tile,
        interpret=True if tile else None)
    tv, ti = topk.twostage_topk_abs(_t(g), k, residual=_t(r), layout=layout)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_twostage_groups_and_k_for_density_match():
    for n, k in [(272_474, 273), (25_557_032, 25_558), (1000, 900),
                 (262_145, 2622)]:
        assert topk._twostage_pallas_groups(n, k) == \
            jtopk._twostage_pallas_groups(n, k, jtopk.TWOSTAGE_OVERSAMPLE)
    for n, d in [(272_474, 0.001), (272_474, 0.01), (7, 0.5), (10, 1e-9)]:
        assert topk.k_for_density(n, d) == jtopk.k_for_density(n, d)


def test_bucketize_scatter_membership_bitwise():
    rng = np.random.default_rng(3)
    mag = np.abs(rng.standard_normal(10_000)).astype(np.float32)
    thr = rng.permutation(_thresholds(mag, rng))
    np.testing.assert_array_equal(
        topk.bucketize_counts(_t(mag), _t(thr)).numpy(),
        np.asarray(jtopk.bucketize_counts(jnp.asarray(mag),
                                          jnp.asarray(thr))))
    n = 500
    idx = np.concatenate([rng.choice(n, 40, replace=False),
                          [n, n]]).astype(np.int32)
    vals = rng.standard_normal(42).astype(np.float32)
    np.testing.assert_array_equal(
        topk.scatter_add_dense(n, _t(idx), _t(vals)).numpy(),
        np.asarray(jtopk.scatter_add_dense(n, jnp.asarray(idx),
                                           jnp.asarray(vals))))
    query = rng.choice(n + 1, 60).astype(np.int32)
    np.testing.assert_array_equal(
        topk.membership_mask(_t(query), _t(idx)).numpy(),
        np.asarray(jtopk.membership_mask(jnp.asarray(query),
                                         jnp.asarray(idx))))


def test_unported_method_is_refused():
    """A name outside the JAX CLI's eight is refused; since the port has
    all eight (``approx`` among them), each of those selects."""
    x = torch.randn(100)
    for fn in (topk.select_tau, topk.select_topk):
        with pytest.raises(ValueError, match="unknown topk method"):
            fn(x, 5, "approx_max_k")
        for method in topk.METHODS:
            fn(x, 5, method)


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """On a CUDA card: each kernel bitwise equal to its twin (the CPU
    suite holds the twins to the Pallas kernels); the stage-1 kernel also
    on every edge case of ``kernel_cases.edge_cases``, with and without
    the residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    rng = np.random.default_rng(0)
    for n in (1000, 262_145, 272_474):
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        r = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        thr = torch.from_numpy(_thresholds(np.abs((g + r).numpy()), rng))
        gc, rc, tc = g.cuda(), r.cuda(), thr.cuda()
        assert torch.equal(
            cuda_topk.multi_threshold_count((gc + rc).abs(), tc).cpu(),
            cuda_topk.multi_threshold_count_ref((g + r).abs(), thr))
        assert torch.equal(
            cuda_topk.fused_multi_threshold_count(gc, tc, rc).cpu(),
            cuda_topk.fused_multi_threshold_count_ref(g, thr, r))
        for groups in (8, 64):
            got = cuda_topk.fused_stage1_candidates(gc, tc, rc,
                                                    groups=groups)
            want = cuda_topk.fused_stage1_candidates_ref(g, thr, r,
                                                         groups=groups)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
    for label, g, r, groups in kernel_cases.edge_cases("cuda"):
        for res in (r, None):
            bad = kernel_cases.stage1_mismatch(g, res, groups)
            assert bad is None, f"{label} groups={groups}: {bad}"
