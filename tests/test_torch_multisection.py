"""The multisection bracket of the `pallas` method against the JAX loop.

`cuda_topk.multisection_tau_lo` runs the 4 rounds of 8-way multisection in
one cooperative launch on the card; on the CPU it takes its twin,
`multisection_tau_lo_ref`, which is the port's one copy of the loop. Here
the twin's thresholds f32[4, 8], counts i32[4, 8] and lo are held BITWISE
to what the JAX package's `_threshold_tau` computes round by round, with
its counts from the Pallas kernels in interpret mode. The thresholds come
from the same float32 operations in the same order, and the counts are
integers, so no tolerance applies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtopkssgd_tpu.ops import pallas_topk as jpk
from gtopkssgd_tpu.ops import topk as jtopk
from gtopkssgd_tpu_torch.ops import cuda_topk

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(kind, n, rng):
    """x and a residual; `ties` gives a handful of magnitudes, both signs
    and many zeros (test_torch_ops.py's tie-heavy pattern)."""
    if kind == "random":
        x = rng.standard_normal(n).astype(np.float32)
    else:
        levels = np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
        x = (rng.choice(levels, n) * rng.choice([-1, 1], n)).astype(
            np.float32)
    return x, (0.3 * rng.standard_normal(n)).astype(np.float32)


def _jax_rounds(x, r, k):
    """Each round's thresholds and counts of the JAX loop, recorded by the
    count function that `_threshold_tau` calls once a round."""

    def fn(xj, rj):
        rec = []

        def count_fn(mag, thr):
            if rj is None:
                c = jpk.multi_threshold_count(mag, thr, interpret=True)
            else:
                c = jpk.fused_multi_threshold_count(xj, thr, rj,
                                                    interpret=True)
            rec.append((thr, c))
            return c

        acc = xj if rj is None else xj + rj
        jtopk._threshold_tau(acc, k, count_fn=count_fn)
        return (jnp.stack([t for t, _ in rec]),
                jnp.stack([c for _, c in rec]))

    if r is None:
        thr, counts = jax.jit(lambda a: fn(a, None))(jnp.asarray(x))
    else:
        thr, counts = jax.jit(fn)(jnp.asarray(x), jnp.asarray(r))
    thr, counts = np.asarray(thr), np.asarray(counts)
    # lo only ever rises, to the largest threshold that kept >= k.
    lo = np.float32(max(0.0, np.where(counts >= k, thr, 0.0).max()))
    return lo, thr, counts


_CASES = ([("random", n, k, res)
           for n, k in [(1000, 10), (20_000, 20), (272_474, 273)]
           for res in (True, False)]
          + [("ties", 20_000, 200, True), ("ties", 20_000, 200, False)])


@pytest.mark.parametrize("kind,n,k,with_residual", _CASES)
def test_twin_rounds_bitwise_to_jax(kind, n, k, with_residual):
    rng = np.random.default_rng(n + k)
    x, r = _inputs(kind, n, rng)
    if not with_residual:
        r = None
    want_lo, want_thr, want_counts = _jax_rounds(x, r, k)
    lo, thr, counts = cuda_topk.multisection_tau_lo_ref(
        _t(x), k, None if r is None else _t(r))
    assert thr.dtype == torch.float32 and thr.shape == (4, 8)
    assert counts.dtype == torch.int32 and counts.shape == (4, 8)
    assert lo.dtype == torch.float32 and lo.shape == ()
    np.testing.assert_array_equal(thr.numpy(), want_thr)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    mag = np.abs(x if r is None else x + r)
    assert int((mag >= lo.numpy()).sum()) >= k  # the bracket's invariant


def test_wrapper_takes_the_twin_for_cpu_tensors():
    rng = np.random.default_rng(5)
    x, r = (_t(a) for a in _inputs("random", 5000, rng))
    cuda_topk.reset_launches()
    for res in (None, r):
        got = cuda_topk.multisection_tau_lo(x, 5, res)
        want = cuda_topk.multisection_tau_lo_ref(x, 5, res)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert set(cuda_topk.launches.values()) == {0}


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    """On a CUDA card: lo, the thresholds and the counts bitwise equal to
    the twin's on the card, in both modes, with 16-byte and with unaligned
    loads, and the same again from a second call on the same stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    rng = np.random.default_rng(1)
    for kind, n, k in [("random", 1000, 10), ("random", 272_474, 273),
                       ("ties", 20_000, 200)]:
        x, r = (_t(a).cuda() for a in _inputs(kind, n + 1, rng))
        for xs, rs in ((x[:n], r[:n]), (x[1:], r[1:])):  # aligned, not
            for res in (None, rs):
                want = cuda_topk.multisection_tau_lo_ref(xs, k, res)
                first = cuda_topk.multisection_tau_lo(xs, k, res)
                again = cuda_topk.multisection_tau_lo(xs, k, res)
                for a, b, c in zip(first, again, want):
                    assert torch.equal(a, c) and torch.equal(b, c)
