"""The port's remaining top-k methods against the JAX package's on the CPU,
same numpy inputs: ``blockwise`` bitwise (distinct magnitudes and ties at
a row's boundary); the threefry-2x32 / ``fold_in`` / ``uniform`` port
bitwise ``jax.random`` over many keys and sizes; ``simrecall`` bitwise on
inputs whose float32 sums are exact in any order (``exact_sum_input``);
``approx`` (the port's twostage path) at recall >= 0.95 against JAX's
``approx`` (an exact top-k on the CPU); each new method's ``select_tau``
equal to min(|vals|) of its ``select_topk``; the command line refusing an
unknown method when it parses; the ``auto`` policy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtopkssgd_tpu.dist_trainer import build_argparser as jax_parser
from gtopkssgd_tpu.ops import topk as jtopk
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.ops import cuda_topk, prng, topk


def _bits(a):
    return np.asarray(a).view(np.int32)


def distinct_magnitudes(n, seed):
    """n float32s of distinct magnitudes (distinct bit patterns in
    [1, 256)), random signs."""
    rng = np.random.default_rng(seed)
    mags = (rng.permutation(n).astype(np.int64) + 0x3F800000).astype(
        np.int32).view(np.float32)
    return mags * rng.choice(np.float32([-1, 1]), n)


def exact_sum_input(n, seed):
    """Distinct integer magnitudes times 2^-10 with random signs, at most
    4,096 of them (zeros elsewhere): sum and sum of magnitudes below
    2^24 units, so exact in float32 whatever the order."""
    rng = np.random.default_rng(seed)
    m = min(n, 4096)
    x = np.zeros(n, np.float32)
    pos = rng.choice(n, m, replace=False)
    x[pos] = ((rng.permutation(m) + 1) * rng.choice([-1, 1], m)).astype(
        np.float32) * np.float32(2.0 ** -10)
    return x


def _port(x, k, method, residual=None):
    r = None if residual is None else torch.from_numpy(residual)
    return topk.select_topk(torch.from_numpy(x), k, method, residual=r)


def _jax(x, k, method):
    return jtopk.select_topk(jnp.asarray(x), k, method)


# ------------------------------------------------------------ blockwise

@pytest.mark.parametrize("n,k", [(1000, 10), (65_536, 700),
                                 (200_000, 200), (262_149, 3000),
                                 (300_000, 70_000)])
def test_blockwise_bitwise_jax_on_distinct_magnitudes(n, k):
    x = distinct_magnitudes(n, n)
    vals, idx = _port(x, k, "blockwise")
    jv, ji = _jax(x, k, "blockwise")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(jv))
    ev, ei = topk.topk_abs(torch.from_numpy(x), k)
    assert torch.equal(ei, idx) and torch.equal(ev, vals)


@pytest.mark.parametrize("n,k", [(200_000, 300), (131_075, 50)])
def test_blockwise_ties_at_the_boundary(n, k):
    """Equal magnitudes straddle each row's k-th value, in every row:
    the lowest indices win in both stages, as in ``lax.top_k``."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(n) * 0.1).astype(np.float32)
    tie = rng.choice(n, 4 * k, replace=False)
    x[tie] = np.where(rng.random(4 * k) < 0.5, 2.5, -2.5).astype(np.float32)
    x[rng.choice(n, k // 2, replace=False)] = 7.0
    vals, idx = _port(x, k, "blockwise")
    jv, ji = _jax(x, k, "blockwise")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(jv))


# -------------------------------------------------------- threefry port

@pytest.mark.parametrize("seed", [0, 1, 0x51AEC, 2 ** 31 - 1, 123456789])
def test_prng_key_and_fold_in_bitwise_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.prng_key(seed)
    assert [int(t) for t in ours] == np.asarray(
        jax.random.key_data(key)).astype(np.int64).tolist()
    for data in (0, 1, 7, 2 ** 31 - 1, -1, -(2 ** 31), 987654321):
        want = jax.random.fold_in(key, jnp.int32(data).astype(jnp.uint32))
        got = prng.fold_in(ours, torch.tensor(data, dtype=torch.int32))
        assert [int(t) for t in got] == np.asarray(
            jax.random.key_data(want)).astype(np.int64).tolist()


@pytest.mark.parametrize("n", [1, 2, 3, 16, 1000, 65_537])
@pytest.mark.parametrize("data", [0, -5, 1_065_353_216])
def test_uniform_and_bits_bitwise_jax(n, data):
    key = jax.random.fold_in(jax.random.PRNGKey(0x51AEC),
                             jnp.int32(data).astype(jnp.uint32))
    ours = prng.fold_in(prng.prng_key(0x51AEC),
                        torch.tensor(data, dtype=torch.int32))
    np.testing.assert_array_equal(
        _bits(jax.random.uniform(key, (n,))),
        _bits(prng.uniform(ours, n).numpy()))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (n,))).astype(np.int64),
        prng.random_bits(ours, n).numpy())


def test_threefry_block_against_jax():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, (50, 4), dtype=np.uint64)
    for k0, k1, x0, x1 in words:
        want = np.asarray(threefry_2x32(
            jnp.asarray([k0, k1], jnp.uint32),
            jnp.asarray([x0, x1], jnp.uint32))).astype(np.int64)
        got = prng.threefry2x32(*(torch.tensor(int(v)) for v in
                                  (k0, k1, x0, x1)))
        assert [int(g) for g in got] == want.tolist()


# ------------------------------------------------------------ simrecall

@pytest.mark.parametrize("n,k", [(1000, 10), (5000, 100), (60_000, 60),
                                 (272_474, 273), (100_000, 5000)])
def test_simrecall_bitwise_jax_on_exact_sums(n, k):
    x = exact_sum_input(n, n + k)
    vals, idx = _port(x, k, "simrecall")
    jv, ji = _jax(x, k, "simrecall")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(jv))


def test_simrecall_on_other_inputs_drops_about_five_percent():
    """Off the exact-sum inputs the key may differ from JAX's in the sum's
    last bit; the drop set's size and the recall are what hold."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(500_000).astype(np.float32)
    k = 5000
    _, idx = _port(x, k, "simrecall")
    _, exact = topk.topk_abs(torch.from_numpy(x), k)
    _, jidx = _jax(x, k, "simrecall")
    recall = np.isin(idx.numpy(), exact.numpy()).mean()
    jrecall = np.isin(np.asarray(jidx), exact.numpy()).mean()
    assert 0.93 <= recall <= 0.97 and 0.93 <= jrecall <= 0.97
    assert len(set(idx.tolist())) == k


# --------------------------------------------------------------- approx

@pytest.mark.parametrize("n,k", [(272_474, 273), (1_000_000, 1000),
                                 (2_000_000, 2000)])
def test_approx_recall_against_jax(n, k):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    _, idx = _port(x, k, "approx")
    _, jidx = _jax(x, k, "approx")
    recall = np.isin(idx.numpy(), np.asarray(jidx)).mean()
    assert recall >= 0.95, recall
    _, two = _port(x, k, "twostage")
    assert torch.equal(idx, two)


def test_approx_is_the_twostage_path():
    """``approx`` runs the stage-1 path (the twin here, the kernel on the
    card) with the residual folded in, as ``twostage`` does."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(100_000).astype(np.float32)
    r = (0.3 * rng.standard_normal(100_000)).astype(np.float32)
    calls = []
    real = cuda_topk.fused_stage1_candidates

    def spy(*a, **kw):
        calls.append(kw.get("residual") is not None)
        return real(*a, **kw)

    cuda_topk.fused_stage1_candidates = spy
    try:
        a = _port(x, 100, "approx", residual=r)
        t = _port(x, 100, "twostage", residual=r)
    finally:
        cuda_topk.fused_stage1_candidates = real
    assert calls == [True, True]
    assert all(torch.equal(u, v) for u, v in zip(a, t))


# ------------------------------------------------------------ select_tau

@pytest.mark.parametrize("method", ["blockwise", "approx", "simrecall"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_select_tau_is_the_smallest_selected_magnitude(method,
                                                       with_residual):
    rng = np.random.default_rng(6)
    n, k = 150_000, 150
    x = rng.standard_normal(n).astype(np.float32)
    r = (0.5 * rng.standard_normal(n)).astype(np.float32) \
        if with_residual else None
    vals, _ = _port(x, k, method, residual=r)
    tau = topk.select_tau(torch.from_numpy(x), k, method,
                          residual=None if r is None else torch.from_numpy(r))
    assert float(tau) == float(vals.abs().min())
    if method == "blockwise":
        acc = x if r is None else x + r
        assert float(tau) == float(jtopk.select_tau(jnp.asarray(acc), k,
                                                    "blockwise"))


# ------------------------------------------------------ names and auto

def test_cli_takes_exactly_the_jax_methods():
    port = next(a for a in dist_trainer.build_argparser()._actions
                if "--topk-method" in a.option_strings)
    ref = next(a for a in jax_parser()._actions
               if "--topk-method" in a.option_strings)
    assert list(port.choices) == list(ref.choices) == list(topk.METHODS)


@pytest.mark.parametrize("bad", ["bogus", "Exact", "pallas2"])
def test_unknown_method_refused_at_parse_time(bad, capsys):
    with pytest.raises(SystemExit) as e:
        dist_trainer.build_argparser().parse_args(["--topk-method", bad])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown topk method"):
        topk.select_topk(torch.ones(10), 2, bad)


def test_auto_switches_to_twostage_above_the_h100_switch():
    assert topk._resolve_auto(topk.AUTO_SWITCH) == "exact"
    assert topk._resolve_auto(topk.AUTO_SWITCH + 1) == "twostage"
    assert topk._resolve_auto(272_474) == "exact"  # ResNet-20
    for n in (14_986_698, 25_557_032, 61_100_840):
        assert topk._resolve_auto(n) == "twostage"
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        1000).astype(np.float32))
    assert all(torch.equal(a, b) for a, b in zip(
        topk.select_topk(x, 10, "auto"), topk.select_topk(x, 10, "exact")))
