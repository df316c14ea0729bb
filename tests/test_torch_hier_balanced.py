"""The port's hierarchical and balanced exchanges against the JAX
package's, on the CPU.

``ici_dense_psum``, ``hier_gtopk_allreduce`` and
``balanced_gtopk_allreduce`` are held BITWISE to the JAX functions on the
same numpy inputs, on every rank: the in-slice sum adds the same operands
in the same association (recursive doubling, one f32 add a round), and
the tree and the balanced schedule are sorts, one float add per
duplicate, copies and codec round trips. The port runs on spawned gloo
ranks (one 8-rank world for the file, a group of the first P ranks for
each case), JAX under ``jax.shard_map`` on the 8-device CPU mesh.
``balanced_ref``, the port's single-process schedule, must equal both.
The wire counters must equal ``comm_bytes_per_step``, but for the
in-slice sum, which counts the buffers each rank ships.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import test_torch_rank_programs as programs
from gtopkssgd_tpu.parallel import collectives as jcoll
from gtopkssgd_tpu.parallel import make_mesh
from gtopkssgd_tpu_torch.parallel import codec as tcodec
from gtopkssgd_tpu_torch.parallel import collectives
from gtopkssgd_tpu_torch.parallel.dist import spawn

torch.set_num_threads(2)
# n = 203 leaves a short last owner range at every P below (n < chunk*p),
# so the sentinel n aliases into the last owner's slot arithmetic.
K, N, M = 16, 203, 64
PSUM_CASES = ((4, 2), (4, 4), (6, 2), (6, 3), (8, 2), (8, 4))
HIER_CASES = tuple((p, ici, "fp32") for p, ici in PSUM_CASES) + (
    (8, 2, "int8"), (6, 3, "int8"), (4, 2, "fp8:32"), (6, 2, "fp8:32"))
# Buffers each slice offset ships in the in-slice sum: one a doubling
# round in the power-of-two block, plus the fold (extras) or the unfold
# (the offsets the extras folded into).
PSUM_SENDS = {2: (1, 1), 3: (2, 1, 1), 4: (2, 2, 2, 2)}
BALANCED_CASES = tuple((p, c) for p in (2, 3, 4, 5, 8)
                       for c in ("fp32", "int8", "fp8:32"))


def make_set(rng, pad):
    """k - pad unique indices over the whole range (every owner gets
    some), values with repeated magnitudes (ties) and a random part, then
    `pad` sentinel slots."""
    idx = rng.choice(N, size=K - pad, replace=False).astype(np.int32)
    vals = np.where(rng.random(K - pad) < 0.4,
                    rng.choice([-1.5, -0.5, 0.5, 1.5], K - pad),
                    rng.standard_normal(K - pad)).astype(np.float32)
    return (np.concatenate([vals, np.zeros(pad, np.float32)]),
            np.concatenate([idx, np.full(pad, N, np.int32)]))


def sets_for(p, seed, slice_width=1):
    """(vals f32[P, K], idx i32[P, K]); the ranks of each slice of
    `slice_width` hold the same set, as after the in-slice sum."""
    rng = np.random.default_rng(seed)
    per = [make_set(rng, pad=int(rng.integers(0, 4)))
           for _ in range(p // slice_width)]
    rows = [per[r // slice_width] for r in range(p)]
    return (np.stack([v for v, _ in rows]), np.stack([i for _, i in rows]))


@pytest.fixture(scope="module")
def port():
    psum = {(p, ici): np.random.default_rng(p * 10 + ici).standard_normal(
        (p, M)).astype(np.float32) for p, ici in PSUM_CASES}
    hier = {(p, ici, c): sets_for(p, 100 + 10 * p + ici, ici)
            for p, ici, c in HIER_CASES}
    balanced = {(p, c): sets_for(p, 200 + p) for p, c in BALANCED_CASES}
    per_rank = spawn(programs.hier_and_balanced_over_groups, 8, psum, hier,
                     balanced, K, N, backend="gloo", device="cpu",
                     timeout=180)
    return {"psum": psum, "hier": hier, "balanced": balanced,
            "ranks": per_rank}


def _run_jax(fn, p, *arrays):
    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return tuple(o[None] for o in out)

    outs = jax.jit(jax.shard_map(
        body, mesh=make_mesh(p), in_specs=tuple(P("dp") for _ in arrays),
        out_specs=P("dp"), check_vma=False))(*map(jnp.asarray, arrays))
    return [np.asarray(o) for o in outs]


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("p,ici", PSUM_CASES)
def test_ici_dense_psum_is_bitwise_jax_on_every_rank(port, p, ici):
    x = port["psum"][(p, ici)]
    (want,) = _run_jax(lambda v: (jcoll.ici_dense_psum(
        v, axis_name="dp", axis_size=p, ici_size=ici),), p, x)
    for r in range(p):
        got = port["ranks"][r][("psum", p, ici)]
        np.testing.assert_array_equal(_bits(got["sum"]), _bits(want[r]),
                                      err_msg=f"rank {r}")
        # Every member of a slice holds the same bits.
        first = port["ranks"][r - r % ici][("psum", p, ici)]["sum"]
        np.testing.assert_array_equal(_bits(got["sum"]), _bits(first))
        # What the rank ships: a fold, an unfold, a doubling round each.
        sends = PSUM_SENDS[ici][r % ici]
        assert collectives.ici_psum_sends(r % ici, ici) == sends
        assert got["bytes"] == sends * 4 * M and got["rounds"] == 0


@pytest.mark.parametrize("p,ici,codec", HIER_CASES)
def test_hier_gtopk_allreduce_is_bitwise_jax_on_every_rank(port, p, ici,
                                                           codec):
    vals, idxs = port["hier"][(p, ici, codec)]
    wv, wi = _run_jax(lambda v, i: jcoll.hier_gtopk_allreduce(
        v, i, k=K, n=N, axis_name="dp", axis_size=p, ici_size=ici,
        codec=codec), p, vals, idxs)
    n_slices = p // ici
    set_bytes = tcodec.get_codec(codec).wire_set_bytes(K, N)
    for r in range(p):
        got = port["ranks"][r][("hier", p, ici, codec)]
        np.testing.assert_array_equal(got["idx"], wi[r], err_msg=f"r{r}")
        np.testing.assert_array_equal(_bits(got["vals"]), _bits(wv[r]))
        np.testing.assert_array_equal(got["idx"], wi[0])
        assert got["rounds"] == collectives.tree_rounds(n_slices)
        if n_slices & (n_slices - 1) == 0:
            # The model counts the in-slice 4N apart; the tree alone here.
            assert got["bytes"] == (collectives.comm_bytes_per_step(
                "gtopk_hier", N, K, p, ici_size=ici, codec=codec) - 4 * N)
        else:
            assert got["bytes"] % set_bytes == 0


@pytest.mark.parametrize("p,codec", BALANCED_CASES)
def test_balanced_gtopk_allreduce_is_bitwise_jax_on_every_rank(port, p,
                                                               codec):
    vals, idxs = port["balanced"][(p, codec)]
    assert N < -(-N // p) * p
    wv, wi = _run_jax(lambda v, i: jcoll.balanced_gtopk_allreduce(
        v, i, k=K, n=N, axis_name="dp", axis_size=p, codec=codec),
        p, vals, idxs)
    ref = collectives.balanced_ref(
        [(torch.from_numpy(vals[r]), torch.from_numpy(idxs[r]))
         for r in range(p)], K, N, codec=codec)
    model = collectives.comm_bytes_per_step("gtopk", N, K, p, codec=codec,
                                            schedule="balanced")
    assert model == jcoll.comm_bytes_per_step("gtopk", N, K, p, codec=codec,
                                              schedule="balanced")
    for r in range(p):
        got = port["ranks"][r][("balanced", p, codec)]
        np.testing.assert_array_equal(got["idx"], wi[r], err_msg=f"r{r}")
        np.testing.assert_array_equal(_bits(got["vals"]), _bits(wv[r]))
        np.testing.assert_array_equal(ref[r][1].numpy(), wi[r])
        np.testing.assert_array_equal(_bits(ref[r][0].numpy()), _bits(wv[r]))
        assert got["rounds"] == p
        assert got["bytes"] == model  # (2p - 1) cap-sets, at every P


def test_balanced_cap_matches_jax():
    for k in (1, 7, 16, 273, 25_558):
        for p in range(1, 9):
            for n in (k, 2 * k + 1, 1000 * k):
                assert (collectives.balanced_cap(k, p, n)
                        == jcoll.balanced_cap(k, p, n))
