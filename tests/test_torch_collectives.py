"""The port's gTop-k collective against the JAX package's, on the CPU.

``merge_sparse_sets`` and ``gtopk_allreduce`` are held BITWISE to the JAX
functions on the same numpy sets: a merge round is sorts, one float add per
duplicate pair and copies, and the port keeps the JAX tree's shape, its
sentinel sets and its tie order. The port's collective runs on spawned
gloo ranks (one 8-rank world; the first P ranks form a group for each P);
the JAX one under ``jax.shard_map`` on the 8-device CPU mesh.
``merge_tree_ref``, the port's single-process tree, must equal both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import test_torch_rank_programs as programs
from gtopkssgd_tpu.ops import merge_sparse_sets as jax_merge
from gtopkssgd_tpu.parallel import collectives as jcoll
from gtopkssgd_tpu.parallel import make_mesh
from gtopkssgd_tpu_torch.ops import merge_sparse_sets
from gtopkssgd_tpu_torch.parallel import bucketing, codec, collectives
from gtopkssgd_tpu_torch.parallel.dist import spawn

torch.set_num_threads(2)
PS = (2, 3, 5, 8)
K, N = 16, 200


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_set(rng, k=K, n=N, pad=2, pool=60):
    """A local set: k - pad unique indices from a small pool (sets of
    different ranks overlap), values from a few magnitudes (ties) and a
    random part, then `pad` sentinel slots (index n, value 0)."""
    idx = rng.choice(pool, size=k - pad, replace=False).astype(np.int32)
    vals = np.where(rng.random(k - pad) < 0.5,
                    rng.choice([-1.5, -0.5, 0.5, 1.0, 1.5], k - pad),
                    rng.standard_normal(k - pad)).astype(np.float32)
    return (np.concatenate([vals, np.zeros(pad, np.float32)]),
            np.concatenate([idx, np.full(pad, n, np.int32)]))


def make_sets(p, seed):
    rng = np.random.default_rng(seed)
    sets = [make_set(rng, pad=int(rng.integers(0, 4))) for _ in range(p)]
    return (np.stack([v for v, _ in sets]), np.stack([i for _, i in sets]))


MERGE_CASES = ("random", "duplicates", "ties", "padding", "k_below_union")


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_sparse_sets_bitwise(case):
    rng = np.random.default_rng(MERGE_CASES.index(case))
    k, n = K, N
    va, ia = make_set(rng)
    vb, ib = make_set(rng)
    if case == "duplicates":       # every index of b also in a
        ib[:k - 2] = rng.permutation(ia[:k - 2])
    elif case == "ties":           # equal magnitudes, opposite signs
        va[:k - 2] = np.float32(1.0)
        vb[:k - 2] = np.float32(-1.0)
    elif case == "padding":        # b is all sentinels
        vb[:], ib[:] = 0.0, n
    elif case == "k_below_union":
        k = 5
    jv, ji = jax_merge(jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb),
                       jnp.asarray(ib), k, n)
    tv, ti = merge_sparse_sets(_t(va), _t(ia), _t(vb), _t(ib), k, n)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    # Order-canonical: the partner's call gives the same bits.
    sv, si = merge_sparse_sets(_t(vb), _t(ib), _t(va), _t(ia), k, n)
    assert torch.equal(si, ti) and torch.equal(sv.view(torch.int32),
                                               tv.view(torch.int32))


def _jax_gtopk(vals, idxs, p):
    def body(v, i):
        gv, gi = jcoll.gtopk_allreduce(v[0], i[0], k=K, n=N, axis_name="dp",
                                       axis_size=p)
        return gv[None], gi[None]

    gv, gi = jax.jit(jax.shard_map(
        body, mesh=make_mesh(p), in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"))))(jnp.asarray(vals), jnp.asarray(idxs))
    return np.asarray(gv), np.asarray(gi)


@pytest.fixture(scope="module")
def port_tree():
    """The port's gtopk_allreduce at every P of PS, from one spawn of 8
    gloo ranks: {P: per-rank results}."""
    sets = {p: make_sets(p, seed=p) for p in PS}
    per_rank = spawn(programs.gtopk_over_groups, max(PS), sets, K, N,
                     backend="gloo", device="cpu", timeout=120)
    return sets, {p: [per_rank[r][p] for r in range(p)] for p in PS}


@pytest.mark.parametrize("p", PS)
def test_gtopk_allreduce_matches_jax_on_every_rank(port_tree, p):
    sets, results = port_tree[0], port_tree[1][p]
    vals, idxs = sets[p]
    jv, ji = _jax_gtopk(vals, idxs, p)
    ref = collectives.merge_tree_ref(
        [(_t(vals[r]), _t(idxs[r])) for r in range(p)], K, N)
    for r in range(p):
        got = results[r]
        np.testing.assert_array_equal(got["idx"], ji[r])
        np.testing.assert_array_equal(got["vals"].view(np.int32),
                                      jv[r].view(np.int32))
        np.testing.assert_array_equal(ref[r][1].numpy(), ji[r])
        np.testing.assert_array_equal(ref[r][0].numpy().view(np.int32),
                                      jv[r].view(np.int32))
        assert got["rounds"] == collectives.tree_rounds(p)
    # Every rank sends one 2k-word set in each round it sends in; at a
    # power of two that is every round, as comm_bytes_per_step models.
    sent = [results[r]["bytes"] for r in range(p)]
    assert all(b % (8 * K) == 0 for b in sent)
    if p & (p - 1) == 0:
        assert sent == [collectives.comm_bytes_per_step("gtopk", N, K, p)] * p


def test_merge_tree_ref_is_the_numpy_tree():
    """merge_tree_ref at a ragged P against the tree written out by hand:
    fold 4->0, hypercube over 0..3, 0 hands the set to 4."""
    vals, idxs = make_sets(5, seed=11)
    s = [(_t(vals[r]), _t(idxs[r])) for r in range(5)]
    sent = (torch.zeros(K), torch.full((K,), N, dtype=torch.int32))
    s = [merge_sparse_sets(*s[0], *s[4], K, N)] + [
        merge_sparse_sets(*s[r], *sent, K, N) for r in range(1, 5)]
    for bit in (1, 2):
        s = [merge_sparse_sets(*s[r], *s[r ^ bit], K, N) for r in range(4)] \
            + [merge_sparse_sets(*s[4], *sent, K, N)]
    want = s[:4] + [s[0]]
    ref = collectives.merge_tree_ref(
        [(_t(vals[r]), _t(idxs[r])) for r in range(5)], K, N)
    for r in range(5):
        assert torch.equal(ref[r][1], want[r][1])
        assert torch.equal(ref[r][0], want[r][0])


@pytest.mark.parametrize("p", range(1, 9))
def test_tree_rounds_and_comm_bytes_match_jax(p):
    n, k = 272_474, 273
    assert collectives.tree_rounds(p) == jcoll.tree_rounds(p)
    for mode in ("gtopk", "dense"):
        assert (collectives.comm_bytes_per_step(mode, n, k, p)
                == jcoll.comm_bytes_per_step(mode, n, k, p))


def test_later_modes_schedules_and_codecs_are_refused():
    """The hierarchical and layer-wise modes and the balanced schedule are
    in the port now (held to JAX in tests/test_torch_hier_balanced.py and
    tests/test_torch_planner.py), and the ``overlap`` and ``auto``
    pipelines too (tests/test_torch_pipeline.py); what stays refused is a
    schedule that does not realize the mode, an unknown mode, codec or
    pipeline spec. The allgather modes and the int8/fp8 codecs are
    accepted."""
    v, i = torch.zeros(K), torch.full((K,), N, dtype=torch.int32)
    for mode in ("gtopk_hier", "gtopk_layerwise"):
        for p in (2, 4, 8):
            assert (collectives.comm_bytes_per_step(mode, N, K, p)
                    == jcoll.comm_bytes_per_step(mode, N, K, p))
    assert (collectives.comm_bytes_per_step("gtopk", N, K, 4,
                                            schedule="balanced")
            == 7 * 8 * collectives.balanced_cap(K, 4, N))
    for pipeline in ("overlap", "auto"):
        assert bucketing.parse_pipeline(pipeline) == pipeline
    with pytest.raises(ValueError, match="invalid --pipeline"):
        bucketing.parse_pipeline("eager")
    with pytest.raises(ValueError, match="schedule"):
        collectives.sparse_allreduce("gtopk", v, i, k=K, n=N,
                                     plan="allgather")
    with pytest.raises(ValueError, match="schedule"):
        collectives.sparse_allreduce("gtopk_hier", v, i, k=K, n=N,
                                     plan="balanced")
    for spec in ("int8", "fp8", "fp8:32"):
        set_bytes = codec.get_codec(spec).wire_set_bytes(K, N)
        assert set_bytes < 8 * K
        for mode in ("allgather", "topk", "topkA", "topk_allgather"):
            assert collectives.comm_bytes_per_step(
                mode, N, K, 4, codec=spec) == 4 * set_bytes
        assert collectives.comm_bytes_per_step(
            "gtopk", N, K, 4, codec=spec) == 2 * set_bytes
    with pytest.raises(ValueError, match="unknown wire codec"):
        collectives.comm_bytes_per_step("gtopk", N, K, 4, codec="int4")
    with pytest.raises(ValueError, match="unknown"):
        collectives.sparse_allreduce("nope", v, i, k=K, n=N)