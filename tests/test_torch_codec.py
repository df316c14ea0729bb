"""The port's wire codecs, codec tree and Top-k allgather against the JAX
package's, on the CPU.

The codec is integer and bit arithmetic plus three roundings (the bf16
block scale, int8's round half to even, fp8's cast), so everything is
held BITWISE: the wire words (JAX's uint32 buffer viewed as int32), the
decoded (vals, idx), ``roundtrip_aligned``, ``wire_set_bytes`` and
``bit_budget``. The collectives run on spawned gloo ranks (one 8-rank
world for the file; the first P ranks form a group for each case), the
JAX ones under ``jax.shard_map`` on the 8-device CPU mesh; the merge and
the rank-order union add the same f32 values in the same order, so they
too are bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_rank_programs as programs
from gtopkssgd_tpu.compression import TopKCompressor as JaxTopK
from gtopkssgd_tpu.parallel import codec as jcodec
from gtopkssgd_tpu.parallel import collectives as jcoll
from gtopkssgd_tpu.parallel import make_mesh
from gtopkssgd_tpu_torch.compression import TopKCompressor
from gtopkssgd_tpu_torch.modes import ALL_MODES
from gtopkssgd_tpu_torch.parallel import codec, collectives
from gtopkssgd_tpu_torch.parallel.dist import spawn

torch.set_num_threads(2)
CODECS = ("int8", "int8:4", "fp8", "fp8:32")
TREE_PS = (2, 3, 5, 8)
GATHER_PS = (2, 3, 4)
K, N = 24, 400


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_set(rng, k, n, pad):
    """k - pad unique indices of [0, n) with values that tie in magnitude
    (equal and opposite) and random ones, then `pad` sentinel slots."""
    m = k - pad
    idx = rng.choice(n, size=m, replace=False).astype(np.int32)
    vals = np.where(rng.random(m) < 0.3,
                    rng.choice([-1.5, -0.5, 0.5, 1.5], m),
                    3 * rng.standard_normal(m)).astype(np.float32)
    return (np.concatenate([vals, np.zeros(pad, np.float32)]),
            np.concatenate([idx, np.full(pad, n, np.int32)]))


def midpoint_set(spec):
    """Values that sit on the quantizer's rounding midpoints and one f32
    ulp either side: int8's j + 0.5, fp8's midpoints between consecutive
    e4m3fn values, both signs, times a power-of-two scale. Blocks of 4
    (index order) each lead with qmax * scale, so every block's bf16 scale
    is exactly that power of two."""
    s = np.float32(2.0 ** -4)
    if spec.startswith("int8"):
        mids = np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)
        qmax = 127.0
    else:
        grid = np.arange(0x7F, dtype=np.uint8).view(
            jnp.float8_e4m3fn).astype(np.float32)
        pos = (grid[:-1] + grid[1:]) / 2
        mids = np.concatenate([pos, -pos])
        qmax = 448.0
    v = mids * s
    vals = np.concatenate([v, np.nextafter(v, np.inf, dtype=np.float32),
                           np.nextafter(v, -np.inf, dtype=np.float32)])
    vals = vals.reshape(-1, 3)
    lead = np.full((vals.shape[0], 1), np.float32(qmax) * s, np.float32)
    vals = np.concatenate([lead, vals], axis=1).reshape(-1)
    return vals.astype(np.float32), np.arange(vals.size, dtype=np.int32)


def scale_midpoint_set(spec, nblocks=48):
    """Block maxima qmax * m with m a bf16 rounding midpoint: the block
    scale amax / qmax is a tie of the bf16 rounding (an IEEE quotient
    lands on it exactly). Other values of a block: the maximum times
    (-1, 1)."""
    jc = jcodec.get_codec(spec)
    rng = np.random.default_rng(9)
    b = np.exp2(rng.uniform(-10, -2, nblocks)).astype(jnp.bfloat16)
    nxt = (b.view(np.uint16) + 1).view(jnp.bfloat16)
    mid = (b.astype(np.float32) + nxt.astype(np.float32)) / 2
    amax = mid * np.float32(jc.qmax)
    rest = rng.uniform(-1, 1, (nblocks, jc.block - 1)).astype(np.float32)
    vals = np.concatenate([amax[:, None], amax[:, None] * rest], axis=1)
    vals = vals.reshape(-1).astype(np.float32)
    return vals, np.arange(vals.size, dtype=np.int32)


def _grid():
    cases = []
    for spec in CODECS:
        for k in (1, 5, 273):
            for n in sorted({k, 1000, 272_474}):
                for pad in range(min(3, k)):
                    cases.append((spec, k, n, pad))
    return cases


def _assert_codec_matches_jax(spec, vals, idx, n):
    """Held to the JAX codec under ``jax.jit``, as training runs it: XLA
    compiles the block scale amax / qmax as amax * (1 / qmax), which
    eager JAX does not (it divides)."""
    k = vals.shape[0]
    jc, tc = jcodec.get_codec(spec), codec.get_codec(spec)
    jv_in, ji_in = jnp.asarray(vals), jnp.asarray(idx)
    (jwire,) = jax.jit(functools.partial(jc.encode, n=n))(jv_in, ji_in)
    twire = tc.encode(_t(vals), _t(idx), n=n)
    assert twire.dtype == torch.int32
    np.testing.assert_array_equal(twire.numpy(),
                                  np.asarray(jwire).view(np.int32))
    assert tc.wire_set_bytes(k, n) == jc.wire_set_bytes(k, n) \
        == 4 * twire.numel()
    assert tc.bit_budget(k, n) == jc.bit_budget(k, n)
    jv, ji = jax.jit(functools.partial(jc.decode, k=k, n=n))((jwire,))
    tv, ti = tc.decode(twire, k=k, n=n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    # Indices are lossless: the decoded set is the input sorted by index.
    np.testing.assert_array_equal(ti.numpy(), np.sort(idx))
    jr = jax.jit(functools.partial(jcodec.roundtrip_aligned, jc, n=n))(
        jv_in, ji_in)
    tr = codec.roundtrip_aligned(tc, _t(vals), _t(idx), n=n)
    np.testing.assert_array_equal(tr.numpy().view(np.int32),
                                  np.asarray(jr).view(np.int32))


@pytest.mark.parametrize("spec,k,n,pad", _grid())
def test_codec_matches_jax_bitwise(spec, k, n, pad):
    rng = np.random.default_rng(k * 7 + pad + n % 97)
    vals, idx = make_set(rng, k, n, pad)
    _assert_codec_matches_jax(spec, vals, idx, n)


@pytest.mark.parametrize("spec", ["int8:4", "fp8:4"])
def test_codec_rounding_midpoints_bitwise(spec):
    vals, idx = midpoint_set(spec)
    rng = np.random.default_rng(0)
    perm = rng.permutation(vals.size)  # slot order != index order
    _assert_codec_matches_jax(spec, vals[perm], idx[perm], 2 * vals.size)


@pytest.mark.parametrize("spec", CODECS)
def test_codec_scale_midpoints_bitwise(spec):
    vals, idx = scale_midpoint_set(spec)
    # The ties are real: the block scales are bf16 midpoints in float32.
    amax = np.abs(vals.reshape(-1, codec.get_codec(spec).block)).max(1)
    q = amax / np.float32(codec.get_codec(spec).qmax)
    assert np.all(q.astype(jnp.bfloat16).astype(np.float32) != q)
    _assert_codec_matches_jax(spec, vals, idx, 2 * vals.size)


@pytest.mark.parametrize("spec", ["fp32", "int8", "fp8:32"])
def test_codec_edge_sets_bitwise(spec):
    """An all-sentinel set and a set with k = n (every index, no
    sentinel); fp32 is the identity wire (values' bits, then indices)."""
    rng = np.random.default_rng(3)
    k = n = 64
    sets = [(np.zeros(k, np.float32), np.full(k, n, np.int32)),
            (rng.standard_normal(k).astype(np.float32),
             rng.permutation(n).astype(np.int32))]
    for vals, idx in sets:
        if spec == "fp32":
            tc = codec.get_codec(spec)
            wire = tc.encode(_t(vals), _t(idx), n=n)
            np.testing.assert_array_equal(
                wire.numpy(), np.concatenate([vals.view(np.int32), idx]))
            v, i = tc.decode(wire, k=k, n=n)
            assert torch.equal(v, _t(vals)) and torch.equal(i, _t(idx))
            assert tc.wire_set_bytes(k, n) == 8 * k
            continue
        _assert_codec_matches_jax(spec, vals, idx, n)


def test_get_codec_grammar():
    assert codec.get_codec(None).name == codec.get_codec("fp32").name \
        == "fp32"
    assert not codec.get_codec("fp32").lossy
    assert codec.get_codec("int8").block == 64
    assert codec.get_codec("int8:128").block == 128
    assert codec.get_codec("fp8:32").name == "fp8:32"
    c = codec.get_codec("int8")
    assert c.lossy and codec.get_codec(c) is c  # instance passthrough
    for bad in ("int4", "int8:7", "fp32:4", "fp8:x", "int8:0"):
        with pytest.raises(ValueError):
            codec.get_codec(bad)
        with pytest.raises(ValueError):
            jcodec.get_codec(bad)


def test_fold_wire_error_then_repair_restores_the_value():
    """A locally picked, globally rejected coordinate finds its original
    value in the residual: the fold banks vals - vq before the exchange,
    repair banks vq after. Bitwise equal to the JAX compressor's."""
    rng = np.random.default_rng(4)
    n, k = 64, 6
    vals = (3 * rng.standard_normal(k)).astype(np.float32)
    idx = rng.choice(n, size=k, replace=False).astype(np.int32)
    gidx = np.full(k, n, np.int32)
    gidx[:k - 3] = idx[3:]  # the first three local picks are rejected
    jc, tc = JaxTopK(density=k / n), TopKCompressor(density=k / n)
    jvq = jax.jit(functools.partial(
        jcodec.roundtrip_aligned, jcodec.get_codec("int8:4"), n=n))(
        jnp.asarray(vals), jnp.asarray(idx))
    tvq = codec.roundtrip_aligned("int8:4", _t(vals), _t(idx), n=n)
    np.testing.assert_array_equal(tvq.numpy(), np.asarray(jvq))
    jres = jc.fold_wire_error(jnp.zeros(n, jnp.float32), jnp.asarray(idx),
                              jnp.asarray(vals) - jvq)
    tres = tc.fold_wire_error(torch.zeros(n), _t(idx), _t(vals) - tvq)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    jrep = jc.repair(jres, jvq, jnp.asarray(idx), jnp.asarray(gidx))
    trep = tc.repair(tres, tvq, _t(idx), _t(gidx))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    np.testing.assert_allclose(trep.numpy()[idx[:3]], vals[:3], rtol=1e-6)
    # Delivered picks keep only their quantization error.
    assert np.abs(trep.numpy()[idx[3:]]).max() <= np.abs(vals).max() / 127


def _sets(p, seed):
    rng = np.random.default_rng(seed)
    sets = [make_set(rng, K, N, pad=int(rng.integers(0, 4)))
            for _ in range(p)]
    # Shared indices across ranks, so merges sum and unions collide.
    shared = rng.choice(N, size=6, replace=False).astype(np.int32)
    for r, (v, i) in enumerate(sets):
        keep = [x for x in i[:K - 8] if x not in shared and x != N]
        i[:] = np.concatenate([shared, keep, np.full(K - 6 - len(keep), N)])
        v[6 + len(keep):] = 0.0
    return (np.stack([v for v, _ in sets]), np.stack([i for _, i in sets]))


TREE_CASES = [(c, p) for c in ("int8", "fp8:32") for p in TREE_PS]
GATHER_CASES = [(c, p) for c in ("fp32", "int8") for p in GATHER_PS]


@pytest.fixture(scope="module")
def port_codec_world():
    """Every tree and allgather case from one spawn of 8 gloo ranks:
    (inputs, {case: per-rank results})."""
    tree = {case: _sets(case[1], seed=i) for i, case in enumerate(TREE_CASES)}
    gather = {case: _sets(case[1], seed=50 + i)
              for i, case in enumerate(GATHER_CASES)}
    per_rank = spawn(programs.codec_collectives, max(TREE_PS), tree, gather,
                     K, N, backend="gloo", device="cpu", timeout=180)
    out = {}
    for kind, cases in (("tree", tree), ("gather", gather)):
        for (c, p) in cases:
            out[(kind, c, p)] = [per_rank[r][(kind, c, p)] for r in range(p)]
    return {"tree": tree, "gather": gather}, out


def _jax_collective(fn, p, vals, idxs):
    body = jax.shard_map(
        lambda v, i: jax.tree.map(lambda x: x[None], fn(v[0], i[0])),
        mesh=make_mesh(p), in_specs=(P("dp"), P("dp")), out_specs=P("dp"),
        check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(jnp.asarray(vals),
                                                  jnp.asarray(idxs)))


@pytest.mark.parametrize("spec,p", TREE_CASES)
def test_codec_tree_matches_jax_on_every_rank(port_codec_world, spec, p):
    inputs, results = port_codec_world
    vals, idxs = inputs["tree"][(spec, p)]
    jv, ji = _jax_collective(functools.partial(
        jcoll.gtopk_allreduce, k=K, n=N, axis_name="dp", axis_size=p,
        codec=spec), p, vals, idxs)
    ref = collectives.merge_tree_ref(
        [(_t(vals[r]), _t(idxs[r])) for r in range(p)], K, N, codec=spec)
    set_bytes = codec.get_codec(spec).wire_set_bytes(K, N)
    sent = 0
    for r in range(p):
        got = results[("tree", spec, p)][r]
        np.testing.assert_array_equal(got["idx"], ji[r])
        np.testing.assert_array_equal(got["vals"].view(np.int32),
                                      jv[r].view(np.int32))
        np.testing.assert_array_equal(ref[r][1].numpy(), ji[r])
        np.testing.assert_array_equal(ref[r][0].numpy().view(np.int32),
                                      jv[r].view(np.int32))
        assert got["rounds"] == collectives.tree_rounds(p)
        assert got["bytes"] % set_bytes == 0
        sent += got["bytes"]
    # Every round one wire per sending rank: over the ranks, the model's
    # sets a round times the senders of each round.
    senders = sum(len(pairs) for pairs in collectives._tree_plan(p))
    assert sent == senders * set_bytes
    if p & (p - 1) == 0:
        assert sent == p * collectives.comm_bytes_per_step(
            "gtopk", N, K, p, codec=spec)


@pytest.mark.parametrize("spec,p", GATHER_CASES)
def test_topk_allgather_matches_jax_on_every_rank(port_codec_world, spec, p):
    inputs, results = port_codec_world
    vals, idxs = inputs["gather"][(spec, p)]
    dense = _jax_collective(functools.partial(
        jcoll.topk_allgather, k=K, n=N, axis_name="dp", axis_size=p,
        codec=spec), p, vals, idxs)
    c = codec.get_codec(spec)
    for r in range(p):
        got = results[("gather", spec, p)][r]
        np.testing.assert_array_equal(got["dense"].view(np.int32),
                                      dense[r].view(np.int32))
        assert got["bytes"] == collectives.comm_bytes_per_step(
            "allgather", N, K, p, codec=spec) == p * c.wire_set_bytes(K, N)
        assert got["rounds"] == 1
    # The ranks' sets collide at the shared indices: sums, not copies.
    assert np.count_nonzero(dense[0]) < np.count_nonzero(vals)


@pytest.mark.parametrize("mode", [m for m in ALL_MODES])
def test_comm_bytes_per_step_matches_jax(mode):
    n, k = 272_474, 273
    for spec in ("fp32", "int8", "int8:4", "fp8", "fp8:32"):
        for p in (1, 2, 3, 4, 8):
            assert (collectives.comm_bytes_per_step(mode, n, k, p,
                                                    codec=spec)
                    == jcoll.comm_bytes_per_step(mode, n, k, p, codec=spec))
    if mode == "gtopk":  # the numbers the card's run is held to
        assert collectives.comm_bytes_per_step(
            "gtopk", n, k, 4, codec="int8") == 1400
        assert collectives.comm_bytes_per_step(
            "gtopk", n, k, 3, codec="fp8:32") == 3 * 708
        assert collectives.comm_bytes_per_step(
            "allgather", n, k, 4, codec="int8") == 2800
        assert collectives.comm_bytes_per_step(
            "topk", n, k, 4) == 8736
