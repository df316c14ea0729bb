"""The ``overlap`` and ``auto`` pipelines of the bucketed layer-wise wire,
the selection cost that prices them, and the benchmark harness, against
the JAX package on the CPU.

Held equal to the JAX package, at its selection cost (gamma 1.0 ms per
1e6 elements, passed explicitly: the port's own is measured on the card):
the ``--pipeline`` grammar and the refusal of ``overlap`` without
buckets (messages); the ``BucketPlan`` manifest with its order;
``stage_cost_ms``, ``partition_cost_ms``, ``pipeline_span_ms`` and
``describe`` (floats, exactly: the same expressions in the same order);
``plan_buckets``'s boundaries, ks and resolved order over a grid of
alpha, beta, P, codec and schedule, the crossover case included; the
planner's span columns.

Over gloo ranks (one spawn a P, every case in it): ``overlap`` bitwise
equal to ``serial`` (parameters, residuals, global sets, wire bytes) and
to the JAX package's ``overlap`` (as ``tests/test_torch_layerwise.py``
holds a step: sets and residuals bitwise, parameters within 1e-6) for 3
steps at P in {2, 3, 5} x codec {fp32, int8:16} x schedule {tree,
balanced}, and the first step against a numpy oracle. On the CPU the
``overlap`` order runs the merges on the optimizer's merge thread and
the selections on the calling thread, with no streams.

The harness at ResNet-20, batch 4, on the CPU: record keys equal to
JAX's ``measure_throughput`` / ``measure_breakdown`` keys, the same
``comm_bytes_model``, and ``attr_from_breakdown`` equal to JAX's on the
same input. Plus the overlap share's interval arithmetic.
"""

import math

import numpy as np
import pytest
import torch

import test_torch_rank_programs as programs
from gtopkssgd_tpu import benchmark as jbenchmark
from gtopkssgd_tpu.optimizer import gtopk_sgd
from gtopkssgd_tpu.parallel import bucketing as jbucketing
from gtopkssgd_tpu.parallel import planner as jplanner
from gtopkssgd_tpu_torch import benchmark
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel import bucketing, planner
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.profile_step import overlap_share
from test_torch_layerwise import BASE, JAX_FIT, LEAVES, _check, _jax_run

torch.set_num_threads(2)
GAMMA = 1.0  # the JAX package's SELECT_GAMMA_MS_PER_MELEM
LW = dict(compression="gtopk_layerwise")
STEPS = 3


@pytest.mark.parametrize("mode", ["gtopk", "gtopk_layerwise", "gtopk_hier",
                                  "allgather", "dense"])
def test_overlap_without_buckets_is_refused_as_jax(mode):
    params = [torch.nn.Parameter(torch.zeros(8))]
    with pytest.raises(ValueError) as want:
        gtopk_sgd(0.1, compression=mode, pipeline="overlap")
    with pytest.raises(ValueError) as got:
        GTopKSGD(params, 0.1, compression=mode, pipeline="overlap")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        gtopk_sgd(0.1, compression=mode, pipeline="sometimes")
    with pytest.raises(ValueError) as got:
        GTopKSGD(params, 0.1, compression=mode, pipeline="sometimes")
    assert str(got.value) == str(want.value)


def test_bucket_plan_carries_its_order_through_the_manifest():
    sizes = (32, 5, 6, 12)
    kw = dict(p=4, alpha_ms=1.0, beta_gbps=0.6)
    for pipe in ("serial", "overlap"):
        got = bucketing.plan_buckets(sizes, 0.125, buckets=2, pipeline=pipe,
                                     select_gamma=GAMMA, **kw)
        want = jbucketing.plan_buckets(sizes, 0.125, buckets=2,
                                       pipeline=pipe, **kw)
        assert got.to_manifest() == want.to_manifest()
        back = bucketing.BucketPlan.from_manifest(got.to_manifest())
        assert back.pipeline == pipe and back.pairs() == got.pairs()
    with pytest.raises(ValueError) as want:
        jbucketing.BucketPlan((0, 1), (4,), (1,), pipeline="auto")
    with pytest.raises(ValueError) as got:
        bucketing.BucketPlan((0, 1), (4,), (1,), pipeline="auto")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("p,codec,schedule", [
    (1, "fp32", None), (2, "fp32", None), (4, "int8", None),
    (5, "fp8:32", "balanced"), (8, "fp32", "balanced")])
def test_stage_partition_span_and_describe_equal_jax(p, codec, schedule):
    sizes = (1_000_000, 3_000_000, 2_000_000, 37, 640)
    kw = dict(p=p, codec=codec, schedule=schedule, alpha_ms=0.4,
              beta_gbps=2.5)
    for pipe in ("serial", "overlap"):
        plan = bucketing.BucketPlan(
            (0, 1, 3, 5), sizes,
            tuple(bucketing.k_for_density(s, 0.001) for s in
                  (sizes[0], sum(sizes[1:3]), sum(sizes[3:]))),
            pipeline=pipe)
        jplan = jbucketing.BucketPlan(plan.boundaries, sizes, plan.ks,
                                      pipeline=pipe)
        for n_b, k_b in plan.pairs():
            assert bucketing.stage_cost_ms(
                n_b, k_b, pipeline=pipe, select_gamma=GAMMA,
                **kw) == jbucketing.stage_cost_ms(n_b, k_b, pipeline=pipe,
                                                  **kw)
        assert bucketing.partition_cost_ms(
            plan, pipeline=pipe, select_gamma=GAMMA,
            **kw) == jbucketing.partition_cost_ms(jplan, pipeline=pipe, **kw)
        for order in (None, "serial", "overlap"):
            assert bucketing.pipeline_span_ms(
                plan, pipeline=order, select_gamma=GAMMA,
                **kw) == jbucketing.pipeline_span_ms(jplan, pipeline=order,
                                                     **kw)
        assert bucketing.describe(plan, select_gamma=GAMMA,
                                  **kw) == jbucketing.describe(jplan, **kw)
    with pytest.raises(ValueError, match="select_gamma"):
        bucketing.pipeline_span_ms(plan, select_gamma=None, **kw)


ALPHAS_BETAS = ((0.0, 1.0), (0.05, 0.6), (0.1, 0.6), (1.0, 5.0),
                (22.0, 0.6))


@pytest.mark.parametrize("codec,schedule", [("fp32", None),
                                            ("int8:16", None),
                                            ("fp32", "balanced"),
                                            ("fp8", "balanced")])
def test_plan_buckets_resolves_the_order_as_jax(codec, schedule):
    sizes = (1_000_000,) * 4 + (300, 4608, 10, 2_359_296, 640, 37)
    for alpha, beta in ALPHAS_BETAS:
        for p in (1, 2, 3, 4, 8):
            for spec in ("auto", 3, "leaf"):
                for pipe in ("serial", "overlap", "auto"):
                    kw = dict(buckets=spec, p=p, codec=codec,
                              schedule=schedule, alpha_ms=alpha,
                              beta_gbps=beta, pipeline=pipe)
                    got = bucketing.plan_buckets(sizes, 0.001,
                                                 select_gamma=GAMMA, **kw)
                    want = jbucketing.plan_buckets(sizes, 0.001, **kw)
                    case = (alpha, beta, p, spec, pipe)
                    assert got.boundaries == want.boundaries, case
                    assert got.ks == want.ks, case
                    assert got.pipeline == want.pipeline, case
                    assert got.to_manifest() == want.to_manifest(), case


def test_dp_crossover_case_matches_jax():
    """JAX's crossover (tests/test_bucketing.py): at alpha 0.1 ms the
    overlap-priced DP opens 8 buckets, the serial one keeps 1, and 'auto'
    takes the overlap; at alpha 22 ms both collapse and 'auto' keeps
    'serial'."""
    sizes = (1_000_000,) * 8
    for alpha, want_pipe, want_b in ((0.1, "overlap", 8), (22.0, "serial",
                                                            1)):
        kw = dict(p=8, codec="fp32", alpha_ms=alpha, beta_gbps=0.6)
        plans = {}
        for pipe in ("serial", "overlap", "auto"):
            plans[pipe] = bucketing.plan_buckets(
                sizes, 0.001, buckets="auto", pipeline=pipe,
                select_gamma=GAMMA, **kw)
            want = jbucketing.plan_buckets(sizes, 0.001, buckets="auto",
                                           pipeline=pipe, **kw)
            assert plans[pipe].to_manifest() == want.to_manifest()
        assert plans["auto"].pipeline == want_pipe
        assert plans["auto"].n_buckets == want_b
    assert plans["serial"].n_buckets == 1


@pytest.mark.parametrize("pipe", ["serial", "overlap"])
def test_planner_records_pipeline_and_spans_as_jax(pipe):
    pairs = ((123_520, 124), (73_984, 74), (74_970, 75))
    for alpha, beta in ALPHAS_BETAS:
        for p in (2, 3, 4, 8):
            kw = dict(p=p, n=272_474, k=273, codec="fp32", alpha_ms=alpha,
                      beta_gbps=beta, ici_gbps=beta, bucketing="b3",
                      buckets=pairs, pipeline=pipe)
            got = planner.build_decision("gtopk_layerwise",
                                         select_gamma=GAMMA, **kw)
            want = jplanner.build_decision("gtopk_layerwise", **kw)
            assert got.record() == want.record()
            assert got.plan.pipeline == pipe
    no_gamma = planner.build_decision("gtopk", p=4, n=272_474, k=273,
                                      alpha_ms=1.0, beta_gbps=1.0,
                                      ici_gbps=1.0)
    assert all(c["span_serial_ms"] is None and c["span_overlap_ms"] is None
               for c in no_gamma.candidates)


def test_selection_fit_is_the_cards_and_a_device_without_one_raises():
    """The committed fit names an H100 and its power limit, one entry a
    method; a device it does not hold (the CPU) has none: the lookup
    gives None and the loader raises naming the probe, and so does an
    optimizer that has to price a selection."""
    import json

    with open(bucketing.SELECT_FIT) as fh:
        doc = json.load(fh)
    assert "H100" in doc["card"] and doc["script"] == bucketing.SELECT_PROBE
    methods = {f["method"] for f in doc["fits"]}
    assert methods == {"exact", "threshold", "pallas", "twostage"}
    for f in doc["fits"]:
        assert f["device"] in doc["card"] and f["power_limit"].endswith("W")
        assert f["gamma_ms_per_melem"] > 0 and len(f["sizes"]) == len(f["ms"])
        assert bucketing.find_select_gamma(
            f["device"], f["method"]) == f["gamma_ms_per_melem"]
    assert bucketing.find_select_gamma("cpu", "twostage") is None
    with pytest.raises(ValueError, match="select_probe"):
        bucketing.load_select_gamma("cpu", "twostage")
    params = [torch.nn.Parameter(torch.zeros(40))]
    for buckets, pipe in ((2, "overlap"), ("auto", "auto"), ("leaf", "auto")):
        with pytest.raises(ValueError, match="select_probe"):
            GTopKSGD(params, 0.1, buckets=buckets, pipeline=pipe, **LW)
    # A pinned 'leaf' overlap prices nothing; an explicit gamma is enough.
    assert GTopKSGD(params, 0.1, buckets="leaf", pipeline="overlap",
                    **LW).bucket_plan.pipeline == "overlap"
    assert GTopKSGD(params, 0.1, buckets=2, pipeline="auto",
                    select_gamma=GAMMA, **LW).select_gamma == GAMMA


def _grads(p, seed):
    rng = np.random.default_rng(seed)
    leaves0 = [rng.standard_normal(s).astype(np.float32) for s in LEAVES]
    grads = [[(rng.standard_normal((p, s)) * (1 + 3 * (i % 2))).astype(
        np.float32) for i, s in enumerate(LEAVES)] for _ in range(STEPS)]
    return leaves0, grads


CODECS = ("fp32", "int8:16")
SCHEDULES = ("tree", "balanced")


def _case(pipe, codec, schedule):
    return dict(LW, topk_method="exact", buckets=2, pipeline=pipe,
                wire_codec=codec, comm_plan=schedule)


def _port_kw(kw):
    out = {("lr" if key == "learning_rate" else key): v
           for key, v in {**BASE, **kw}.items()}
    return dict(out, comm_model_fit=JAX_FIT, select_gamma=GAMMA)


ORACLE = dict(LW, learning_rate=0.5, momentum=0.0, weight_decay=0.0,
              density=0.125, topk_method="exact", buckets=2,
              pipeline="overlap")


@pytest.fixture(scope="module", params=[2, 3, 5])
def ranks(request):
    """Every case at P ranks in one spawn: both orders for each codec and
    schedule (and, at P = 2, the oracle's run)."""
    p = request.param
    leaves0, grads = _grads(p, seed=90 + p)
    cases = {f"{pipe}/{codec}/{schedule}": _port_kw(_case(pipe, codec,
                                                          schedule))
             for pipe in ("serial", "overlap") for codec in CODECS
             for schedule in SCHEDULES}
    if p == 2:
        cases["oracle"] = _port_kw(ORACLE)
    got = spawn(programs.leaf_optimizer_cases, p, leaves0, grads, cases,
                backend="gloo", device="cpu", timeout=300)
    return p, leaves0, grads, got


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_overlap_is_bitwise_serial_and_jax_on_gloo_ranks(ranks, codec,
                                                         schedule):
    p, leaves0, grads, got = ranks
    kw = _case("overlap", codec, schedule)
    want = _jax_run(leaves0, grads, p, {**BASE, **kw})
    for r in range(p):
        serial = got[r][f"serial/{codec}/{schedule}"]
        overlap = got[r][f"overlap/{codec}/{schedule}"]
        assert overlap[0]["merge_thread"] and not serial[0]["merge_thread"]
        assert overlap[0]["plan"] == serial[0]["plan"] == schedule
        for a, b in zip(serial, overlap):
            assert a["wire"] == b["wire"]
            for key in ("params", "residual"):
                np.testing.assert_array_equal(a[key], b[key])
            for (av, ai), (bv, bi) in zip(a["global"] + a["local"],
                                          b["global"] + b["local"]):
                np.testing.assert_array_equal(ai, bi)
                np.testing.assert_array_equal(av.view(np.int32),
                                              bv.view(np.int32))
        _check(overlap, want, r, p, kw, f"overlap P={p} {codec} {schedule}")


@pytest.mark.parametrize("ranks", [2], indirect=True)
def test_overlap_first_step_matches_numpy_oracle(ranks):
    """One bucketed step from a zero residual, momentum off (JAX's oracle,
    tests/test_bucketing.py): per rank the exact top-k of each bucket,
    the merge as a dense sum and its top-k, averaged, times -lr."""
    p, leaves0, grads, got = ranks
    lr, density = ORACLE["learning_rate"], ORACLE["density"]
    alpha = planner.planner_inputs(JAX_FIT)
    plan = bucketing.plan_buckets(
        LEAVES, density, buckets=2, p=p, alpha_ms=alpha["alpha_ms"],
        beta_gbps=alpha["beta_gbps"], pipeline="overlap",
        select_gamma=GAMMA)

    def np_topk(x, k):
        idx = np.argsort(-np.abs(x), kind="stable")[:k]
        return x[idx].astype(np.float32), idx.astype(np.int32)

    want = np.zeros(sum(LEAVES), np.float64)
    for b, (n_b, k_b) in enumerate(plan.pairs()):
        lo, hi = plan.leaf_range(b)
        off = sum(LEAVES[:lo])
        dense = np.zeros(n_b, np.float64)
        for rank in range(p):
            flat = np.concatenate([grads[0][leaf][rank]
                                   for leaf in range(lo, hi)])
            v, i = np_topk(flat, k_b)
            np.add.at(dense, i, v)
        gv, gi = np_topk(dense, k_b)
        upd = np.zeros(n_b, np.float64)
        np.add.at(upd, gi[gv != 0], gv[gv != 0])
        want[off:off + n_b] = -lr * upd / p
    start = np.concatenate(leaves0)
    for r in range(p):
        got_upd = got[r]["oracle"][0]["params"] - start
        np.testing.assert_allclose(got_upd, want, rtol=1e-5, atol=1e-7)


def test_overlap_share_counts_other_units_exchanges():
    """Unit i's selection kernels count where they lie inside another
    unit's exchange window; its own exchange does not count."""
    sel = [[(0.0, 10.0)], [(12.0, 20.0), (25.0, 30.0)]]
    assert overlap_share(sel, [(10.5, 11.5), (41.0, 50.0)]) == 0.0
    assert overlap_share(sel, [(15.0, 27.0), (5.0, 8.0)]) == 10.0 / 23.0
    assert overlap_share([[]], [(0.0, 1.0)]) is None
    assert overlap_share(sel, [(0.0, 1.0)]) is None


def test_trace_overlap_share_reads_launches_and_ranges():
    """The share from a Chrome trace in the profiler's format: a kernel
    belongs to the "select" range its launch (same correlation id)
    started in, on the range's thread; a kernel launched elsewhere, or
    with no launch in the trace, counts nowhere."""
    import json

    from gtopkssgd_tpu_torch.profile_step import trace_overlap_share

    def ann(name, tid, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "tid": tid, "ts": ts, "dur": dur, "args": {}}

    def launch(corr, tid, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "tid": tid, "ts": ts, "dur": 1.0,
                "args": {"correlation": corr}}

    def kernel(corr, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "k", "tid": 7, "ts": ts,
                "dur": dur, "args": {"correlation": corr, "stream": 7}}

    events = [ann("select", 1, 0, 10), ann("select", 1, 20, 10),
              ann("exchange", 2, 15, 30), ann("exchange", 2, 50, 5),
              launch(1, 1, 5), launch(2, 1, 25), launch(3, 2, 16),
              launch(5, 1, 8),
              kernel(1, 6, 4), kernel(2, 26, 8, "gpu_memset"),
              kernel(3, 17, 2), kernel(4, 30, 100), kernel(5, 9, 6)]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": events}, fh)

    # Exchange 0 launched one kernel, (17, 19): its window; exchange 1
    # launched nothing: its range (50, 55). Unit 1's memset (26, 34) lies
    # in neither: 0 of 18.
    assert trace_overlap_share(Prof()) == 0.0
    # An exchange's device work can outlast its host range (NCCL): unit
    # 1's range is (50, 51), its kernel (52, 72) its window, and a kernel
    # of unit 0's selection at (53, 56) counts: 3 of 21.
    events[3] = ann("exchange", 2, 50, 1)
    events += [launch(6, 2, 50.5), kernel(6, 52, 20), launch(8, 1, 7),
               kernel(8, 53, 3)]
    assert trace_overlap_share(Prof()) == 3.0 / 21.0
    # Exchange 0's device span widened to (17, 30) takes 4 of the memset.
    events += [launch(9, 2, 40), kernel(9, 29, 1)]
    assert trace_overlap_share(Prof()) == 7.0 / 21.0


HARNESS = dict(dnn="resnet20", batch_size=4, steps=2, min_seconds=0.05)


def test_harness_records_match_jax():
    """The JAX harness on one device against the port's on the CPU:
    ResNet-20, batch 4, gTop-k at density 0.05 (the JAX harness tests'
    point) with ``exact`` selection."""
    mode, density = "gtopk", 0.05
    jcfg = jbenchmark.BenchConfig(dtype="float32", nworkers=1,
                                  topk_method="exact", **HARNESS)
    cfg = benchmark.BenchConfig(nworkers=1, topk_method="exact",
                                dtype="float32", device="cpu", **HARNESS)
    want_t = jbenchmark.measure_throughput(jcfg, mode, density)
    got_t = benchmark.measure_throughput(cfg, mode, density)
    assert set(got_t) == set(want_t)
    for key in ("mode", "density", "comm_bytes_model", "num_params",
                "nworkers"):
        assert got_t[key] == want_t[key], key
    assert got_t["flops_per_step"] > 0 and got_t["mfu"] is None
    assert got_t["steps_timed"] * got_t["sec_per_step"] == pytest.approx(
        got_t["window_seconds"])
    want_b = jbenchmark.measure_breakdown(jcfg, mode, density)
    got_b = benchmark.measure_breakdown(cfg, mode, density)
    assert set(got_b) == set(want_b)
    assert got_b["sum"] == pytest.approx(
        sum(got_b[k] for k in ("forward_backward", "compress", "comm",
                               "apply")))
    for rec in (want_b, got_b):
        assert benchmark.attr_from_breakdown(
            rec) == jbenchmark.attr_from_breakdown(rec)


@pytest.mark.parametrize("mode", [None, "gtopk_layerwise"])
def test_harness_keys_of_dense_and_layerwise_match_jax(mode):
    """The breakdown's keys in dense and layer-wise (concat) mode, JAX's
    from the same config; the bucketed arm adds its loop's phase."""
    density = 1.0 if mode is None else 0.05
    jcfg = jbenchmark.BenchConfig(dtype="float32", nworkers=1,
                                  topk_method="exact", **HARNESS)
    cfg = benchmark.BenchConfig(nworkers=1, topk_method="exact",
                                dtype="float32", device="cpu", **HARNESS)
    got = benchmark.measure_breakdown(cfg, mode, density)
    want = jbenchmark.measure_breakdown(jcfg, mode, density)
    assert set(got) == set(want)
    assert got.get("k_total") == want.get("k_total")
    # bfloat16, the default of both harnesses, runs in the port.
    bf16 = benchmark.measure_throughput(
        benchmark.BenchConfig(device="cpu", **HARNESS), mode, density)
    assert benchmark.BenchConfig().dtype == jbenchmark.BenchConfig().dtype
    assert bf16["sec_per_step"] > 0 and bf16["flops_per_step"] > 0
    assert bf16["num_params"] == 272_474 and bf16["mode"] == (mode
                                                              or "dense")
    assert math.isfinite(got["sum"]) and got["comm"] == 0.0


def test_harness_times_both_orders_of_a_bucketed_arm_on_gloo_ranks():
    cfg = benchmark.BenchConfig(nworkers=2, topk_method="exact",
                                device="cpu", buckets="3",
                                pipeline="overlap", select_gamma=GAMMA,
                                **HARNESS)
    got = benchmark.measure_breakdown(cfg, "gtopk_layerwise", 0.05)
    assert got["pipeline"] == "overlap" and got["buckets"] == 3
    assert got["comm"] > 0 and got["select_and_comm"] > 0
    assert "compress_per_bucket" in got
    assert benchmark.attr_from_breakdown(got)["t_select_us"] > 0


def test_harness_ranks_take_distinct_batches_and_gradients():
    """Each rank times its own batch (row r of the JAX harness's (P,)
    draw), so the merge sees distinct sets: rank 0 holds the P = 1
    batch, the other ranks their own, and the gradients differ."""
    cfg = benchmark.BenchConfig(nworkers=2, device="cpu", **HARNESS)
    ranks = spawn(programs.bench_gradients, 2, cfg, "gtopk", 0.05,
                  backend="gloo", device="cpu", timeout=300)
    one = benchmark._Bench(benchmark.BenchConfig(device="cpu", **HARNESS),
                           "gtopk", 0.05, torch.device("cpu"), None)
    one.close()
    np.testing.assert_array_equal(ranks[0]["x"], one.x.numpy())
    assert not np.array_equal(ranks[0]["x"], ranks[1]["x"])
    assert np.isfinite(ranks[0]["grad"]).all()
    assert not np.array_equal(ranks[0]["grad"], ranks[1]["grad"])

