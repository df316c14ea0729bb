"""The port's per-rank trace planes (``gtopkssgd_tpu_torch.obs``:
``trace_attr``, ``critpath``, ``ledger``, ``calib``, ``linkmap``,
``memwatch``) against the JAX package's, on the CPU, inputs from a numpy
seed, and their wiring in the trainer and the command line.

Tolerances: the planes are the same float64 arithmetic in the same order,
so counts, keys, classes, records and texts are compared EXACTLY; the
ledger's rows too, apart from ``fit_source`` (the JAX ledger labels
constants passed by the caller "defaults", the port "arg"); the
calibrator's per-axis fits within relative 1e-9 (the port carves a
sample over the rounds with the baseline's alpha, the JAX module with a
fixed one: an even carve either way on one link class, up to a
rounding). The JAX package's TPU link constants never enter the port:
each parity test passes both sides the same made-up constants.

* trace_attr: the mode-independent core (self durations, interval union,
  overlap fraction, the per-class spans/ops choice, the stage intervals)
  on one synthetic trace written in each package's lanes; a real
  ``torch.profiler`` capture of a ResNet-20 step at P = 1 (select and
  compute attributed) and at P = 2 over gloo (comm > 0, from the host's
  c10d/gloo events), and ``--profile-dir``;
* critpath, calib, linkmap, ledger: their functions and classes fed the
  same inputs;
* memwatch: a "compile" record whose FLOPs equal the benchmark's count,
  "mem" records, a recompile;
* the six monitor rules these planes feed, each fired through its plane
  (goodput_collapse in ``test_torch_goodput.py``).
"""

import json
import math
import os

import numpy as np
import pytest

import test_torch_rank_programs as programs
from gtopkssgd_tpu.obs import calib as jax_calib
from gtopkssgd_tpu.obs import critpath as jax_critpath
from gtopkssgd_tpu.obs import ledger as jax_ledger
from gtopkssgd_tpu.obs import linkmap as jax_linkmap
from gtopkssgd_tpu.obs import trace_attr as jax_trace_attr
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.obs import (
    calib,
    critpath,
    ledger,
    linkmap,
    memwatch,
    trace_attr,
)
from gtopkssgd_tpu_torch.obs.events import AnomalyMonitor, Thresholds
from gtopkssgd_tpu_torch.parallel import collectives
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

# Made-up link constants both sides are given (no TPU constant).
ALPHA_MS, BETA_GBPS, ICI_GBPS = 0.5, 10.0, 80.0


def _records(path):
    return [json.loads(line) for line in open(path)]


# ------------------------------------------------------------ trace_attr

# Op names a class, each package's: HLO names for the JAX module, kernel
# names for the port's.
_OP_NAMES = {
    "jax": {"compute": "fusion.{i}", "select": "sort.{i}",
            "comm": "all-reduce.{i}"},
    "port": {"compute": "void conv_fwd_kernel_{i}",
             "select": "void stage1_kernel<true>_{i}",
             "comm": "ncclDevKernel_AllReduce_{i}"},
}
# Range names both classify alike.
_SPAN_NAMES = {"compute": "forward_backward", "select": "select",
               "comm": "comm"}


def _synthetic(seed, span_terms):
    """(ops, spans) of one step on two lanes: ops [(lane, class, ts,
    dur)] -- some nested in a wrapper of their class -- and spans
    [(class, ts, dur)] for the classes in `span_terms`."""
    rng = np.random.default_rng(seed)
    ops, spans = [], []
    for lane in (0, 1):
        t = float(rng.uniform(0, 5))
        for i in range(12):
            cls = ("compute", "select", "comm")[int(rng.integers(3))]
            dur = float(rng.uniform(1, 40))
            ops.append((lane, cls, t, dur))
            if i % 4 == 0:  # two children nested inside it
                c0 = t + dur * 0.1
                ops.append((lane, cls, c0, dur * 0.3))
                ops.append((lane, "select", c0 + dur * 0.4, dur * 0.2))
            t += dur + float(rng.uniform(0, 3))
    t = 0.0
    for cls in span_terms:
        dur = float(rng.uniform(50, 200))
        spans.append((cls, t, dur))
        t += dur + 1.0
    return ops, spans


def _render(which, ops, spans):
    """The Chrome trace of (ops, spans) in `which` package's lanes."""
    ev = []
    names = _OP_NAMES[which]
    if which == "jax":
        ev.append({"ph": "M", "name": "process_name", "pid": 1,
                   "args": {"name": "/device:TPU:0"}})
        for tid, lane in ((10, "XLA Ops"), (11, "XLA Ops"),
                          (20, "Annotations")):
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": lane}})
    for i, (lane, cls, ts, dur) in enumerate(ops):
        e = {"ph": "X", "pid": 1, "tid": 10 + lane, "ts": ts, "dur": dur,
             "name": names[cls].format(i=i)}
        if which == "port":
            e["cat"] = "kernel"
        ev.append(e)
    for cls, ts, dur in spans:
        e = {"ph": "X", "pid": 1, "tid": 20, "ts": ts, "dur": dur,
             "name": _SPAN_NAMES[cls]}
        if which == "port":
            e["cat"] = "gpu_user_annotation"
        ev.append(e)
    return {"traceEvents": ev}


_CORE = ("source", "n_op_events", "n_span_events", "t_total_us",
         "overlap_frac", "t_compute_us", "t_select_us", "t_comm_us",
         "frac_compute", "frac_select", "frac_comm", "source_compute",
         "source_select", "source_comm")


@pytest.mark.parametrize("seed,span_terms,coverage", [
    (0, (), 0.5),                               # ops only
    (1, ("compute", "select", "comm"), 0.5),    # spans where they cover
    (2, ("select",), 0.5),                      # mixed
    (3, ("compute", "comm"), 0.05),
])
def test_attribution_core_as_jax(seed, span_terms, coverage):
    ops, spans = _synthetic(seed, span_terms)
    got = trace_attr.attribute(_render("port", ops, spans),
                               min_span_coverage=coverage,
                               stage_intervals=True, wire_us=30.0)
    want = jax_trace_attr.attribute(_render("jax", ops, spans),
                                    min_span_coverage=coverage,
                                    stage_intervals=True, wire_us=30.0)
    assert {k: got[k] for k in _CORE} == {k: want[k] for k in _CORE}
    assert got["critpath"] == want["critpath"]
    assert got["lanes"] == "device"
    assert got["comm_source"] == ("device" if got["t_comm_us"] else "none")
    assert sum(got["select_ops"].values()) == sum(
        1 for _, c, _, _ in ops if c == "select")


def test_kernels_take_the_class_of_the_range_they_were_launched_in():
    """A Kineto-shaped card trace: the forward's kernels launched in
    "forward_backward" on the main thread, the backward's by autograd's
    thread outside any range, an elementwise kernel and K2 launched in
    "select". Select is the kernels launched in its range (spans); the
    forward alone covers too little of compute, which falls back to the
    kernel names (ops); a ``gpu_user_annotation`` is not counted."""
    ev, corr = [], 0

    def launch(tid, t, name, k_ts, dur):
        nonlocal corr
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "pid": 1, "tid": tid, "ts": t,
                   "dur": 1.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 7, "ts": k_ts, "dur": dur,
                   "args": {"correlation": corr}})

    ev.append({"ph": "X", "cat": "user_annotation", "name":
               "forward_backward", "pid": 1, "tid": 100, "ts": 0.0,
               "dur": 50.0})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "dispatch",
               "pid": 1, "tid": 100, "ts": 0.0, "dur": 200.0})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "select",
               "pid": 1, "tid": 100, "ts": 150.0, "dur": 20.0})
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name":
               "forward_backward", "pid": 0, "tid": 7, "ts": 0.0,
               "dur": 500.0})
    for i in range(3):
        launch(100, 5.0 + i, "void cudnn::conv_fwd", 10.0 + 20 * i, 10.0)
    for i in range(5):
        launch(101, 60.0 + i, "void cudnn::conv_dgrad", 100.0 + 30 * i,
               25.0)
    launch(100, 155.0, "void at::elementwise_kernel", 260.0, 4.0)
    launch(100, 160.0, "void stage1_kernel<true>", 270.0, 6.0)
    rec = trace_attr.attribute({"traceEvents": ev})
    assert (rec["source_select"], rec["source_compute"]) == ("spans", "ops")
    assert rec["source"] == "mixed" and rec["n_span_events"] == 5
    assert rec["t_select_us"] == 10.0
    assert rec["t_compute_us"] == 3 * 10.0 + 5 * 25.0 + 4.0
    assert rec["select_ops"] == {"void stage1_kernel<true>": 1}


def test_interval_core_as_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        starts = rng.uniform(0, 100, size=30)
        ivs = [(float(s), float(s + d)) for s, d in
               zip(starts, rng.uniform(-2, 15, size=30))]
        other = [(float(s), float(s + d)) for s, d in
                 zip(rng.uniform(0, 100, 20), rng.uniform(0, 10, 20))]
        assert trace_attr._interval_union(ivs) == \
            jax_trace_attr._interval_union(ivs)
        assert trace_attr.overlap_fraction(ivs, other) == \
            jax_trace_attr.overlap_fraction(ivs, other)
        events = [{"ts": s, "dur": max(0.0, e - s)} for s, e in ivs]
        assert trace_attr.self_durations_us(events) == \
            jax_trace_attr.self_durations_us(events)
    assert trace_attr.classify_op("void stage1_kernel<true, false, 4>(")\
        == "select"
    for name in ("void multisection_kernel<2>", "count_kernel",
                 "void at::native::sbtopk::gatherTopK<float>",
                 "cub::DeviceRadixSortOnesweepKernel", "aten::topk",
                 "aten::sort"):
        assert trace_attr.classify_op(name) == "select", name
    for name in ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
                 "ncclKernel_AllReduce_RING", "c10d::allreduce_",
                 "gloo:send"):
        assert trace_attr.classify_op(name) == "comm", name
    for name in ("void cudnn::conv_fwd", "aten::mkldnn_convolution",
                 "Memcpy HtoD (Pageable -> Device)"):
        assert trace_attr.classify_op(name) == "compute", name
    assert [trace_attr.classify_span(n) for n in (
        "select", "exchange", "gloo:all_reduce", "forward_backward",
        "Optimizer.step#GTopKSGD.step", "dispatch", "data", "obs_read",
        "dispatch/forward_backward")] == [
        "select", "comm", "comm", "compute", "compute", None, None, None,
        "compute"]


SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", prefetch=0,
             eval_batches=1, log_interval=1)


def test_a_cpu_capture_attributes_select_and_compute(tmp_path):
    """ResNet-20 at P = 1 with critpath every 2 steps and the memory
    watch: "attr" and "critpath" records of the profiled dispatches
    (select and compute > 0, no comm, on the host lanes), one "compile"
    record whose FLOPs equal the benchmark's count of the same step, and
    "mem" records."""
    from gtopkssgd_tpu_torch.benchmark import BenchConfig, _Bench

    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             obs_critpath=True, obs_calib_interval=2,
                             obs_mem=True, obs_mem_interval=2,
                             **SMALL)) as t:
        t.train(4)
        assert t.calib is None  # P = 1: no wire to calibrate
    recs = _records(tmp_path / "metrics.jsonl")
    attrs = [r for r in recs if r["kind"] == "attr"]
    assert [r["step"] for r in attrs] == [2, 4]
    for r in attrs:
        assert r["lanes"] == "host" and r["comm_source"] == "none"
        assert r["t_select_us"] > 0 and r["t_compute_us"] > 0
        assert r["t_comm_us"] == 0 and r["n_steps"] == 1
        assert "aten::topk" in r["select_ops"]
        text = trace_attr.format_attr(r)
        assert text.startswith("[attr] source=") and "T_select" in text
    cps = [r for r in recs if r["kind"] == "critpath"]
    assert [r["step"] for r in cps] == [2, 4]
    assert all(r["t_select_us"] > 0 and r["wall_us"] > 0 for r in cps)
    (comp,) = [r for r in recs if r["kind"] == "compile"]
    bench = _Bench(BenchConfig(dnn="resnet20", batch_size=4,
                               dtype="float32", device="cpu"),
                   "gtopk", 0.01, t.device, None)
    _, flops = memwatch.step_flops(bench.step)
    assert comp["flops"] == flops > 0 and comp["compile_s"] > 0
    assert comp["step"] == 1 and "peak_hbm_bytes" not in comp
    mems = [r for r in recs if r["kind"] == "mem"]
    assert [r["step"] for r in mems] == [1, 3]
    assert all(r["live_bytes"] > 0 and "bytes_limit" not in r
               for r in mems)
    assert not [r for r in recs if r["kind"] == "event"]


def test_profile_dir_writes_a_trace_the_planes_read(tmp_path, capsys):
    d = tmp_path / "prof"
    rc = dist_trainer.main([
        "--compression", "gtopk", "--density", "0.01", "--topk-method",
        "twostage", "--batch-size", "4", "--device", "cpu",
        "--eval-batches", "1", "--prefetch", "0", "--num-iters", "1",
        "--profile-dir", str(d), "--profile-steps", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 4  # one warm-up step, two traced, one more
    assert os.listdir(d) == ["rank0.trace.json"]
    rec = trace_attr.attribute(str(d))
    assert rec["t_compute_us"] > 0 and rec["t_select_us"] > 0
    assert trace_attr.host_span_means(str(d))["forward_backward"] > 0
    rank = trace_attr.op_ranking(str(d), top=5)
    assert rank["lanes"] == "host" and len(rank["top_ops"]) == 5


def test_p2_gloo_capture_feeds_calib_linkmap_critpath(tmp_path):
    """Two gloo ranks with the calibrator, the link map and critpath at
    every step: comm comes from the host's c10d/gloo events and is > 0;
    a refit (4 samples) with finite constants; "linkmap" records keyed by
    ``round_peers`` whose wire bytes are the "obs" records'; "ledger" rows;
    ``calib_fit_2proc.json`` in the out dir."""
    # The first capture holds the ranks' start-up skew (its critical
    # stage is wait, the others' compute): five windows keep that real
    # shift from firing critpath_shift in four captures.
    cfg = dict(SMALL, nworkers=2, obs_calib=True, obs_linkmap=True,
               obs_critpath=True, obs_calib_interval=1,
               obs_critpath_shift_windows=5)
    out = spawn(programs.trace_plane_run, 2, cfg, str(tmp_path), 4,
                backend="gloo", device="cpu", timeout=300)
    want_links = {linkmap.link_key(rd["axis"], *rd["pairs"][0])
                  for rd in linkmap.round_peers("gtopk", 2)}
    for rank, o in enumerate(out):
        recs = o["records"]
        attrs = [r for r in recs if r["kind"] == "attr"]
        assert len(attrs) == 4
        for r in attrs:
            assert r["comm_source"] == "host" and r["t_comm_us"] > 0
            assert r["source_comm"] == "host"
        cps = [r for r in recs if r["kind"] == "critpath"]
        assert len(cps) == 4 and all(
            r["t_comm_wire_us"] + r["t_wait_us"] > 0 for r in cps)
        assert all(r["t_wait_us"] >= 0 for r in cps)
        (fit,) = [r for r in recs if r["kind"] == "calib"]
        assert fit["step"] == 4 and fit["n_samples"] == 4
        assert math.isfinite(fit["alpha_fit_ms"]) and fit["beta_fit_gbps"] > 0
        wire = {r["step"]: r["wire_bytes"] for r in recs
                if r["kind"] == "obs"}
        lms = [r for r in recs if r["kind"] == "linkmap"]
        assert len(lms) == 4
        for r in lms:
            assert {x["link"] for x in r["links"]} == want_links
            assert r["wire_bytes"] == wire[r["step"]]
        assert [b for b, _ in o["samples"]] == [wire[s] for s in
                                                range(1, 5)]
        rows = [r for r in recs if r["kind"] == "ledger"]
        assert len(rows) == 4 and all(r["source"] == "attr" and
                                      r["fit_source"] == "comm_fit.json"
                                      for r in rows)
        assert not [r for r in recs if r["kind"] == "event"]
    art = json.load(open(tmp_path / "calib_fit_2proc.json"))
    assert art["source"] == "obs/calib.py" and art["procs"] == 2
    assert art["alpha_beta_fit"]["beta_gbps"] > 0
    assert ledger.load_alpha_beta(str(tmp_path))["source"] == \
        "calib_fit_2proc.json"


# -------------------------------------------------------------- critpath

def _class_intervals(rng, n=10):
    out = {}
    for cls in ("compute", "select", "comm"):
        starts = np.sort(rng.uniform(0, 1000, size=n))
        out[cls] = [(float(s), float(s + d)) for s, d in
                    zip(starts, rng.uniform(1, 80, size=n))]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critpath_as_jax(seed):
    rng = np.random.default_rng(seed)
    segs_by_rank, rows = {}, []
    for rank in range(3):
        iv = _class_intervals(rng)
        for wire in (0.0, 50.0, 1e9):
            assert critpath.wait_split(iv["comm"], wire) == \
                jax_critpath.wait_split(iv["comm"], wire)
        for norm in (True, False):
            for fill in (True, False):
                assert critpath.stage_segments(
                    iv, 120.0, normalize=norm, fill_gaps=fill) == \
                    jax_critpath.stage_segments(
                        iv, 120.0, normalize=norm, fill_gaps=fill)
        fine = critpath.stage_segments(iv, 120.0, fill_gaps=True)
        coarse = critpath.coarsen(fine, min_us=30.0)
        assert coarse == jax_critpath.coarsen(fine, min_us=30.0)
        assert critpath.stage_totals(fine) == jax_critpath.stage_totals(fine)
        rec = critpath.build_record(coarse, step=7,
                                    totals=critpath.stage_totals(fine))
        assert rec == jax_critpath.build_record(
            coarse, step=7, totals=jax_critpath.stage_totals(fine))
        assert critpath.dominant_stage(rec) == jax_critpath.dominant_stage(
            rec)
        segs_by_rank[rank] = critpath.stage_segments(iv, 120.0)
    cp = critpath.critical_path(segs_by_rank)
    assert cp == jax_critpath.critical_path(segs_by_rank)
    rows.append({**cp, "step": 1})
    budgets = {r: {**cp["stage_us"], "blocked_us": cp["blocked_us"][r]}
               for r in segs_by_rank}
    assert critpath.format_critpath(rows, budgets) == \
        jax_critpath.format_critpath(rows, budgets)


def test_modeled_wire_prices_with_the_committed_fit():
    man = {"compression": "gtopk", "nworkers": 4, "num_params": 272_474,
           "density": 0.001, "wire_codec": "fp32", "backend": "gloo"}
    fit = ledger.load_alpha_beta(backend="gloo")
    assert fit["source"] == "comm_fit.json"
    want = ledger.predict_comm_ms("gtopk", 4, n=272_474, k=273,
                                  alpha_ms=fit["alpha_ms"],
                                  beta_gbps=fit["beta_gbps"]) * 1e3
    assert critpath.modeled_wire_us(man) == want > 0
    assert critpath.modeled_wire_us({"compression": "gtopk"}) is None


def test_critpath_shift_fires_through_the_records():
    """Captures bounded by compute, then three by comm: the records'
    crit_stage fires critpath_shift at the third."""
    mon = AnomalyMonitor(thresholds=Thresholds(critpath_shift_windows=3))
    for step, (comp, comm) in enumerate(
            [(900, 50), (800, 60), (100, 900), (120, 800), (90, 700)], 1):
        iv = {"compute": [(0.0, float(comp))],
              "comm": [(float(comp), float(comp + comm))]}
        rec = critpath.build_record(critpath.stage_segments(iv, 1e9))
        mon.observe_critpath(step, crit_stage=rec["crit_stage"])
    assert [(e["rule"], e["step"]) for e in mon.events] == [
        ("critpath_shift", 5)]


# ----------------------------------------------------------------- calib

def _samples(seed, n=40, outliers=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        msgs = int(rng.integers(1, 6))
        wire = float(rng.uniform(1e4, 5e6))
        t = msgs * 0.3 + wire * 8e-6 / 12.0
        if rng.uniform() < outliers:
            t *= float(rng.uniform(2, 5))
        out.append((msgs, wire, t * float(rng.uniform(0.98, 1.02))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_alpha_beta_as_jax(seed):
    s = _samples(seed)
    assert calib.fit_alpha_beta(s, BETA_GBPS) == \
        jax_calib.fit_alpha_beta(s, BETA_GBPS)
    flat = [(2, 1e5, t) for _, _, t in s]  # no byte spread: alpha only
    got = calib.fit_alpha_beta(flat, BETA_GBPS)
    assert got == jax_calib.fit_alpha_beta(flat, BETA_GBPS)
    assert got["identifiable"] == "alpha_only"
    assert calib.fit_alpha_beta(s[:1], BETA_GBPS) is None
    for mode in ("dense", "gtopk", "gtopk_balanced", "allgather",
                 "gtopk_hier"):
        for p in range(1, 9):
            assert calib.message_count(mode, p, ici_size=2) == \
                jax_calib.message_count(mode, p, ici_size=2)


@pytest.mark.parametrize("mode,p", [("gtopk", 4), ("gtopk", 3),
                                    ("gtopk_balanced", 4)])
def test_calibrator_as_jax(mode, p, tmp_path):
    base = {"alpha_ms": ALPHA_MS, "beta_gbps": BETA_GBPS,
            "ici_gbps": ICI_GBPS, "fit_source": "made_up.json"}
    port = calib.CommCalibrator(mode, p, baseline=base)
    ref = jax_calib.CommCalibrator(mode, p, baseline=base)
    rng = np.random.default_rng(p)
    for step, (_, wire, t) in enumerate(_samples(p, n=24), 1):
        lapped = bool(rng.uniform() < 0.2)
        assert port.observe(step, wire, t, overlapped=lapped) == \
            ref.observe(step, wire, t, overlapped=lapped)
    assert port.final_fit() == ref.final_fit()
    # The per-axis pools are carved with the baseline's alpha in the port
    # and a fixed one in the JAX module: on one link class the carve is
    # even either way, up to a rounding (relative 1e-9).
    for got, want in zip(port.fits, ref.fits):
        assert got.keys() == want.keys()
        for key, v in want.items():
            assert (got[key] == pytest.approx(v, rel=1e-9)
                    if "." in key else got[key] == v), key
    assert len(port.fits) >= 3
    got, want = port.final_axis_fits(), ref.final_axis_fits()
    assert got.keys() == want.keys() == {"dcn"}
    for key, v in want["dcn"].items():
        assert got["dcn"][key] == pytest.approx(v, rel=1e-9), key
    man = {"config_hash": "abc", "compression": mode, "nworkers": p}
    a = json.load(open(port.write_artifact(str(tmp_path / "a"),
                                           manifest=man)))
    b = json.load(open(ref.write_artifact(str(tmp_path / "b"),
                                          manifest=man)))
    assert a.pop("card") is None
    assert a.pop("axes")["dcn"] == pytest.approx(b.pop("axes")["dcn"],
                                                 rel=1e-9)
    assert a == b


def test_comm_model_drift_fires_through_the_calibrator():
    """A link ten times slower than the planner's fit: the refits drift
    past comm_drift_x and the rule fires once it has armed."""
    mon = AnomalyMonitor()
    cal = calib.CommCalibrator(
        "gtopk", 4, baseline={"alpha_ms": 0.05, "beta_gbps": 100.0,
                              "fit_source": "made_up.json"},
        monitor=mon)
    for step, (_, wire, t) in enumerate(_samples(3, n=16, outliers=0), 1):
        cal.observe(step, wire, t)
    assert "comm_model_drift" in [e["rule"] for e in mon.events]


# --------------------------------------------------------------- linkmap

def test_round_peers_as_jax_and_as_the_collectives():
    for p in range(2, 9):
        for mode in ("gtopk", "gtopk_balanced", "dense", "allgather"):
            assert linkmap.round_peers(mode, p) == \
                jax_linkmap.round_peers(mode, p), (mode, p)
        for s in range(1, p + 1):
            if p % s == 0:
                assert linkmap.round_peers("gtopk_hier", p, ici_size=s) == \
                    jax_linkmap.round_peers("gtopk_hier", p, ici_size=s)
        rounds = linkmap.round_peers("gtopk", p)
        assert len(rounds) == collectives.tree_rounds(p)
        for rd, plan in zip(rounds, collectives._tree_plan(p)):
            assert set(rd["pairs"]) <= set(plan)
        for r in range(p):
            assert linkmap.rank_rounds(rounds, r) == \
                jax_linkmap.rank_rounds(rounds, r)


def test_carve_and_linkmap_as_jax():
    rng = np.random.default_rng(7)
    for _ in range(10):
        w = list(rng.uniform(0, 3, size=int(rng.integers(1, 7))))
        t = float(rng.uniform(0, 20))
        assert linkmap.carve_rounds(t, w) == jax_linkmap.carve_rounds(t, w)
    assert linkmap.carve_rounds(3.0, [0.0, 0.0]) == \
        jax_linkmap.carve_rounds(3.0, [0.0, 0.0])
    kw = dict(alpha_ms=ALPHA_MS, beta_gbps=BETA_GBPS, ici_gbps=ICI_GBPS)
    recs = []
    for mode, p, s in (("gtopk_hier", 8, 2), ("gtopk", 5, 1),
                       ("gtopk_balanced", 4, 1)):
        for rank in range(p):
            port = linkmap.LinkMap(mode, p, rank=rank, ici_size=s, **kw)
            ref = jax_linkmap.LinkMap(mode, p, rank=rank, ici_size=s, **kw)
            for step in range(1, 5):
                t, b = float(rng.uniform(1, 9)), float(rng.uniform(1e4, 1e6))
                got = port.observe(step, t_comm_ms=t, wire_bytes=b)
                assert got == ref.observe(step, t_comm_ms=t, wire_bytes=b)
                recs.append({"kind": "linkmap", "rank": rank, **got})
            assert linkmap.axis_breakdown(
                mode, p, ici_size=s, wire_bytes=b, t_comm_ms=t, rank=rank,
                **kw) == jax_linkmap.axis_breakdown(
                mode, p, ici_size=s, wire_bytes=b, t_comm_ms=t, rank=rank,
                **kw)
    recs.append({"kind": "calib", "alpha_ms.dcn": 0.2, "beta_gbps.dcn": 3.0})
    assert linkmap.linkmap_rows(recs) == jax_linkmap.linkmap_rows(recs)
    summary = linkmap.summarize_linkmap(recs)
    assert summary == jax_linkmap.summarize_linkmap(recs)
    assert linkmap.format_linkmap(summary) == \
        jax_linkmap.format_linkmap(summary)


def test_link_degraded_fires_through_the_linkmap():
    """gtopk_hier at P = 8 in slices of 2, the in-slice hop priced 1000
    times slower than the cross-slice one: rank 0's in-slice link takes
    most of each carved span and, three windows running, link_degraded
    fires."""
    mon = AnomalyMonitor(thresholds=Thresholds(link_degraded_windows=3))
    lm = linkmap.LinkMap("gtopk_hier", 8, rank=0, ici_size=2,
                         alpha_ms=0.0, beta_gbps=100.0, ici_gbps=0.1,
                         monitor=mon)
    for step in range(1, 5):
        lm.observe(step, t_comm_ms=10.0, wire_bytes=1e6)
    assert [(e["rule"], e["step"]) for e in mon.events] == [
        ("link_degraded", 3)]
    assert lm.record(4)["worst_link"] == "ici:0-1"


# ---------------------------------------------------------------- ledger

_MANIFESTS = [
    {"compression": "gtopk", "nworkers": 4, "num_params": 272_474,
     "density": 0.001, "wire_codec": "fp32"},
    {"compression": "gtopk", "nworkers": 3, "num_params": 272_474,
     "density": 0.001, "wire_codec": "int8",
     "comm_plan_schedule": "tree"},
    {"compression": "gtopk", "nworkers": 4, "num_params": 100_000,
     "density": 0.01, "wire_codec": "fp32",
     "comm_plan_schedule": "balanced"},
    {"compression": "dense", "nworkers": 4, "num_params": 50_000},
    {"compression": "allgather", "nworkers": 5, "num_params": 80_000,
     "density": 0.01},
    {"compression": "gtopk_layerwise", "nworkers": 2, "num_params": 9_000,
     "density": 0.01, "buckets": "2", "bucket_sizes": [4_000, 5_000],
     "bucket_ks": [40, 50]},
]


@pytest.mark.parametrize("man", _MANIFESTS)
def test_ledger_as_jax(man):
    rng = np.random.default_rng(man["nworkers"])
    records = [{"kind": "manifest", **man}]
    for step in range(1, 6):
        for rank in range(2):
            records.append({"kind": "attr", "rank": rank, "step": step,
                            "t_comm_us": float(rng.uniform(10, 900)),
                            "n_steps": int(rng.integers(1, 3))})
            records.append({"kind": "obs", "rank": rank, "step": step,
                            "wire_bytes": float(rng.uniform(1e3, 1e5))})
    kw = dict(alpha_ms=ALPHA_MS, beta_gbps=BETA_GBPS, ici_gbps=ICI_GBPS,
              ici_size=1)
    got = ledger.ledger_rows(records, **kw)
    want = jax_ledger.ledger_rows(records, **kw)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g.pop("fit_source") == "arg"
        w.pop("fit_source")
        assert g == w
    assert ledger.summarize_ledger(got) == jax_ledger.summarize_ledger(want)


def test_ledger_fit_precedence(tmp_path):
    """A calib_fit in the out dir first (the largest P by number), then
    the committed card fit for the backend; none for an unknown one."""
    assert ledger.load_alpha_beta(str(tmp_path))["source"] == \
        "comm_fit.json"
    assert ledger.load_alpha_beta(backend="nccl")["source"] == \
        "comm_fit_nccl.json"
    assert ledger.load_alpha_beta(backend="mpi") is None
    for p, beta in ((8, 3.0), (16, 4.0)):
        with open(tmp_path / f"calib_fit_{p}proc.json", "w") as fh:
            json.dump({"alpha_beta_fit": {"alpha_ms": 0.1,
                                          "beta_gbps": beta}}, fh)
    assert ledger.load_alpha_beta(str(tmp_path))["beta_gbps"] == 4.0
    assert ledger.load_alpha_beta(str(tmp_path), nprocs=8)["beta_gbps"] \
        == 3.0
    assert ledger.ledger_rows([{"kind": "manifest", **_MANIFESTS[0]}],
                              backend="mpi") == []
    # The explicit loader (--comm-model-fit): the committed file as the
    # planner reads it; a file without a usable fit, or none, refused.
    from gtopkssgd_tpu_torch.parallel import comm_model

    path = comm_model.committed_fit("gloo")
    assert calib.load_fit_file(path) == comm_model.load_fit(path)
    with open(tmp_path / "bad.json", "w") as fh:
        json.dump({"alpha_beta_fit": {"alpha_ms": 1.0}}, fh)
    for bad in (tmp_path / "bad.json", tmp_path / "none.json"):
        with pytest.raises(ValueError):
            calib.load_fit_file(str(bad))


# -------------------------------------------------------------- memwatch

def test_recompile_storm_fires_through_the_memwatch(tmp_path):
    """An injected reshape at step 3 is a new batch shape: a second
    "compile" record, a recompile record, and recompile_storm."""
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             obs_mem=True, inject="reshape@3",
                             **SMALL)) as t:
        t.train(4)
    recs = _records(tmp_path / "metrics.jsonl")
    comp = [r for r in recs if r["kind"] == "compile"]
    assert [(r.get("event"), r["step"]) for r in comp] == [
        (None, 1), (None, 3), ("recompile", 3)]
    assert comp[1]["shape_key"].startswith("2x32x32x3")
    assert [(r["rule"], r["step"]) for r in recs
            if r["kind"] == "event"] == [("recompile_storm", 3)]


def test_memory_rules_fire_through_the_memwatch(monkeypatch):
    """Live bytes that grow three windows running fire device_mem_leak
    (real tensors, counted on the CPU); a card whose reserved memory
    passes the headroom fraction fires hbm_headroom."""
    import torch

    mon = AnomalyMonitor(thresholds=Thresholds(mem_leak_windows=3))
    mw = memwatch.MemWatch(monitor=mon, mem_interval=1)
    held = []
    for step in range(1, 5):
        held.append(torch.ones(4 << 20))
        mw.sample(step)
    assert [(e["rule"], e["step"]) for e in mon.events] == [
        ("device_mem_leak", 4)]
    card = iter([30e9, 70e9, 78e9])
    monkeypatch.setattr(memwatch, "live_memory_summary", lambda device: {
        "live_bytes": 1e9, "bytes_in_use": next(card),
        "bytes_limit": 80e9})
    mon = AnomalyMonitor()
    mw = memwatch.MemWatch(monitor=mon, mem_interval=1, device="cuda")
    recs = [mw.sample(step) for step in (1, 2, 3)]
    assert [r["headroom_frac"] for r in recs] == [0.375, 0.875, 0.975]
    assert [(e["rule"], e["step"]) for e in mon.events] == [
        ("hbm_headroom", 3)]
    assert memwatch.batch_shape_key(
        [{"image": torch.zeros(2, 3, dtype=torch.uint8)}]) == "2x3:uint8"


def test_timeline_lanes_as_jax():
    """The rebuilt timeline's critpath stage lanes (the cross-rank chain
    flagged), link lanes and goodput/badput tracks equal the JAX
    package's on the same records, and validate."""
    from gtopkssgd_tpu.obs import timeline as jax_timeline
    from gtopkssgd_tpu_torch.obs import goodput
    from gtopkssgd_tpu_torch.obs.timeline import (
        timeline_from_records,
        validate_timeline,
    )

    rng = np.random.default_rng(9)
    recs = []
    for step in (2, 4):
        for rank in range(2):
            iv = _class_intervals(rng, n=4)
            rec = critpath.build_record(critpath.stage_segments(iv, 90.0),
                                        step=step)
            recs.append({"kind": "critpath", "rank": rank,
                         "time": 100.0 + step, **rec})
    lm = linkmap.LinkMap("gtopk", 4, rank=1, alpha_ms=ALPHA_MS,
                         beta_gbps=BETA_GBPS, ici_gbps=ICI_GBPS)
    recs.append({"kind": "linkmap", "rank": 1, "time": 104.5,
                 **lm.observe(4, t_comm_ms=3.0, wire_bytes=2e5)})
    recs.append({"kind": "goodput", "time": 105.0,
                 **goodput.decomposition({"goodput": 2.0, "select": 0.5,
                                          "wait": 0.25}, 3.0, step=4)})
    recs.append({"kind": "event", "time": 105.5, "rule": "nan_loss",
                 "severity": "error", "step": 4, "value": None})
    doc = timeline_from_records(recs)
    assert doc == jax_timeline.timeline_from_records(recs)
    assert validate_timeline(doc) == []
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    assert {"critpath rank 0", "critpath rank 1"} <= lanes
    assert any(name.startswith("link dcn:") for name in lanes)
    assert {"goodput", "badput_s"} <= {e["name"] for e in doc["traceEvents"]
                                       if e.get("ph") == "C"}
