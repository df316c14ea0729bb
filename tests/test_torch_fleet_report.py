"""The port's planes that read beyond one run (``gtopkssgd_tpu_torch.obs``:
``fleet``, ``registry``, ``report``; ``resilience.elastic.
eviction_decision``) against the JAX package's, on the CPU, and the
eviction, the forecast and the registry through the trainer at P = 2.

Inputs: the committed fixtures ``tests/fixtures/fleet``, ``critpath``,
``goodput``, ``linkmap`` and ``forecast`` (read as data), and a 2-rank run
of every record kind made from a numpy seed (``_synthetic_run``).
Tolerances: both sides do the same host arithmetic in the same order, so
everything is compared EXACTLY -- the fleet merge (rows, stragglers, the
``straggler_persistent`` events, the critical-path join, goodput by
rank), the eviction decision, the registry's summaries, history rows and
regress verdicts, and each ``report`` subcommand's ``--json`` output and
exit code -- apart from what the port's records hold by design:

* ``compile`` and ``mem``: the port's memory watch writes no XLA cost
  analysis, so its summaries are the JAX ones without those fields;
* ``plan``: the port's "bucket" record is the bucket plan's manifest;
* ``ledger``: the constants are passed on the command line, which the
  JAX ledger labels "defaults" and the port "arg";
* the registry's ``peak_hbm_bytes``: the port reads it from its
  "compile" records (its manifest is written before any step).
"""

import json
import os
import shutil

import numpy as np
import pytest

import test_torch_rank_programs as programs
from gtopkssgd_tpu.obs import fleet as jax_fleet
from gtopkssgd_tpu.obs import registry as jax_registry
from gtopkssgd_tpu.obs import report as jax_report
from gtopkssgd_tpu.resilience import elastic as jax_elastic
from gtopkssgd_tpu_torch.obs import fleet, registry, report
from gtopkssgd_tpu_torch.obs.events import AnomalyHalt, AnomalyMonitor
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.resilience.elastic import eviction_decision
from test_torch_trace_planes import _CORE, _render, _synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = {name: os.path.join(REPO, "tests", "fixtures", name)
       for name in ("fleet", "critpath", "goodput", "linkmap", "forecast")}


def _synthetic_run(root, seed, ranks=2, steps=8, config_hash="synth01"):
    """A `ranks`-rank out dir of every record kind the report reads, its
    numbers from `seed`; returns the dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    t0 = 1.7e9
    for r in range(ranks):
        recs = [{"kind": "manifest", "time": t0, "rank": r,
                 "config_hash": config_hash, "git_sha": "abc", "dnn":
                 "resnet20", "dataset": "cifar10", "compression": "gtopk",
                 "density": 0.001, "wire_codec": "fp32", "nworkers": ranks,
                 "num_params": 272474, "batch_size": 4, "seed": seed,
                 "backend": "gloo", "comm_plan_schedule": "tree",
                 "pipeline": "serial"}]
        if r == 0:
            recs.append({"kind": "plan", "time": t0, "rank": r,
                         "plan": "tree", "schedule": "tree", "wire_mode":
                         "gtopk", "mode": "gtopk", "pin": "auto", "p": ranks,
                         "n": 272474, "k": 273, "codec": "fp32",
                         "alpha_ms": 0.5, "beta_gbps": 4.0,
                         "ici_gbps": 4.0, "fit_source": "comm_fit.json",
                         "candidates": [
                             {"name": "tree", "schedule": "tree",
                              "comm_ms": 1.2, "wire_bytes": 2184.0,
                              "span_serial_ms": 3.0,
                              "span_overlap_ms": 2.5},
                             {"name": "balanced", "schedule": "balanced",
                              "comm_ms": 1.9, "wire_bytes": 3276.0,
                              "span_serial_ms": 3.7,
                              "span_overlap_ms": 3.1}]})
        t = t0 + 2.0 + 0.01 * r
        for s in range(1, steps + 1):
            t += float(rng.uniform(0.05, 0.15)) + (0.05 if r == 1 else 0.0)
            loss = float(2.5 - 0.1 * s + rng.normal(0, 0.01))
            recs.append({"kind": "obs", "time": t, "rank": r, "step": s,
                         "loss": loss, "achieved_density": 0.001,
                         "wire_bytes": 2184.0, "grad_norm_pre":
                         float(rng.uniform(1, 2)),
                         "audit_recall": float(rng.uniform(0.9, 1.0))})
            for name in ("conv1", "fc"):
                recs.append({"kind": "layers", "time": t, "rank": r,
                             "step": s, "layer": name,
                             "density": float(rng.uniform(0, 0.01)),
                             "tau": float(rng.uniform(0, 1)),
                             "residual_norm": float(rng.uniform(0, 3))})
            recs.append({"kind": "train", "time": t, "rank": r, "step": s,
                         "epoch": 0, "loss": loss, "throughput":
                         float(rng.uniform(30, 40)),
                         "top1": float(rng.uniform(0, 1))})
            recs.append({"kind": "spans", "time": t, "rank": r, "step": s,
                         "dispatch": float(rng.uniform(0.05, 0.1))})
            if s % 2 == 0:
                tc, ts, tm = (float(x) for x in rng.uniform(1e3, 9e4, 3))
                recs.append({"kind": "attr", "time": t, "rank": r,
                             "step": s, "n_steps": 2, "mode": "gtopk",
                             "source": "spans", "t_compute_us": tc,
                             "t_select_us": ts, "t_comm_us": tm,
                             "t_total_us": tc + ts + tm,
                             "overlap_frac": float(rng.uniform(0, 0.1))})
                recs.append({"kind": "critpath", "time": t, "rank": r,
                             "step": s, "wall_us": tc + ts + tm,
                             "t_compute_us": tc, "t_select_us": ts,
                             "t_comm_us": tm, "wait_frac":
                             float(rng.uniform(0, 0.3)),
                             "crit_stage": "compute", "segments": [
                                 {"stage": "compute", "t0_us": 0.0,
                                  "t1_us": tc},
                                 {"stage": "select", "t0_us": tc,
                                  "t1_us": tc + ts},
                                 {"stage": "comm", "t0_us": tc + ts,
                                  "t1_us": tc + ts + tm}]})
                g = float(rng.uniform(0.3, 0.9)) * (0.4 if r == 1 else 1.0)
                wall = t - t0
                recs.append({"kind": "goodput", "time": t, "rank": r,
                             "step": s, "goodput_s": g * wall,
                             "wait_s": (1 - g) * wall * 0.5,
                             "startup_s": (1 - g) * wall * 0.5,
                             "wall_s": wall, "other_s": 0.0,
                             "goodput_frac": g, "other_frac": 0.0,
                             "final": int(s == steps)})
            if s == 4:
                recs.append({"kind": "calib", "time": t, "rank": r,
                             "step": s, "alpha_fit_ms": 0.6,
                             "beta_fit_gbps": 4.0, "resid_ms": 0.05,
                             "alpha_ms.dcn": 0.6, "beta_gbps.dcn": 4.0})
                recs.append({"kind": "event", "time": t, "rank": r,
                             "step": s, "rule": "loss_spike",
                             "severity": "warn", "value": 3.1,
                             "threshold": 3.0, "message": "spike",
                             "claimed": r == 0})
                recs.append({"kind": "inject", "time": t, "rank": r,
                             "step": s, "fault": "nan_grad"})
                recs.append({"kind": "recovery", "time": t, "rank": r,
                             "step": s, "action": "skip",
                             "rule": "loss_spike"})
            if s in (1, 5):
                recs.append({"kind": "compile", "time": t, "rank": r,
                             "step": s, "shape_key": f"4x32x32x3:u8#{s}",
                             "shape_index": s // 5, "compile_s": 0.4,
                             "flops": 1.2e9, "peak_hbm_bytes":
                             int(rng.integers(1e8, 2e8))})
            if s % 3 == 0:
                recs.append({"kind": "mem", "time": t, "rank": r,
                             "step": s, "live_bytes": 1000 * s,
                             "live_count": 10 + s, "peak_bytes_in_use":
                             2000 * s, "bytes_in_use": 4000,
                             "bytes_limit": 80000, "headroom_frac": 0.05,
                             "live_bytes_float32": 800 * s,
                             "recompile_count": 0})
        recs.append({"kind": "recovery", "time": t, "rank": r,
                     "step": steps, "action": "summary",
                     "final_status": "completed", "n_recoveries": 1})
        name = f"metrics.rank{r}.jsonl"
        with open(os.path.join(root, name), "w") as fh:
            for rec in recs:
                fh.write(json.dumps(rec) + "\n")
    return str(root)


# ------------------------------------------------------------------ fleet

@pytest.mark.parametrize("name", ["fleet", "critpath", "goodput",
                                  "linkmap"])
def test_fleet_merge_as_jax(name):
    got = fleet.merge([FIX[name]])
    want = jax_fleet.merge([FIX[name]])
    assert got == want
    if name == "fleet":
        # Rank 2 late at every step: persistent from the third merged step.
        assert [(s["step"], s["slowest_rank"], s["persistent"])
                for s in got["stragglers"]] == [
            (1.0, 2, False), (2.0, 2, False), (3.0, 2, True),
            (4.0, 2, True)]
        assert [(e["rule"], e["step"], e["rank_behind"])
                for e in got["events"]] == [
            ("straggler_persistent", 3.0, 2),
            ("straggler_persistent", 4.0, 2)]


def test_fleet_merge_of_a_synthetic_run_and_halt(tmp_path):
    d = _synthetic_run(tmp_path / "run", 0)
    assert fleet.merge([d]) == jax_fleet.merge([d])
    # --obs-halt-on warn halts on the persistent straggler, as in JAX.
    with pytest.raises(AnomalyHalt) as e:
        fleet.merge([FIX["fleet"]], monitor=AnomalyMonitor(halt_on="warn"))
    assert e.value.event["rule"] == "straggler_persistent"
    other = _synthetic_run(tmp_path / "other", 0, config_hash="other")
    shutil.copy(os.path.join(other, "metrics.rank1.jsonl"),
                os.path.join(d, "metrics.rank1.jsonl"))
    with pytest.raises(ValueError, match="config_hash mismatch"):
        fleet.merge([d])


# --------------------------------------------------------------- eviction

def test_eviction_decision_as_jax(tmp_path):
    """The goodput fixture's outlier; the min_fleet refusal; a healthy
    fleet: the same decisions as the JAX function."""
    got = fleet.merge([FIX["goodput"]])
    want = jax_fleet.merge([FIX["goodput"]])
    for p, min_fleet in ((3, 1), (3, 2), (3, 3), (2, 2)):
        assert eviction_decision(got, p=p, min_fleet=min_fleet) == \
            jax_elastic.eviction_decision(want, p=p, min_fleet=min_fleet)
    decision = eviction_decision(got, p=3)
    assert decision["rank"] == 2 and decision["new_p"] == 2
    assert eviction_decision(got, p=3, min_fleet=3) is None
    d = tmp_path / "healthy"
    d.mkdir()
    for r, frac in enumerate((0.8, 0.75, 0.72)):
        (d / f"metrics.rank{r}.jsonl").write_text(
            json.dumps(_goodput_rec(r, 4, frac, 4.0)) + "\n")
    assert eviction_decision(fleet.merge([str(d)]), p=3) is None
    assert jax_elastic.eviction_decision(jax_fleet.merge([str(d)]),
                                         p=3) is None


def _goodput_rec(rank, step, frac, wall):
    return {"kind": "goodput", "time": 1.7e9 + wall, "rank": rank,
            "step": step, "goodput_s": frac * wall,
            "wait_s": (1 - frac) * wall, "wall_s": wall, "other_s": 0.0,
            "goodput_frac": frac, "other_frac": 0.0, "final": 0}


@pytest.mark.parametrize("written", [(), (0,), (1,), (0, 1)])
def test_eviction_reads_what_the_last_boundary_made_durable(tmp_path,
                                                            written):
    """Rank 0 decides at the boundary of step 6 on the records of steps
    up to 5 (``merge(through_step=5)``): whichever ranks have already
    written step 6's "goodput" record (here rank 1's would clear it), the
    decision is the same, rank 1 evicted on its step-4 record."""
    d = tmp_path / "run"
    d.mkdir()
    for r in (0, 1):
        recs = [{"kind": "manifest", "time": 1.7e9, "rank": r,
                 "config_hash": "h", "nworkers": 2},
                _goodput_rec(r, 4, 0.8 if r == 0 else 0.3, 4.0)]
        if r in written:
            recs.append(_goodput_rec(r, 6, 0.8, 6.0))
        with open(d / f"metrics.rank{r}.jsonl", "w") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in recs))
    decision = eviction_decision(fleet.merge([str(d)], through_step=5),
                                 p=2)
    assert decision["rank"] == 1 and decision["new_p"] == 1
    unfiltered = eviction_decision(fleet.merge([str(d)]), p=2)
    assert (unfiltered is None) == (1 in written)


# --------------------------------------------------------------- registry

def test_registry_summary_history_regress_as_jax(tmp_path):
    dirs = [_synthetic_run(tmp_path / f"r{i}", i) for i in range(3)]
    dirs += [FIX["forecast"], FIX["goodput"], FIX["fleet"]]
    got, want = [], []
    for d in dirs:
        recs, _ = report.load_records(d)
        entry = registry.run_summary(recs)
        jax_entry = jax_registry.run_summary(recs)
        # The card's peak from the port's "compile" records.
        peaks = [r["peak_hbm_bytes"] for r in recs
                 if r["kind"] == "compile" and "peak_hbm_bytes" in r]
        assert entry["stats"].pop("peak_hbm_bytes", None) == (
            max(peaks) if peaks else None)
        assert entry == jax_entry
        # A manifest that carries the peak wins, as in JAX.
        recs[0] = dict(recs[0], peak_hbm_bytes=123)
        assert registry.run_summary(recs) == jax_registry.run_summary(recs)
        got.append(registry.run_summary(recs))
        want.append(jax_registry.run_summary(recs))
    for i, e in enumerate(got):
        registry.append_run(str(tmp_path / "reg"), e)
        jax_registry.append_run(str(tmp_path / "jreg"), want[i])
    entries, bad = registry.load_registry(str(tmp_path / "reg"))
    assert bad == 0 and entries == jax_registry.load_registry(
        str(tmp_path / "jreg"))[0]
    for h in (None, "synth01", "nope"):
        assert registry.history_rows(entries, config_hash=h) == \
            jax_registry.history_rows(entries, config_hash=h)
    for cur in entries:
        for base in entries:
            assert registry.regress(cur, base) == \
                jax_registry.regress(cur, base)
        for mismatch in (False, True):
            assert registry.pick_baseline(cur, entries[:2],
                                          allow_mismatch=mismatch) == \
                jax_registry.pick_baseline(cur, entries[:2],
                                           allow_mismatch=mismatch)
    # A regression: throughput down by half under the same config.
    slow = json.loads(json.dumps(entries[0]))
    slow["stats"]["steps_per_sec"] /= 2
    rows, failures = registry.regress(slow, entries[0])
    assert failures == 1 and ["FAIL"] == [r[-1] for r in rows
                                          if r[0] == "steps_per_sec"]


# ----------------------------------------------------------------- report

def _run_both(tmp_path, argv, json_flag="--json"):
    """(port rc, port JSON, JAX rc, JAX JSON) of one subcommand."""
    out = []
    for name, main in (("port", report.main), ("jax", jax_report.main)):
        path = tmp_path / f"{name}.json"
        args = list(argv) + ([json_flag, str(path)] if json_flag else [])
        rc = main(args)
        out += [rc, json.load(open(path)) if path.exists() else None]
    return out


def _without(doc, keys):
    if isinstance(doc, dict):
        return {k: _without(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [_without(v, keys) for v in doc]
    return doc


# Subcommands whose JSON the port holds byte for byte to JAX's.
_EXACT = (("summary", []), ("events", ["events"]),
          ("recovery", ["recovery"]), ("fleet", ["fleet"]),
          ("critpath", ["critpath"]), ("goodput", ["goodput", "--advise"]),
          ("linkmap", ["linkmap"]), ("attr", ["attr"]))
# What the JAX summaries hold that the port's records cannot.
_XLA_FIELDS = {"bytes_accessed", "temp_bytes", "argument_bytes",
               "output_bytes", "generated_code_bytes", "lower_s",
               "total_lower_s", "manifest_peak_hbm_bytes",
               "devices_reporting"}


@pytest.mark.parametrize("target", ["synthetic", "fleet", "critpath",
                                    "goodput", "linkmap", "forecast"])
def test_report_subcommands_as_jax(tmp_path, target, capsys):
    d = (_synthetic_run(tmp_path / "run", 5) if target == "synthetic"
         else FIX[target])
    for sub, head in _EXACT:
        rc, got, want_rc, want = _run_both(tmp_path, head + [d])
        assert rc == want_rc and got == want, sub
    # Two runs: the compare; goodput against another run.
    other = _synthetic_run(tmp_path / "other", 6)
    rc, got, want_rc, want = _run_both(tmp_path, [d, other])
    assert rc == want_rc == 0 and got == want
    rc, got, want_rc, want = _run_both(
        tmp_path, ["goodput", d, "--compare", other])
    assert rc == want_rc and got == want
    # compile and mem: JAX's summaries without the XLA-only fields (the
    # JAX CLI's tables cannot print records that leave those out).
    records, _ = report.load_records(d)
    assert report.summarize_compile(records) == _without(
        jax_report.summarize_compile(records), _XLA_FIELDS)
    assert report.summarize_mem(records) == _without(
        jax_report.summarize_mem(records), _XLA_FIELDS)
    for sub, key in (("compile", "shapes"), ("mem", "mem")):
        assert report.main([sub, d, "--json",
                            str(tmp_path / f"{sub}.json")]) == 0
        assert key in json.load(open(tmp_path / f"{sub}.json"))
    # plan: the decisions as JAX's; the buckets the port's own shape.
    rc, got, want_rc, want = _run_both(tmp_path, ["plan", d])
    assert rc == want_rc and (got or {}).get("decisions") == \
        (want or {}).get("decisions")
    # ledger at the same made-up constants.
    rc, got, want_rc, want = _run_both(
        tmp_path, ["ledger", d, "--alpha-ms", "0.5", "--beta-gbps", "10"])
    assert rc == want_rc and _without(got, {"fit_source"}) == \
        _without(want, {"fit_source"})
    # timeline: the same Chrome trace.
    rcs = [main(["timeline", d, "--out", str(tmp_path / f"{n}.tl.json")])
           for n, main in (("port", report.main), ("jax", jax_report.main))]
    assert rcs[0] == rcs[1] == 0
    assert json.load(open(tmp_path / "port.tl.json")) == json.load(
        open(tmp_path / "jax.tl.json"))
    # gate: the same verdict and the same re-stamped baseline.
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"checks": [
        {"kind": "obs", "field": "wire_bytes", "stat": "mean",
         "expect": 2184.0, "rtol": 0.01},
        {"kind": "train", "field": "loss", "stat": "last", "expect": 0.0,
         "atol": 0.5}], "manifest": {"compression": "gtopk"}}))
    rcs = [main(["gate", d, "--baseline", str(base), "--write",
                 str(tmp_path / f"{n}.base.json")])
           for n, main in (("port", report.main), ("jax", jax_report.main))]
    assert rcs[0] == rcs[1]
    assert json.load(open(tmp_path / "port.base.json")) == json.load(
        open(tmp_path / "jax.base.json"))
    capsys.readouterr()


def test_report_registry_forecast_watch_and_trace_attr(tmp_path, capsys):
    """history and regress as JAX's (0 pass, 1 regression, 2 no
    baseline); forecast on a run with a calib record; watch bounded by
    --iterations; attr straight from a torch.profiler-shaped trace."""
    runs = [_synthetic_run(tmp_path / f"r{i}", i) for i in range(2)]
    for mod, reg in ((registry, "reg"), (jax_registry, "jreg")):
        for r in runs:
            recs, _ = report.load_records(r)
            mod.append_run(str(tmp_path / reg), mod.run_summary(recs))
    # Each side reads its own registry; the port's lines carry the card
    # peak from its "compile" records besides.
    peak = {"peak_hbm_bytes"}

    def both(args):
        out = []
        for main, reg in ((report.main, "reg"), (jax_report.main, "jreg")):
            path = tmp_path / f"{reg}.json"
            argv = [a.replace("REG", str(tmp_path / reg)) for a in args]
            rc = main(argv + ["--json", str(path)])
            doc = (_without(json.load(open(path)), peak)
                   if path.exists() else None)
            if doc and "failures" in doc:  # the verdict without the peak
                doc["failures"] = registry.regress(doc["current"],
                                                   doc["baseline"])[1]
            out += [rc, doc]
            if path.exists():
                path.unlink()
        return out

    rc, got, want_rc, want = both(["history", "REG"])
    assert rc == want_rc == 0 and got == want
    for run, flags in ((runs[1], []), (runs[0], []),
                       (FIX["fleet"], []), (FIX["fleet"],
                                            ["--allow-mismatch"])):
        rc, got, want_rc, want = both(["regress", run, "--registry",
                                       "REG"] + flags)
        assert rc == want_rc and got == want, (run, flags)
    reg = str(tmp_path / "reg")
    assert report.main(["regress", runs[0], "--registry",
                        str(tmp_path / "none")]) == 2
    assert report.main(["history", str(tmp_path / "none")]) == 1
    # forecast: the calib record's fit (beta 4) on both sides.
    import gtopkssgd_tpu.obs.forecast as jax_forecast
    old = jax_forecast.DEFAULT_ICI_GBPS
    jax_forecast.DEFAULT_ICI_GBPS = 4.0
    try:
        rc, got, want_rc, want = _run_both(tmp_path, ["forecast", runs[0]])
    finally:
        jax_forecast.DEFAULT_ICI_GBPS = old
    assert rc == want_rc == 0 and got == want
    assert got["fit"]["fit_source"] == "calib-record"
    # watch: one poll of each rank, then exit 0.
    assert report.main(["watch", runs[0], "--iterations", "1",
                        "--interval", "0"]) == 0
    out = capsys.readouterr().out
    assert "rank 0" in out and "rank 1" in out and "records=" in out
    # attr on a trace: the port parses its own lanes as JAX parses its.
    ops, spans = _synthetic(1, ("compute", "select", "comm"))
    for which in ("port", "jax"):
        (tmp_path / f"{which}.trace.json").write_text(
            json.dumps(_render(which, ops, spans)))
    rcs = []
    for which, main in (("port", report.main), ("jax", jax_report.main)):
        rcs.append(main(["attr", str(tmp_path / f"{which}.trace.json"),
                         "--json", str(tmp_path / f"{which}.attr.json")]))
    got = json.load(open(tmp_path / "port.attr.json"))
    want = json.load(open(tmp_path / "jax.attr.json"))
    assert rcs == [0, 0]
    assert {k: got[k] for k in _CORE} == {k: want[k] for k in _CORE}
    # Usage errors exit 2, as in JAX.
    assert report.main(["a", "b", "c"]) == 2
    assert report.main(["fleet", str(tmp_path / "missing")]) == 2


# ------------------------------------------------- the trainer, P = 2

def test_p2_eviction_through_the_trainer(tmp_path):
    """Two gloo ranks under --elastic, rank 1 slowed by an injected
    sleep (goodput "wait"), rank 0's check every goodput window (2
    steps), a registry: both ranks exit 46 at the same step with rank 1
    evicted, through the one boundary all-reduce; the lineage says P = 1;
    the registry line is written on the exit-46 path; ``report goodput
    --advise`` names rank 1."""
    out_dir, reg = str(tmp_path / "run"), str(tmp_path / "reg")
    cfg = dict(dnn="resnet20", batch_size=4, compression="gtopk",
               density=0.01, topk_method="twostage", prefetch=0,
               eval_batches=1, log_interval=1, nworkers=2, elastic=True,
               evict_after_windows=1, obs_goodput_interval=2,
               inject="slow_rank:1:0.3@1-12", registry=reg,
               out_dir=out_dir)
    ranks = spawn(programs.eviction_run, 2, cfg, 12, backend="gloo",
                  device="cpu", timeout=300)
    assert [o["rc"] for o in ranks] == [46, 46]
    assert ranks[0]["step"] == ranks[1]["step"] < 12
    for o in ranks:
        (resize,) = [r for r in o["records"] if r["kind"] == "resize"]
        assert resize["reason"] == "evict" and resize["evicted_ranks"] == [1]
        assert resize["new_p"] == 1 and resize["step"] == o["step"]
    lineage = json.load(open(os.path.join(out_dir, "elastic.json")))
    assert lineage["p"] == 1 and lineage["evicted_ranks"] == [1]
    (entry,), bad = registry.load_registry(reg)
    assert bad == 0 and entry["stats"]["final_status"] == "resized"
    hint = report.main(["goodput", out_dir, "--advise", "--json",
                        str(tmp_path / "gp.json")])
    assert hint == 0
    assert json.load(open(tmp_path / "gp.json"))["advise"]["rank"] == 1
