"""The port's scale-out forecast (``gtopkssgd_tpu_torch.obs.forecast``)
against the JAX package's, on the CPU, and its wiring in the trainer.

Both sides get the same explicit fit, made-up constants with an
``ici_gbps`` (no TPU link constant enters the port): the grid's rows,
the recommendations, the crossover, the hindcast and the offline summary
are compared with the plan strings, wire modes and message counts EXACT
and every ms to rtol 1e-9 (the port prices with ``parallel.comm_model``,
the JAX module with ``benchmarks/scaling_model``: the same formulas). The
committed fixture ``tests/fixtures/forecast`` is read as data; its fit
has no ``ici_gbps``, so there the JAX module's in-slice default is set to
the fit's beta, which is what the port prices the in-slice hop at.

Then what only the port does: a fit without ``ici_gbps`` prices "pod"'s
in-slice hop at its beta; without any fit nothing is forecast (no
record, never 25 or 1600 Gb/s); and the trainer at P = 2 writes one
durable "forecast" record a capture, with the fit it priced with.
"""

import json
import math
import os

import numpy as np
import pytest

import test_torch_rank_programs as programs
from gtopkssgd_tpu.obs import forecast as jax_forecast
from gtopkssgd_tpu.obs import report as jax_report
from gtopkssgd_tpu_torch.obs import forecast, registry, report
from gtopkssgd_tpu_torch.obs.events import AnomalyMonitor
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.utils.metrics import KINDS, MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "forecast")
RTOL = 1e-9

# (mode, codec, bucketed, ici_size) cases the grid is held on.
CASES = [("gtopk", "fp32", False, 1), ("gtopk", "int8", False, 1),
         ("gtopk_layerwise", "fp32", True, 1), ("dense", "fp32", False, 1),
         ("gtopk_hier", "fp32", False, 4)]


def _inputs(seed, mode, codec, bucketed, ici_size):
    """Params, an explicit fit with ici_gbps, and budgets from `seed`."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(100_000, 30_000_000))
    k = n if mode == "dense" else max(1, int(n * 0.001))
    buckets = None
    if bucketed:
        cuts = np.sort(rng.choice(np.arange(1, n), 3, replace=False))
        sizes = np.diff(np.concatenate([[0], cuts, [n]]))
        buckets = tuple((int(s), max(1, int(s) // 1000)) for s in sizes)
    params = {"mode": mode, "p": 4, "n": n, "k": k, "codec": codec,
              "schedule": "tree", "bucketing": "concat",
              "buckets": buckets, "ici_size": ici_size}
    fit = {"alpha_ms": float(rng.uniform(1e-4, 2.0)),
           "beta_gbps": float(rng.uniform(1.0, 50.0)),
           "ici_gbps": float(rng.uniform(50.0, 500.0)),
           "resid_ms": float(rng.uniform(0.0, 0.1)),
           "fit_source": "made-up"}
    budgets = {"compute_ms": float(rng.uniform(1.0, 100.0)),
               "select_ms": float(rng.uniform(0.0, 5.0)),
               "degrade_x": float(rng.uniform(1.0, 2.0))}
    return params, fit, budgets


def _same(got, want, path="row"):
    """Equal, floats to RTOL, everything else exactly."""
    if isinstance(want, float) and isinstance(got, (int, float)):
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=1e-12), \
            (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for key in want:
            _same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_grid_recommend_crossover_as_jax(case):
    for seed in range(3):
        params, fit, b = _inputs(seed, *case)
        rows = forecast.grid_rows(params, fit, **b)
        want = jax_forecast.grid_rows(params, fit, **b)
        _same(rows, want)
        _same(forecast.recommend(rows), jax_forecast.recommend(want))
        for p_max in (64, 1024):
            assert forecast.crossover_p(params, fit, p_max=p_max, **b) \
                == jax_forecast.crossover_p(params, fit, p_max=p_max, **b)


def test_a_fit_without_ici_prices_the_slice_at_its_beta():
    """"pod"'s in-slice hop at the fit's own beta (one link class is
    measured), where the JAX module would take its TPU default."""
    params, fit, b = _inputs(7, "gtopk", "fp32", False, 1)
    no_ici = {key: v for key, v in fit.items() if key != "ici_gbps"}
    at_beta = dict(fit, ici_gbps=fit["beta_gbps"])
    _same(forecast.grid_rows(params, no_ici, **b),
          forecast.grid_rows(params, at_beta, **b))
    _same(forecast.grid_rows(params, no_ici, **b),
          jax_forecast.grid_rows(params, at_beta, **b))
    pod = [r for r in forecast.grid_rows(params, no_ici, **b)
           if r["tree"] == "pod" and r["schedule"] == "tree"]
    flat = [r for r in forecast.grid_rows(params, no_ici, **b)
            if r["tree"] == "flat" and r["schedule"] == "tree"]
    # Fewer messages pay alpha in slices of 16: "pod" is cheaper.
    assert all(p["comm_ms"] < f["comm_ms"] for p, f in zip(pod, flat))


@pytest.mark.parametrize("spd", [1, 2])
def test_hindcast_as_jax(spd):
    rng = np.random.default_rng(spd)
    recs = [{"wall_us": float(w), "t_compute_us": float(c),
             "t_select_us": float(s)}
            for w, c, s in rng.uniform(1e3, 1e5, (6, 3))]
    recs.append({"wall_us": 0.0, "t_compute_us": 1.0})  # skipped
    for comm in (0.0, 0.7, 12.5):
        _same(forecast.hindcast(recs, comm, degrade_x=1.3, spd=spd),
              jax_forecast.hindcast(recs, comm, degrade_x=1.3, spd=spd))
    assert forecast.hindcast([], 1.0) is None


def test_step_forecaster_as_jax():
    """The live forecaster fed the same critpath, calib and linkmap
    records writes the JAX forecaster's "forecast" records."""
    params, fit, _ = _inputs(3, "gtopk", "fp32", False, 1)
    feeds = np.random.default_rng(3).uniform(1e3, 1e5, (4, 3)).tolist()
    outs = []
    for mod in (forecast, jax_forecast):
        fc = mod.StepForecaster(params, baseline=fit)
        recs = []
        for step, (w, c, s) in enumerate(feeds, start=1):
            fc.note_critpath({"wall_us": w, "t_compute_us": c,
                              "t_select_us": s}, spd=2)
            if step == 3:
                fc.note_calib({"alpha_fit_ms": 0.01, "beta_fit_gbps": 3.0,
                               "resid_ms": 0.05})
                fc.note_linkmap({"links": [{"ewma_ms": 1.0},
                                           {"ewma_ms": 3.0}]})
            recs.append(fc.observe(step))
        outs.append(recs)
    _same(outs[0], outs[1])
    assert outs[0][0]["fit_source"] == "made-up"
    assert outs[0][-1]["fit_source"] == "calib"


def test_summarize_fixture_as_jax(monkeypatch):
    """The fixture's offline summary (source "stream", the calib
    record's fit): the JAX module's in-slice default set to the fit's
    beta, the port's summary equals it; and from a live record."""
    recs, bad = report.load_records(FIXTURE)
    assert bad == 0
    monkeypatch.setattr(jax_forecast, "DEFAULT_ICI_GBPS", 8.0)
    got = forecast.summarize_forecast(recs)
    want = jax_forecast.summarize_forecast(recs)
    assert got["source"] == "stream" and got["rows"]
    _same(got, want)
    assert forecast.format_forecast(got) == jax_forecast.format_forecast(
        want)
    live = forecast.StepForecaster(
        {"mode": "gtopk", "p": 4, "n": 1_000_000, "k": 10_000},
        baseline={"alpha_ms": 0.5, "beta_gbps": 8.0, "ici_gbps": 8.0,
                  "fit_source": "made-up"})
    live.note_critpath({"wall_us": 14795.0, "t_compute_us": 1e4,
                        "t_select_us": 2e3})
    rec = dict(live.observe(9), kind="forecast")
    got = forecast.summarize_forecast(recs + [rec])
    want = jax_forecast.summarize_forecast(recs + [rec])
    assert got["source"] == "record"
    _same(got, want)


def test_no_fit_no_forecast(tmp_path):
    """Without a fit nothing is priced: the forecaster writes no record
    and the offline summary says why; no record of the port ever carries
    the TPU links' 25 or 1600 Gb/s."""
    path = tmp_path / "m"
    with MetricsLogger(str(path)) as log:
        fc = forecast.StepForecaster(
            {"mode": "gtopk", "p": 2, "n": 1000, "k": 10}, metrics=log,
            monitor=AnomalyMonitor(metrics=log))
        fc.note_critpath({"wall_us": 5e3, "t_compute_us": 4e3})
        assert fc.observe(1) is None
    assert not any(json.loads(line)["kind"] == "forecast"
                   for line in open(path / "metrics.jsonl"))
    recs, _ = report.load_records(FIXTURE)
    recs = [r for r in recs if r["kind"] != "calib"]
    out = forecast.summarize_forecast(recs, backend="mpi")
    assert out["rows"] == [] and "no comm fit" in out["reason"]
    # The committed card fit for the backend otherwise.
    out = forecast.summarize_forecast(recs, backend="gloo")
    assert out["fit"]["fit_source"] == "comm_fit.json"
    assert out["fit"]["beta_gbps"] not in (25.0, 1600.0)
    src = open(forecast.__file__).read()
    for const in ("1600", "DEFAULT_DCN_GBPS", "DEFAULT_ICI_GBPS"):
        assert const not in src


def test_forecast_kind_is_registered_and_the_report_reads_it(
        tmp_path, capsys, monkeypatch):
    assert {"forecast", "fleet"} <= KINDS
    rc = report.main(["forecast", FIXTURE, "--json",
                      str(tmp_path / "a.json")])
    monkeypatch.setattr(jax_forecast, "DEFAULT_ICI_GBPS", 8.0)
    want_rc = jax_report.main(["forecast", FIXTURE, "--json",
                               str(tmp_path / "b.json")])
    assert rc == want_rc == 0
    _same(json.load(open(tmp_path / "a.json")),
          json.load(open(tmp_path / "b.json")))
    assert "recommendation P=256" in capsys.readouterr().out


def test_p2_trainer_writes_a_forecast_a_capture(tmp_path):
    """Two gloo ranks with the calibrator, critpath and the forecast at
    step 2: one durable "forecast" record for the capture on each rank,
    priced with the fit committed for gloo, a recommendation at each
    default target; the registry line carries the hindcast and the
    P = 256 recommendation."""
    reg = str(tmp_path / "reg")
    cfg = dict(dnn="resnet20", batch_size=4, compression="gtopk",
               density=0.01, topk_method="twostage", prefetch=0,
               eval_batches=1, log_interval=1, nworkers=2, obs_calib=True,
               obs_critpath=True, obs_calib_interval=2, obs_forecast=True,
               registry=reg)
    out = spawn(programs.trace_plane_run, 2, cfg, str(tmp_path / "run"), 2,
                backend="gloo", device="cpu", timeout=300)
    for o in out:
        recs = o["records"]
        fcs = [r for r in recs if r["kind"] == "forecast"]
        assert [r["step"] for r in fcs] == [2] == [
            r["step"] for r in recs if r["kind"] == "critpath"]
        for r in fcs:
            assert r["fit_source"] == "comm_fit.json"
            assert r["beta_gbps"] not in (25.0, 1600.0)
            assert {"rec_p32", "rec_p256", "rec_p1024"} <= set(r)
            assert r["hindcast_err_x"] >= 1.0 and r["n_obs"] >= 1
            assert {row["p"] for row in r["rows"]} == {32, 256, 1024}
    (entry,), bad = registry.load_registry(reg)
    assert bad == 0 and "hindcast_err_x" in entry["stats"]
    assert entry["stats"]["forecast_rec_p256"] in (
        "tree@flat", "tree@pod", "balanced@flat", "balanced@pod")
