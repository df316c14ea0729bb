"""The port's observability (``gtopkssgd_tpu_torch.obs``) against the JAX
package's, on the CPU at small sizes, inputs from a numpy seed:

* the on-device counters of ``GTopKSGD(telemetry=True)`` against
  ``gtopk_sgd``'s ``state.telemetry`` in every mode, step by step from the
  same parameters and gradients: the counts, tau, the densities, the wire
  model, the collective count, the residual ages and the audit recall
  EXACTLY; the norms and mass ratios (float32 sums in another order than
  XLA's) within 1e-5 relative (2.3e-7 seen);
* the counters replicated on 4 gloo ranks, and against the JAX optimizer
  on a 4-device mesh;
* the Tracer and the stall watchdog (the JAX tests' behaviour), the
  anomaly monitor (the same event records as the JAX monitor on one
  scripted stream), the timeline (valid under ``validate_timeline``), the
  exporter (a scrape over HTTP on an ephemeral localhost port);
* the trainer's records (an "obs" record a step, "layers" records, the
  timeline file), the residual age through a checkpoint and from a JAX
  state;
* the NaN rules of the stage-1 and multisection twins (``ops.cuda_topk``):
  nothing raises, every index in range, the documented winner; and a
  ``twostage`` run with an injected NaN gradient.
"""

import json
import math
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rank_programs as programs
from gtopkssgd_tpu.obs import events as jax_events
from gtopkssgd_tpu.obs import timeline as jax_timeline
from gtopkssgd_tpu.optimizer import gtopk_sgd
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.obs import (
    LAYER_FIELDS,
    RULES,
    TELEMETRY_FIELDS,
    AnomalyHalt,
    AnomalyMonitor,
    MetricsExporter,
    StallWatchdog,
    Thresholds,
    TimelineRecorder,
    Tracer,
    counters,
    timeline_from_records,
    validate_timeline,
)
from gtopkssgd_tpu_torch.ops import cuda_topk, k_for_density, topk
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer
from gtopkssgd_tpu_torch.utils.metrics import KINDS, MetricsLogger

SHAPES = {"b": (7,), "w": (10, 10), "z": (3, 5)}  # jax.tree order
EXACT = ("tau", "sent_elems", "achieved_density", "wire_bytes",
         "collective_count", "audit_recall")
LAYER_EXACT = ("density", "tau", "residual_age")
RTOL = 1e-5

MODES = {
    "dense": dict(compression="dense"),
    "gtopk": dict(compression="gtopk"),
    "gtopk-twostage": dict(compression="gtopk", topk_method="twostage"),
    "gtopk-warmup": dict(compression="gtopk", warmup_dense_steps=2),
    "gtopk-correction": dict(compression="gtopk", momentum_correction=True),
    "allgather": dict(compression="allgather"),
    "gtopk_hier": dict(compression="gtopk_hier"),
    "layerwise-concat": dict(compression="gtopk_layerwise"),
    "layerwise-buckets": dict(compression="gtopk_layerwise", buckets=2),
    "layerwise-leaf": dict(compression="gtopk_layerwise", buckets="leaf"),
}


def _draw(seed: int, steps: int):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _close(a: float, b: float, rtol: float = RTOL) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _run_both(kw, steps=4, layers=True, audit=2, seed=0):
    """The JAX telemetry and the port's vector after each step of the same
    gradients from the same parameters, at P = 1."""
    kw = {"density": 0.05, "topk_method": "exact", **kw}
    params, grads = _draw(seed, steps)
    tx = gtopk_sgd(0.1, axis_name=None, telemetry=True,
                   telemetry_layers=layers, telemetry_audit_interval=audit,
                   **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    pt = [torch.tensor(params[k]) for k in sorted(SHAPES)]
    opt = GTopKSGD(pt, 0.1, telemetry=True, telemetry_layers=layers,
                   telemetry_audit_interval=audit, select_gamma=1.0, **kw)
    update = jax.jit(tx.update)
    out = []
    for g in grads:
        _, st = update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        for p, k in zip(pt, sorted(SHAPES)):
            p.grad = torch.tensor(g[k])
        opt.step()
        out.append((jax.device_get(st.telemetry),
                    opt.state["telemetry"].numpy().copy(),
                    None if not layers else opt.state["age"].numpy().copy()))
    return opt, out


@pytest.mark.parametrize("mode", MODES)
def test_counters_match_jax_in_every_mode(mode):
    """Every step's counters, per layer too, and the residual ages."""
    opt, out = _run_both(MODES[mode])
    nf = len(opt.telemetry_fields)
    for step, (jt, vec, age) in enumerate(out):
        for i, f in enumerate(opt.telemetry_fields):
            want, got = float(jt[f]), float(vec[i])
            if f in EXACT:
                assert got == want, (mode, step, f, got, want)
            else:
                assert _close(got, want), (mode, step, f, got, want)
        rows = counters.layer_rows(vec[nf:], len(SHAPES))
        for f in LAYER_FIELDS:
            want = np.asarray(jt["layers"][f], np.float32)
            got = rows[f].astype(np.float32)
            if f in LAYER_EXACT:
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-30,
                                           err_msg=f)
        jage = jt["age"]
        jage = np.concatenate([np.asarray(a).reshape(-1) for a in (
            jage if isinstance(jage, tuple) else [jage])])
        np.testing.assert_array_equal(age, jage)


def test_counters_without_layers_or_audit_match_jax():
    opt, out = _run_both(MODES["gtopk"], layers=False, audit=0)
    assert opt.telemetry_fields == TELEMETRY_FIELDS
    assert "age" not in opt.state
    for jt, vec, _ in out:
        assert vec.shape == (len(TELEMETRY_FIELDS),)
        for i, f in enumerate(TELEMETRY_FIELDS):
            if f in EXACT:
                assert float(vec[i]) == float(jt[f]), f


def test_recall_audit_runs_on_its_steps_and_carries():
    """count 0 audits (exact threshold selection: recall 1), count 1
    carries it; -1 before the first audit (a warm-up step)."""
    p = torch.nn.Parameter(torch.zeros(200))
    opt = GTopKSGD([p], 0.1, compression="gtopk", density=0.05,
                   topk_method="exact", telemetry=True,
                   telemetry_audit_interval=2, warmup_dense_steps=1)
    assert float(opt.state["telemetry"][-1]) == -1.0
    g = torch.arange(1, 201, dtype=torch.float32) * 1e-3
    recalls = []
    for _ in range(4):
        p.grad = g.clone()
        opt.step()
        recalls.append(float(opt.state["telemetry"][-1]))
    # count 0: warm-up (-1); count 2 audits; 1 and 3 carry.
    assert recalls == [-1.0, -1.0, 1.0, 1.0]


def test_telemetry_flags_validate_as_jax():
    p = [torch.nn.Parameter(torch.zeros(8))]
    for kw in (dict(telemetry_layers=True), dict(telemetry_audit_interval=2),
               dict(telemetry=True, telemetry_audit_interval=-1)):
        with pytest.raises(ValueError):
            gtopk_sgd(0.1, compression="gtopk", axis_name=None, **kw)
        with pytest.raises(ValueError):
            GTopKSGD(p, 0.1, compression="gtopk", **kw)


def test_counter_helpers_as_jax():
    from gtopkssgd_tpu.obs import counters as jc

    vals = np.array([0.0, -0.5, 2.0, 0.0], np.float32)
    keep = np.array([False, True, True, False])
    acc = np.array([9.0, -3.0, 1.0, 9.0], np.float32)
    assert float(counters.selected_tau(torch.tensor(vals))) == float(
        jc.selected_tau(jnp.asarray(vals))) == 0.5
    assert float(counters.sent_count(torch.tensor(vals))) == 2.0
    assert float(counters.keep_tau(torch.tensor(keep), torch.tensor(acc))) \
        == float(jc.keep_tau(jnp.asarray(keep), jnp.asarray(acc))) == 1.0
    assert float(counters.keep_tau(torch.zeros(4, dtype=torch.bool),
                                   torch.tensor(acc))) == 0.0
    assert float(counters.selected_tau(torch.zeros(4))) == 0.0
    assert float(counters.tree_l2(())) == 0.0
    res = {"v": torch.tensor([3.0, 4.0]), "u": torch.tensor([100.0, 1.0])}
    assert float(counters.residual_l2(res)) == 5.0
    hits = np.array([True, False, True, True])
    ev = np.array([2.0, 1.0, 0.0, -1.0], np.float32)
    assert float(counters.topk_recall(torch.tensor(hits), torch.tensor(ev))) \
        == float(jc.topk_recall(jnp.asarray(hits), jnp.asarray(ev)))


P4_LEAVES = (700, 2000, 300)  # 1-D leaves, in jax.tree order a, b, c
# The JAX bucket DP prices with the JAX package's probe fit; so does the
# port's here.
JAX_FIT = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                       "results", "dcn_probe_4proc.json")
P4_CASES = {
    "gtopk": dict(compression="gtopk"),
    "allgather": dict(compression="allgather"),
    "layerwise-int8": dict(compression="gtopk_layerwise",
                           wire_codec="int8"),
    "layerwise-buckets": dict(compression="gtopk_layerwise", buckets=2),
}


@pytest.fixture(scope="module")
def port_at_p4():
    """The counters (layers and audit on) of each P4_CASES case on 4 gloo
    ranks, from one spawn."""
    p, steps = 4, 3
    rng = np.random.default_rng(21)
    leaves0 = [rng.standard_normal(n).astype(np.float32) for n in P4_LEAVES]
    grads = [[rng.standard_normal((p, n)).astype(np.float32)
              for n in P4_LEAVES] for _ in range(steps)]
    base = dict(lr=0.1, density=0.01, topk_method="exact", telemetry=True,
                telemetry_layers=True, telemetry_audit_interval=2,
                select_gamma=1.0, comm_model_fit=JAX_FIT)
    cases = {name: dict(base, **kw) for name, kw in P4_CASES.items()}
    got = spawn(programs.telemetry_cases, p, leaves0, grads, cases,
                backend="gloo", device="cpu", timeout=300)
    return p, leaves0, grads, got


@pytest.mark.parametrize("case", P4_CASES)
def test_counters_replicated_on_every_rank(port_at_p4, case):
    p, _, _, got = port_at_p4
    n = sum(P4_LEAVES)
    for step in range(3):
        vecs = [np.asarray(got[r][case]["steps"][step]["telemetry"])
                for r in range(p)]
        ages = [np.asarray(got[r][case]["steps"][step]["age"])
                for r in range(p)]
        for r in range(1, p):
            np.testing.assert_array_equal(vecs[r], vecs[0])
            np.testing.assert_array_equal(ages[r], ages[0])
        tel = dict(zip(got[0][case]["fields"], vecs[0].tolist()))
        if case == "gtopk":
            k = k_for_density(n, 0.01)
            assert tel["sent_elems"] == k  # the mean of equal counts
            # One merge a step: k pairs a tree round, log2(4) rounds.
            assert tel["wire_bytes"] == 8 * k * 2
        assert tel["collective_count"] == (2.0 if case == "layerwise-buckets"
                                           else 1.0)


@pytest.mark.parametrize("case", P4_CASES)
def test_counters_at_p4_match_the_jax_mesh(port_at_p4, case):
    """The JAX optimizer under shard_map on 4 CPU devices, same inputs:
    the counts, densities, wire and collectives equal; the audit recall,
    a mean of four ranks' float32 recalls summed in another order, within
    1e-6; the rest within 1e-4 (their axis means too)."""
    from functools import partial

    from jax.sharding import Mesh, PartitionSpec as P

    from gtopkssgd_tpu.optimizer import (GTopKSGDState,
                                         expand_residual_per_device)

    p, leaves0, grads, got = port_at_p4
    mesh = Mesh(np.array(jax.devices()[:p]), ("dp",))
    kw = {"density": 0.01, "topk_method": "exact", **P4_CASES[case]}
    tx = gtopk_sgd(0.1, axis_name="dp", telemetry=True,
                   telemetry_layers=True, telemetry_audit_interval=2, **kw)
    keys = "abc"
    params = {k: jnp.asarray(x) for k, x in zip(keys, leaves0)}
    state = expand_residual_per_device(jax.jit(tx.init)(params), p, mesh)
    spec = GTopKSGDState(count=P(), residual=P("dp"), inner=P(),
                         telemetry=P())

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"), spec, P()),
             out_specs=(P(), spec), check_vma=False)
    def step(g, st, prm):
        g = jax.tree.map(lambda x: x[0], g)
        s = st._replace(residual=jax.tree.map(lambda r: r[0],
                                              st.residual))
        upd, s2 = tx.update(g, s, prm)
        return upd, s2._replace(residual=jax.tree.map(
            lambda r: r[None], s2.residual))

    run = jax.jit(step)
    fields = got[0][case]["fields"]
    for i, g in enumerate(grads):
        gt = {k: jnp.asarray(x) for k, x in zip(keys, g)}
        upd, state = run(gt, state, params)
        params = jax.tree.map(lambda a, b: a + b, params, upd)
        jt = jax.device_get(state.telemetry)
        vec = np.asarray(got[0][case]["steps"][i]["telemetry"])
        for j, f in enumerate(fields):
            if f in ("sent_elems", "wire_bytes", "collective_count",
                     "achieved_density"):
                assert float(vec[j]) == float(jt[f]), (case, i, f)
            elif f == "audit_recall":
                assert _close(float(vec[j]), float(jt[f]), 1e-6), (case, i)
            else:
                assert _close(float(vec[j]), float(jt[f]), 1e-4), (
                    case, i, f, float(vec[j]), float(jt[f]))
        rows = counters.layer_rows(vec[len(fields):], len(P4_LEAVES))
        for f in LAYER_FIELDS:
            np.testing.assert_allclose(
                rows[f], np.asarray(jt["layers"][f]), rtol=1e-4,
                atol=1e-30, err_msg=f"{case} {i} {f}")
        jage = jt["age"]
        jage = np.concatenate([np.asarray(a).reshape(-1) for a in (
            jage if isinstance(jage, tuple) else [jage])])
        np.testing.assert_array_equal(
            np.asarray(got[0][case]["steps"][i]["age"]), jage)


# ------------------------------------------------------------- tracing

def test_span_nesting_builds_paths():
    tr = Tracer()
    with tr.span("train"):
        with tr.span("io"):
            pass
        with tr.span("dispatch"):
            pass
    with tr.span("eval"):
        pass
    summary = tr.stats.summary()
    assert set(summary) == {"train", "train/io", "train/dispatch", "eval"}
    assert all(sec >= 0 for sec in summary.values())
    assert tr.current_path == ""


def test_span_nesting_is_per_thread():
    tr = Tracer()
    seen = {}
    release = threading.Event()

    def worker():
        with tr.span("worker_phase"):
            seen["inside"] = tr.current_path
            release.wait(2.0)

    with tr.span("main_phase"):
        t = threading.Thread(target=worker)
        t.start()
        while "inside" not in seen and t.is_alive():
            time.sleep(0.01)
        assert seen["inside"] == "worker_phase"
        release.set()
        t.join()
    assert "main_phase/worker_phase" not in tr.stats.summary()


def test_span_flush_logs_one_record_and_resets(tmp_path):
    with MetricsLogger(str(tmp_path)) as metrics:
        tr = Tracer(metrics=metrics)
        with tr.span("io"):
            pass
        summary = tr.flush(step=7)
        assert "io" in summary
        assert tr.stats.summary() == {}
        assert tr.flush(step=8) == {}
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    spans = [r for r in recs if r["kind"] == "spans"]
    assert len(spans) == 1 and spans[0]["step"] == 7 and "io" in spans[0]
    assert [r["kind"] for r in recs] == ["spans"]


def test_span_opens_a_profiler_range_under_its_own_name():
    """``profile_step`` reads the trainer's ranges by name: a nested span's
    profiler range carries its name, not its path."""
    tr = Tracer()
    with torch.profiler.profile() as prof:
        with tr.span("dispatch"):
            with tr.span("optimizer"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"dispatch", "optimizer"} <= names
    assert "dispatch/optimizer" in tr.stats.summary()


def test_disabled_tracer_and_decorator():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    assert tr.stats.summary() == {}
    tr2 = Tracer()
    with tr2.span("x"):
        pass
    assert set(tr2.stats.summary()) == {"x"}


# ------------------------------------------------------------ watchdog

def test_watchdog_fires_on_stalled_region():
    fired = []
    wd = StallWatchdog(0.15, poll_s=0.03, on_stall=fired.append,
                       diagnostics=lambda: {"phase_means_s": {"io": 1.5}})
    try:
        wd.arm("train_step", step=12)
        wd.heartbeat(step=12)
        deadline = time.monotonic() + 3.0
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.fired
        (rec,) = fired
        assert rec["kind"] == "stall" and rec["label"] == "train_step"
        assert rec["armed_step"] == 12 and rec["last_completed_step"] == 12
        assert rec["waited_s"] >= 0.15
        assert rec["phase_means_s"] == {"io": 1.5}
        assert rec["device"]["backend"] == "cpu"
    finally:
        wd.close()


def test_watchdog_heartbeat_prevents_firing():
    fired = []
    wd = StallWatchdog(0.25, poll_s=0.03, on_stall=fired.append)
    try:
        wd.arm("train", step=0)
        for s in range(8):
            time.sleep(0.05)
            wd.heartbeat(step=s)
        wd.disarm()
        time.sleep(0.3)
        assert not wd.fired and fired == []
    finally:
        wd.close()


def test_watchdog_fires_once_and_validates():
    with pytest.raises(ValueError):
        StallWatchdog(0.0)
    fired = []
    wd = StallWatchdog(0.05, poll_s=0.02, on_stall=fired.append)
    try:
        with wd.watch("region"):
            time.sleep(0.4)
        time.sleep(0.1)
        assert len(fired) == 1
    finally:
        wd.close()


def test_watchdog_diagnostics_failure_is_contained():
    fired = []

    def bad_diag():
        raise RuntimeError("host state gone")

    wd = StallWatchdog(0.05, poll_s=0.02, on_stall=fired.append,
                       diagnostics=bad_diag)
    try:
        wd.arm("x")
        deadline = time.monotonic() + 2.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired and "diagnostics_error" in fired[0]
    finally:
        wd.close()


def test_stall_exits_43_with_a_stall_record(tmp_path):
    """Through the command line: a 6 s straggler at step 3 against a 2 s
    watchdog ends the process with exit 43, after a "stall" record and a
    "stalled" summary, before step 3 completes."""
    import subprocess
    import sys

    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "gtopkssgd_tpu_torch.dist_trainer",
         "--device", "cpu", "--compression", "gtopk", "--topk-method",
         "twostage", "--batch-size", "4", "--num-iters", "5",
         "--eval-batches", "1", "--prefetch", "0", "--out-dir", str(out),
         "--inject", "slow_rank:0:6s@3", "--obs-watchdog", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 43, proc.stderr[-2000:]
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    (stall,) = [r for r in recs if r["kind"] == "stall"]
    # Step 2's heartbeat, or none on a host slow enough to stall before.
    assert stall["last_completed_step"] in (None, 1, 2)
    assert stall["deadline_s"] == 2.0 and stall["waited_s"] >= 2.0
    assert recs[-1]["action"] == "summary"
    assert recs[-1]["final_status"] == "stalled"


# ------------------------------------------------------- anomaly monitor

def test_rules_are_the_jax_rules():
    assert RULES == jax_events.RULES and len(RULES) == 14
    assert Thresholds() == Thresholds(**vars(jax_events.Thresholds()))


def _script():
    """A stream of (step, loss, telemetry, max_age) touching every fed
    rule: warm-up, a spike, a collapse, a blow-up, an age runaway, NaN and
    Inf losses."""
    rng = np.random.default_rng(5)
    out = []
    for step in range(1, 40):
        loss = float(2.0 + 0.05 * rng.standard_normal())
        tel = {"achieved_density": 0.01, "residual_norm": 1.0 + 0.01 * step}
        age = 10.0
        if step == 12:
            loss = 40.0
        if step == 15:
            tel["achieved_density"] = 1e-5
        if step == 20:
            tel["residual_norm"] = 500.0
        if step == 25:
            age = 5e4
        if step == 30:
            loss = float("nan")
        if step == 31:
            loss = float("inf")
        out.append((step, loss, tel, age))
    return out


@pytest.mark.parametrize("halt_on", [None, "warn", "error"])
def test_monitor_gives_the_jax_event_records(halt_on):
    """The same (rule, severity, step, value, threshold) records from the
    port's monitor as from the JAX one, the halt at the same event."""
    def run(cls, halt):
        mon = cls(rho=0.01, halt_on=halt_on)
        got = []
        for step, loss, tel, age in _script():
            try:
                evs = mon.observe(step, loss=loss, telemetry=dict(tel),
                                  max_residual_age=age)
            except halt as e:
                got.append(("halt", e.event["rule"], e.event["step"]))
                break
            got += [(e["rule"], e["severity"], e["step"], e["value"],
                     e["threshold"], e["message"]) for e in evs]
        return got

    want = run(jax_events.AnomalyMonitor, jax_events.AnomalyHalt)
    got = run(AnomalyMonitor, AnomalyHalt)
    assert got == want
    rules = {e[0] for e in got}
    if halt_on is None:
        assert {"nan_loss", "loss_spike", "density_collapse",
                "residual_blowup", "residual_age_runaway"} <= rules


def test_monitor_other_feeds_as_jax():
    """The rules the later planes feed, through their observe_* calls."""
    def run(cls):
        mon = cls(rho=0.01)
        evs = []
        for s in range(6):
            evs += mon.observe_ranks(s, {0: 0.0, 1: 0.5}, step_dur=0.1)
            evs += mon.observe_comm_model(s, 0.1 * (s + 1) ** 3, 10.0,
                                          ref_alpha_ms=0.1,
                                          ref_beta_gbps=10.0)
            evs += mon.observe_compile(s, cache_size=s, grew=True)
            evs += mon.observe_memory(s, live_bytes=100 * s,
                                      bytes_in_use=95, bytes_limit=100)
            evs += mon.observe_critpath(s, crit_stage="wait" if s else
                                        "compute")
            evs += mon.observe_goodput(s, goodput_frac=0.9 if s < 3
                                       else 0.1)
            evs += mon.observe_links(s, {"dp:0-1": 1.0, "dp:1-2": 1.0,
                                         "dp:2-3": 50.0})
            evs += mon.observe_forecast(s, err_x=10.0)
        return [(e["rule"], e["step"], e.get("value")) for e in evs]

    got = run(AnomalyMonitor)
    assert got == run(jax_events.AnomalyMonitor)
    assert {r for r, _, _ in got} == RULES - {
        "nan_loss", "loss_spike", "density_collapse", "residual_blowup",
        "residual_age_runaway"}


def test_monitor_halt_writes_the_record_first(tmp_path):
    with MetricsLogger(str(tmp_path)) as metrics:
        mon = AnomalyMonitor(metrics=metrics, rho=0.01, halt_on="error")
        assert [e["rule"] for e in mon.observe(
            1, loss=1.0, telemetry={"achieved_density": 0.0})] \
            == ["density_collapse"]
        with pytest.raises(AnomalyHalt) as exc:
            mon.observe(2, loss=float("nan"))
        assert exc.value.event["rule"] == "nan_loss"
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["rule"] for r in recs if r["kind"] == "event"] == [
        "density_collapse", "nan_loss"]
    with pytest.raises(ValueError):
        AnomalyMonitor(halt_on="fatal")


def test_metrics_kinds_hold_the_obs_kinds():
    from gtopkssgd_tpu.utils.metrics import KINDS as JAX_KINDS

    obs = {"obs", "layers", "spans", "event", "stall"}
    assert obs <= KINDS and obs <= JAX_KINDS
    assert KINDS <= JAX_KINDS


# ------------------------------------------------- timeline and exporter

def test_timeline_records_and_validates(tmp_path):
    rec = TimelineRecorder(rank=0)
    tr = Tracer(sink=rec.span_sink)
    with tr.span("dispatch"):
        with tr.span("optimizer"):
            pass
    rec.counter("obs", {"achieved_density": 0.01, "tau": float("nan")})
    rec.instant("event:nan_loss", args={"step": 3})
    path = rec.write(str(tmp_path))
    doc = json.load(open(path))
    assert validate_timeline(doc) == []
    assert jax_timeline.validate_timeline(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"dispatch", "dispatch/optimizer", "obs",
            "event:nan_loss"} <= names
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "ts": 5.0},
                           {"ph": "i", "name": "b", "pid": 0, "ts": 1.0}]}
    assert validate_timeline(bad) == jax_timeline.validate_timeline(bad)
    assert len(validate_timeline(bad)) == 2


def test_timeline_from_records_as_jax():
    recs = [{"kind": "train", "time": 1.0, "loss": 2.0, "throughput": 9.0},
            {"kind": "obs", "time": 2.0, "achieved_density": 0.01,
             "residual_norm": 3.0, "grad_norm_post": 1.0, "tau": 0.5},
            {"kind": "event", "time": 3.0, "rule": "nan_loss",
             "severity": "error", "step": 4, "value": None},
            {"kind": "stall", "time": 4.0, "step": 5}]
    assert timeline_from_records(recs) == \
        jax_timeline.timeline_from_records(recs)


def test_exporter_serves_the_latest_values():
    with MetricsExporter(port=0) as ex:
        with MetricsLogger(sink=ex.observe) as metrics:
            metrics.log("obs", step=1, achieved_density=0.5, tau=0.1)
            metrics.log("obs", step=2, achieved_density=0.25, tau=0.2)
            metrics.log("event", rule="nan_loss", value=None, step=2)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ex.port}/metrics", timeout=10).read().decode()
    assert 'gtopk_obs_achieved_density{rank="0"} 0.25' in body
    assert 'gtopk_obs_step{rank="0"} 2' in body
    assert 'gtopk_event_step{rank="0",rule="nan_loss"} 2' in body
    assert body.endswith("# EOF\n")


# --------------------------------------------------------------- trainer

SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", prefetch=0,
             eval_batches=1, device="cpu")


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_trainer_writes_obs_and_layer_records_and_a_timeline(tmp_path):
    out = tmp_path / "run"
    with Trainer(TrainConfig(out_dir=str(out), obs_layers=True,
                             obs_audit_interval=2, log_interval=2,
                             obs_timeline=str(tmp_path),
                             obs_export_port=-1, **SMALL)) as t:
        assert t.exporter is not None and t.exporter.port > 0
        t.train(3)
        names = t.layer_names
    recs = _records(out / "metrics.jsonl")
    obs = [r for r in recs if r["kind"] == "obs"]
    assert [r["step"] for r in obs] == [1, 2, 3]
    for r in obs:
        assert set(TELEMETRY_FIELDS + ("audit_recall",)) <= set(r)
        assert math.isfinite(r["residual_norm"]) and r["sent_elems"] > 0
    assert [r["audit_recall"] for r in obs][0] == 1.0
    layers = [r for r in recs if r["kind"] == "layers"]
    assert len(layers) == 3 * len(names) == 3 * 65
    assert [r["layer"] for r in layers[:len(names)]] == names
    assert set(LAYER_FIELDS) <= set(layers[0])
    assert any(r["kind"] == "spans" for r in recs)
    doc = json.load(open(tmp_path / "timeline.json"))
    assert validate_timeline(doc) == []
    spans = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"data", "dispatch", "dispatch/forward_backward",
            "dispatch/optimizer", "obs_read"} <= spans


def test_obs_interval_and_counters_off(tmp_path):
    with Trainer(TrainConfig(out_dir=str(tmp_path / "a"), obs_interval=2,
                             **SMALL)) as t:
        t.train(4)
    assert [r["step"] for r in _records(tmp_path / "a" / "metrics.jsonl")
            if r["kind"] == "obs"] == [2, 4]
    with Trainer(TrainConfig(out_dir=str(tmp_path / "b"), obs_counters=False,
                             **SMALL)) as t:
        assert not t.optimizer.telemetry and "telemetry" not in \
            t.optimizer.state
        t.train(2)
    assert not [r for r in _records(tmp_path / "b" / "metrics.jsonl")
                if r["kind"] == "obs"]


def test_checkpoints_keep_the_residual_age(tmp_path):
    """The age buffer and the counters (the audit's carried recall) are
    saved and restored in place."""
    cfg = TrainConfig(out_dir=str(tmp_path), obs_layers=True,
                      obs_audit_interval=3, **SMALL)
    with Trainer(cfg) as t:
        t.train(2)
        t.save()
        age = t.optimizer.state["age"].clone()
        vec = t.optimizer.state["telemetry"].clone()
        assert age.max() >= 1
    import dataclasses

    with Trainer(dataclasses.replace(cfg, resume=True)) as r:
        assert r.step == 2
        assert torch.equal(r.optimizer.state["age"], age)
        assert torch.equal(r.optimizer.state["telemetry"], vec)


def test_a_jax_state_carries_its_residual_age():
    """``convert.load_jax_state`` takes the JAX telemetry's age, flat or
    per leaf."""
    from gtopkssgd_tpu_torch.convert import load_jax_state

    with Trainer(TrainConfig(obs_layers=True, **SMALL)) as t:
        n = t.num_params
        sizes = t.layout.sizes
        age = np.arange(n, dtype=np.float32) % 7
        state = {k: v.detach().cpu().numpy() for k, v in
                 t.model.state_dict().items()}
        from gtopkssgd_tpu_torch.convert import flax_path

        params, stats = {}, {}
        for name, value in state.items():
            path = flax_path(name)
            tree = stats if path[-1] in ("mean", "var") else params
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            perm = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}[value.ndim]
            node[path[-1]] = value.transpose(perm)
        load_jax_state(t, params, stats, None, np.zeros(n, np.float32), 0,
                       telemetry={"age": age})
        np.testing.assert_array_equal(t.optimizer.state["age"].numpy(), age)
        leaves = tuple(np.split(age + 1, np.cumsum(sizes)[:-1]))
        load_jax_state(t, params, stats, None, np.zeros(n, np.float32), 0,
                       telemetry={"age": leaves})
        np.testing.assert_array_equal(t.optimizer.state["age"].numpy(),
                                      age + 1)


# ------------------------------------------------------------ NaN rules

def _nan_grad(n, seed=0):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return g


@pytest.mark.parametrize("groups", [1, 8, 64])
def test_stage1_twin_nan_rule(groups):
    """A NaN counts as the largest magnitude: the first NaN row of a
    bucket wins (beating +inf), its NaN is the candidate; every index is
    in range; the counts leave NaN out; nothing raises."""
    from gtopkssgd_tpu_torch.ops.kernel_cases import nan_input

    n = 300_000
    g, r = nan_input(n, groups, seed=3)
    gt, rt = torch.tensor(g), torch.tensor(r)
    thr = torch.tensor([0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0, np.inf])
    vals, idx, cnt = cuda_topk.fused_stage1_candidates_ref(gt, thr, rt,
                                                           groups=groups)
    acc = g + r
    rpg = cuda_topk.BLOCK_ROWS // groups
    nb = -(-n // cuda_topk.BLOCK)
    pad = np.full(nb * cuda_topk.BLOCK, np.nan, np.float32)
    pad[:n] = acc
    mag = np.abs(pad).reshape(nb, groups, rpg, cuda_topk.LANES)
    real = (np.arange(nb * cuda_topk.BLOCK) < n).reshape(mag.shape)
    idx4 = idx.numpy().reshape(nb, groups, cuda_topk.LANES)
    v4 = vals.numpy().reshape(idx4.shape)
    assert ((idx4 >= 0) & (idx4 < nb * cuda_topk.BLOCK)).all()
    for t in range(nb):
        for gr in range(groups):
            m, ok = mag[t, gr], real[t, gr]
            nan = np.isnan(m) & ok
            for lane in range(cuda_topk.LANES):
                col, i = m[:, lane], idx4[t, gr, lane]
                if not ok[:, lane].any():
                    continue
                if nan[:, lane].any():
                    row = int(np.argmax(nan[:, lane]))  # the first NaN
                    assert np.isnan(v4[t, gr, lane])
                else:
                    vals_ok = np.where(ok[:, lane], col, -1.0)
                    row = int(np.argmax(vals_ok))
                    assert v4[t, gr, lane] == pad[i]
                want = t * cuda_topk.BLOCK + (gr * rpg + row) * \
                    cuda_topk.LANES + lane
                assert i == want
    finite = acc[~np.isnan(acc)]
    want_counts = [(np.abs(finite) >= float(x)).sum() for x in thr]
    assert cnt.tolist() == want_counts


def test_stage1_all_nan_and_twostage_selects_the_nans():
    g = torch.full((5000,), float("nan"))
    vals, idx, _ = cuda_topk.fused_stage1_candidates_ref(g, groups=8)
    real = idx < 5000  # buckets holding data; the rest are padding
    assert real.sum() == 128 and torch.isnan(vals[real]).all()
    assert (vals[~real] == 0).all()
    assert int(idx.max()) < cuda_topk.BLOCK and int(idx.min()) >= 0
    v, i = topk.twostage_topk_abs(g, 50)
    assert torch.isnan(v).all() and int(i.max()) < 5000
    tau = topk.select_tau(g, 50, "twostage")
    assert torch.isnan(tau)  # the NaN is the threshold; nothing raises


def test_multisection_twin_nan_rule():
    """A NaN is ignored: the bracket is that of the other elements, the
    counts leave it out; all NaN gives lo 0."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(20_000).astype(np.float32)
    r = (0.3 * rng.standard_normal(20_000)).astype(np.float32)
    nan = rng.random(20_000) < 0.02
    xn = x.copy()
    xn[nan] = np.nan
    k = 100
    acc = torch.tensor(xn) + torch.tensor(r)
    lo, thr, counts = cuda_topk.multisection_tau_lo_ref(
        torch.tensor(xn), k, torch.tensor(r))
    clean = torch.tensor(np.where(nan, 0.0, x + r).astype(np.float32))
    lo_c, thr_c, counts_c = cuda_topk.multisection_tau_lo_ref(clean, k)
    assert torch.equal(lo, lo_c) and torch.equal(thr, thr_c)
    assert torch.equal(counts, counts_c)
    assert (acc.abs() >= lo).sum() >= k
    for method in ("pallas", "threshold"):
        tau = topk.select_tau(torch.tensor(xn), k, method,
                              residual=torch.tensor(r))
        assert torch.isfinite(tau)
        v, i = topk.select_topk(torch.tensor(xn), k, method,
                                residual=torch.tensor(r))
        assert torch.isfinite(v).all() and int(i.max()) < 20_000
    lo0, _, c0 = cuda_topk.multisection_tau_lo_ref(
        torch.full((1000,), float("nan")), 10)
    assert float(lo0) == 0.0 and int(c0.sum()) == 0


def test_twostage_with_an_injected_nan_gradient_runs(tmp_path, capsys):
    """``--inject nan_grad@2`` under ``twostage`` on the CPU: the twin
    takes the NaN bucket maxima; the run finishes and the monitor records
    the NaN loss."""
    out = tmp_path / "run"
    rc = dist_trainer.main([
        "--device", "cpu", "--compression", "gtopk", "--topk-method",
        "twostage", "--batch-size", "4", "--num-iters", "3",
        "--eval-batches", "1", "--prefetch", "0", "--out-dir", str(out),
        "--inject", "nan_grad@2"])
    assert rc == 0
    recs = _records(out / "metrics.jsonl")
    assert [r["step"] for r in recs if r["kind"] == "event"
            and r["rule"] == "nan_loss"][0] == 2
