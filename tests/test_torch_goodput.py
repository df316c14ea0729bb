"""The port's goodput ledger (``gtopkssgd_tpu_torch.obs.goodput``) against
the JAX package's, on the CPU, inputs from a numpy seed:

* ``GoodputLedger`` driven by the same mark sequence under the same fake
  clock writes the same records and feeds the same monitor calls: every
  field exactly (the same float64 in the same order) but ``other_s``,
  within 6e-6 s, since the port takes it from the fields rounded to the
  microsecond so that the record conserves exactly (the JAX record
  rounds it on its own);
* the offline fold (``fold``, ``fold_shards``, ``synthesize``,
  ``fleet_decomposition``, ``advise``, ``category_fracs``,
  ``dominant_badput``, ``conservation_error``, ``format_goodput``) gives
  equal results on the same record streams;
* the ``goodput_collapse`` rule fires through the ledger;
* the trainer's default run (the ledger on, a record every
  ``obs_goodput_interval`` steps and a final one) writes "goodput" records
  at the JAX trainer's steps, in the same sequence of record kinds, each
  conserved to 1e-6.
"""

import json

import numpy as np
import pytest

from gtopkssgd_tpu.obs import goodput as jax_goodput
from gtopkssgd_tpu_torch.obs import goodput
from gtopkssgd_tpu_torch.obs.events import AnomalyMonitor, Thresholds
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer


class _Clock:
    """A clock that returns the next of a fixed list of times."""

    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


class _Log:
    def __init__(self):
        self.records = []

    def log(self, kind, flush=False, **fields):
        self.records.append((kind, fields))


class _Monitor:
    def __init__(self):
        self.calls = []

    def observe_goodput(self, step, goodput_frac=None):
        self.calls.append((step, goodput_frac))


def _same(got, want):
    """Equal, ``other_s`` within 6e-6 s (see the module docstring)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key, v in want.items():
            if key == "other_s":
                assert abs(got[key] - v) <= 6e-6
            else:
                _same(got[key], v)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def _drive(mod, times):
    """One scripted run of mod.GoodputLedger: startup, data, steps with
    stage shares, a degraded stretch, a wasted step, a checkpoint,
    unattributed time, periodic and final records."""
    log, mon = _Log(), _Monitor()
    gp = mod.GoodputLedger(metrics=log, monitor=mon, interval=2,
                           clock=_Clock(times))
    gp.mark("startup")
    gp.mark("compile")
    gp.train_started()
    for step in range(1, 9):
        gp.mark("data")
        if step == 3:
            gp.note_stage_fracs({"t_compute_us": 700.0,
                                 "t_select_us": 200.0,
                                 "t_comm_wire_us": 60.0,
                                 "t_wait_us": 40.0})
        gp.step_mark(begin=True, degraded=step in (5, 6))
        gp.step_mark(degraded=step in (5, 6))
        if step == 7:
            gp.wasted_step()
        if step == 4:
            gp.mark("ckpt")
        gp.mark(None)
        gp.mark("wait")
        gp.tick(step)
    gp.train_started()
    gp.mark("goodput")
    return log.records, mon.calls, gp.log_record(8, final=True)


def test_ledger_writes_the_jax_records_under_the_same_clock():
    rng = np.random.default_rng(0)
    times = list(np.cumsum(rng.uniform(0.001, 0.5, size=200)))
    got = _drive(goodput, times)
    want = _drive(jax_goodput, times)
    _same(got, want)
    records, calls, final = got
    assert [f["step"] for k, f in records if not f["final"]] == [3, 5, 7]
    assert [s for s, _ in calls] == [3, 5, 7]
    assert final["n_wasted_steps"] == 1 and final["wasted_s"] > 0
    assert final["select_s"] > 0 and final["ckpt_s"] > 0
    for _, rec in records:
        assert goodput.conservation_error(rec) <= 1e-12


def _streams(seed):
    """Per-rank record streams: ranks 0-2 with live "goodput" records,
    rank 3 without (folded from manifest/obs/critpath/compile/recovery
    records), rank 4 with nothing usable."""
    rng = np.random.default_rng(seed)
    out = {}
    for rank in range(3):
        recs = [{"kind": "manifest", "time": 0.0}]
        for i in range(3):
            secs = {c: float(rng.uniform(0.0, 3.0))
                    for c in goodput.CATEGORIES}
            wall = sum(secs.values()) + float(rng.uniform(0.0, 1.0))
            recs.append({"kind": "goodput", "time": 1.0 + i, "rank": rank,
                         **goodput.decomposition(secs, wall, step=i,
                                                 final=i == 2)})
        out[rank] = recs
    t = float(rng.uniform(1.0, 3.0))
    recs = [{"kind": "manifest", "time": 0.0}]
    for step in range(1, 7):
        t += float(rng.uniform(0.1, 0.4))
        recs.append({"kind": "obs", "step": step, "time": t})
    recs += [{"kind": "compile", "compile_s": 0.7},
             {"kind": "critpath", "t_compute_us": 800.0,
              "t_select_us": 100.0, "t_comm_wire_us": 80.0,
              "t_wait_us": 20.0},
             {"kind": "recovery", "action": "skip"}]
    out[3] = recs
    out[4] = [{"kind": "manifest", "time": 0.0}]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_synthesize_and_advise_as_jax(seed):
    streams = _streams(seed)
    got = goodput.fold_shards(streams)
    want = jax_goodput.fold_shards(streams)
    _same(got, want)
    assert sorted(got) == [0, 1, 2, 3] and got[3]["source"] == "folded"
    _same(goodput.synthesize(streams[3]),
          jax_goodput.synthesize(streams[3]))
    _same(goodput.fleet_decomposition(got),
          jax_goodput.fleet_decomposition(want))
    for margin in (0.0, 0.05, 0.1, 1.0):
        assert goodput.advise(got, margin) == jax_goodput.advise(want,
                                                                  margin)
    for d in got.values():
        assert goodput.category_fracs(d) == jax_goodput.category_fracs(d)
        assert goodput.dominant_badput(d) == jax_goodput.dominant_badput(d)
        assert goodput.conservation_error(d) == \
            jax_goodput.conservation_error(d)
    fleet = goodput.fleet_decomposition(got)
    hint = goodput.advise(got, 0.0)
    assert goodput.format_goodput(got, fleet, hint=hint) == \
        jax_goodput.format_goodput(got, fleet, hint=hint)


def test_goodput_collapse_fires_through_the_ledger():
    """Three steps of work, then steps blocked at a peer: the cumulative
    goodput share falls below half its EWMA for two records running and
    goodput_collapse fires, after the warm-up records set the EWMA."""
    mon = AnomalyMonitor(thresholds=Thresholds(goodput_collapse_windows=2))
    now = [0.0]
    gp = goodput.GoodputLedger(monitor=mon, interval=1,
                               clock=lambda: now[0])
    for step in range(1, 7):
        work, blocked = (1.0, 0.01) if step <= 3 else (0.01, 10.0)
        now[0] += work
        gp.step_mark(begin=True)
        now[0] += blocked
        gp.mark("wait")
        gp.log_record(step)
    fired = [(e["rule"], e["step"]) for e in mon.events]
    assert fired == [("goodput_collapse", 5)]


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_default_run_writes_goodput_at_the_jax_steps(tmp_path):
    """ResNet-20, 5 steps and ``test()``, the JAX trainer's defaults (the
    counters and the goodput ledger on) with a record every 2 steps: the
    same record kinds in the same order, "goodput" records at steps 3, 5
    and the final one, each conserved."""
    from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
    from gtopkssgd_tpu.trainer import Trainer as JaxTrainer

    common = dict(dnn="resnet20", batch_size=4, compression="gtopk",
                  density=0.01, topk_method="exact", max_epochs=1,
                  eval_batches=1, log_interval=2, prefetch=0,
                  obs_goodput_interval=2)
    with JaxTrainer(JaxConfig(nworkers=1, out_dir=str(tmp_path / "jax"),
                              **common)) as jt:
        jt.train(5)
        jt.test()
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path / "port"),
                             **common)) as pt:
        pt.train(5)
        pt.test()
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    steps = [(r["step"], r["final"]) for r in got if r["kind"] == "goodput"]
    assert steps == [(3, 0), (5, 0), (5, 1)]
    assert steps == [(r["step"], r["final"]) for r in want
                     if r["kind"] == "goodput"]
    for r in got:
        if r["kind"] == "goodput":
            assert set(r) == set(want[-1])
            assert goodput.conservation_error(r) <= 1e-6
            assert r["startup_s"] > 0 and r["goodput_s"] > 0
