"""The port's recovery policy (``resilience/policy.py``, ``--recover-policy``)
against the JAX package's, and its actions in the port's trainer on the
CPU (ResNet-20, batch 4, density 0.01, ``twostage``):

* ``parse_policy`` accepts and refuses the JAX parser's specs, with the
  same actions, budgets and parameters; ``describe_policy`` says the same;
  a ``RecoveryManager`` driven by one script of claims makes the JAX one's
  decisions;
* ``skip``: a NaN gradient injected at step 2 and claimed leaves the
  trainer bitwise at its state after step 1 (a run that never dispatched
  step 2), at P = 1 and on both ranks of a P = 2 gloo run (where the
  ranks' exporters take the port and the next), and through the command
  line exits 0 with one "skip" record and the summary; a persistent NaN
  burns the skip budget and exits 44;
* ``degrade``: the dense branch for the cooldown, then the sparse step;
* ``rollback``: the newest checkpoint, or a halt without one;
* ``--obs-halt-on error`` without a policy exits 44 at the NaN's step, a
  stalled rank of a P = 2 run ends the command with 43, and a policy
  without the monitor is refused.
"""

import json

import numpy as np
import pytest
import torch

from gtopkssgd_tpu.resilience import policy as jax_policy
from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.obs import AnomalyHalt
from gtopkssgd_tpu_torch.resilience import describe_policy, parse_policy
from gtopkssgd_tpu_torch.resilience import policy as port_policy
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", prefetch=0,
             eval_batches=1, device="cpu", log_interval=1)
CLI = ["--dnn", "resnet20", "--batch-size", "4", "--compression", "gtopk",
       "--density", "0.01", "--topk-method", "twostage", "--eval-batches",
       "1", "--device", "cpu", "--prefetch", "0"]

VALID = [
    "nan_loss=skip",
    "nan_loss=skip, loss_spike=rollback:4:0.25,density_collapse=degrade",
    "residual_blowup=degrade:2:100",
    "residual_age_runaway=rollback::1.5",
    "straggler_persistent=skip:5",
    "nan_loss=rollback:1:0,loss_spike=skip:2",
]
REFUSED = [
    "nan_loss",                     # no '='
    "typo_rule=skip",               # unknown rule
    "nan_loss=retry",               # unknown action
    "nan_loss=skip,nan_loss=skip",  # rule mapped twice
    "nan_loss=skip:0",              # budget < 1
    "nan_loss=skip:x",              # non-int budget
    "nan_loss=skip:1:y",            # non-float param
    "nan_loss=skip:1:2:3",          # extra ':' parts
    ",",                            # empty
    "",
    "link_degraded=skip",           # a monitor rule no policy may map
]


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("spec", VALID)
def test_parse_policy_as_jax(spec):
    got, want = parse_policy(spec), jax_policy.parse_policy(spec)
    assert {r: (s.action, s.budget, s.param) for r, s in got.items()} == {
        r: (s.action, s.budget, s.param) for r, s in want.items()}
    assert describe_policy(spec) == jax_policy.describe_policy(spec)


@pytest.mark.parametrize("spec", REFUSED)
def test_parse_policy_refuses_as_jax(spec):
    with pytest.raises(ValueError):
        jax_policy.parse_policy(spec)
    with pytest.raises(ValueError):
        parse_policy(spec)


def test_policy_tables_are_the_jax_tables():
    assert port_policy.ACTIONS == jax_policy.ACTIONS
    assert port_policy.RULES == jax_policy.RULES
    assert describe_policy(None) == jax_policy.describe_policy(None)


def _drive(mod):
    """One script of claims, clean steps and applied actions through a
    RecoveryManager of module `mod`; returns its decisions and counters."""
    rec = mod.RecoveryManager(mod.parse_policy(
        "nan_loss=skip:2,loss_spike=rollback:1,density_collapse=degrade:1"))
    out = []
    script = ["residual_blowup", "nan_loss", "apply", "nan_loss", "apply",
              "nan_loss", "ok", "nan_loss", "loss_spike", "apply",
              "loss_spike", "density_collapse", "apply", "density_collapse",
              "end_degrade", "density_collapse"]
    for item in script:
        if item == "ok":
            rec.note_ok()
        elif item == "apply":
            for event, spec in rec.pop_pending():
                if spec.action == "skip":
                    rec.consecutive_skips += 1
                elif spec.action == "rollback":
                    rec.rollback_uses[spec.rule] = (
                        rec.rollback_uses.get(spec.rule, 0) + 1)
                else:
                    rec.degraded = True
                    rec.degrade_episodes += 1
                rec.record(spec.action, 1, spec.rule)
                out.append(("applied", spec.action, event["rule"]))
        elif item == "end_degrade":
            rec.degraded = False
        else:
            out.append((item, rec.claim({"rule": item})))
    return out, rec.n_recoveries, rec.consecutive_skips, rec.actions


def test_recovery_manager_budgets_as_jax():
    got, want = _drive(port_policy), _drive(jax_policy)
    assert got == want
    claims = [c for c in got[0] if c[0] != "applied"]
    assert claims[0] == ("residual_blowup", False)   # unmapped
    assert ("nan_loss", False) in claims             # skip budget spent
    assert claims[-1] == ("density_collapse", False)  # degrade budget spent


# --------------------------------------------------------------- trainer

def _state(t):
    return {k: v.clone() for k, v in t.checkpoint_state().items()}


def test_skip_restores_the_state_bitwise(tmp_path):
    """A NaN injected at step 2, claimed by nan_loss=skip: the trainer is
    bitwise at its state after step 1 -- parameters, BatchNorm, momentum,
    residual, counters, count and step."""
    with Trainer(TrainConfig(**SMALL)) as a:
        a.train(1)
        clean = _state(a)
    with Trainer(TrainConfig(out_dir=str(tmp_path), inject="nan_grad@2",
                             recover_policy="nan_loss=skip",
                             obs_halt_on="error", **SMALL)) as b:
        b.train(2)
        assert b.step == 1 and b.optimizer.state["count"] == 1
        assert b.recovery.n_recoveries == 1
        chaos = _state(b)
        b.finalize_resilience("completed")
    assert chaos.keys() == clean.keys()
    for name, v in clean.items():
        assert torch.equal(chaos[name], v), name
    recs = _records(tmp_path / "metrics.jsonl")
    (skip,) = [r for r in recs if r.get("action") == "skip"]
    assert skip["rule"] == "nan_loss" and skip["step"] == 1
    summary = [r for r in recs if r.get("action") == "summary"]
    assert summary[-1]["n_recoveries"] == 1


def test_skip_at_p2_restores_every_rank_bitwise():
    """The JAX test's case: ``gtopk_layerwise`` on 2 gloo ranks, a NaN
    injected at step 2 on every rank and claimed by nan_loss=skip: each
    rank bitwise at its state after step 1. The ranks' exporters listen
    on the given port and the next one."""
    import socket

    import test_torch_rank_programs as programs
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cfg = dict(SMALL, compression="gtopk_layerwise", nworkers=2)
    cfg.pop("device")
    got = spawn(programs.skip_runs, 2, cfg,
                dict(inject="nan_grad@2", recover_policy="nan_loss=skip",
                     obs_halt_on="error", obs_export_port=port),
                backend="gloo", device="cpu", timeout=300)
    for rank, out in enumerate(got):
        assert out["step"] == 1 and out["recoveries"] == 1
        assert out["port"] == port + rank
        assert out["chaos"].keys() == out["clean"].keys()
        for name, v in out["clean"].items():
            np.testing.assert_array_equal(out["chaos"][name], v,
                                          err_msg=f"rank {rank} {name}")


def test_a_stalled_rank_ends_the_command_with_43(tmp_path):
    """At P = 2 the stalled rank's watchdog exits 43 and the command
    returns 43, its "stall" record in that rank's shard."""
    import glob

    out = tmp_path / "run"
    rc = dist_trainer.main(CLI + [
        "--nworkers", "2", "--num-iters", "5", "--inject",
        "slow_rank:0:6s@3", "--obs-watchdog", "2", "--out-dir", str(out)])
    assert rc == 43
    stalls = [r for f in glob.glob(str(out / "metrics.rank*.jsonl"))
              for r in _records(f) if r["kind"] == "stall"]
    assert stalls and all(r["deadline_s"] == 2.0 for r in stalls)


def test_cli_skip_exits_0_with_one_skip(tmp_path, capsys):
    out = tmp_path / "run"
    rc = dist_trainer.main(CLI + [
        "--num-iters", "4", "--inject", "nan_grad@3",
        "--recover-policy", "nan_loss=skip", "--out-dir", str(out)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["step"] == 3  # four dispatches, one skipped
    recs = _records(out / "metrics.jsonl")
    assert [r["action"] for r in recs if r["kind"] == "recovery"] == [
        "skip", "summary"]
    (event,) = [r for r in recs if r["kind"] == "event"
                and r["rule"] == "nan_loss"]
    assert event["claimed"] is True and event["step"] == 3
    # The JAX trainer's last records: the summary, then the goodput
    # ledger's (it saw the skipped dispatch as wasted).
    assert recs[-2]["final_status"] == "completed"
    assert recs[-1]["kind"] == "goodput" and recs[-1]["final"] == 1
    assert recs[-1]["n_wasted_steps"] == 1 and recs[-1]["wasted_s"] > 0


def test_skip_budget_exhaustion_halts(tmp_path):
    """A NaN every step burns the consecutive-skip budget, then halts."""
    out = tmp_path / "run"
    rc = dist_trainer.main(CLI + [
        "--num-iters", "5", "--inject", "nan_grad@1-99",
        "--recover-policy", "nan_loss=skip:2", "--obs-halt-on", "error",
        "--out-dir", str(out)])
    assert rc == 44
    recs = _records(out / "metrics.jsonl")
    skips = [r for r in recs if r.get("action") == "skip"]
    assert [r["consecutive"] for r in skips] == [1, 2]
    assert recs[-2]["action"] == "summary"
    assert recs[-2]["final_status"] == "halted"
    assert recs[-1]["kind"] == "goodput" and recs[-1]["final"] == 1


def test_halt_exits_44_at_the_nan_step(tmp_path):
    out = tmp_path / "run"
    rc = dist_trainer.main(CLI + [
        "--num-iters", "5", "--inject", "nan_grad@2", "--obs-halt-on",
        "error", "--out-dir", str(out)])
    assert rc == 44
    recs = _records(out / "metrics.jsonl")
    events = [r for r in recs if r["kind"] == "event"]
    assert events[0]["rule"] == "nan_loss" and events[0]["step"] == 2
    assert max(r["step"] for r in recs if r["kind"] == "obs") == 2
    assert recs[-2]["final_status"] == "halted"
    assert recs[-1]["kind"] == "goodput"


def test_policy_without_the_monitor_is_refused():
    with pytest.raises(ValueError, match="obs_events"):
        dist_trainer.main(CLI + ["--num-iters", "1", "--recover-policy",
                                 "nan_loss=skip", "--no-obs-events"])
    with pytest.raises(ValueError):
        dist_trainer.main(CLI + ["--num-iters", "1", "--recover-policy",
                                 "nan_loss=bogus"])


def test_degrade_runs_dense_then_resumes_sparse(tmp_path):
    """degrade runs the optimizer's dense branch for the cooldown (no
    selection: tau 0, everything sent), then the sparse step again."""
    cfg = TrainConfig(out_dir=str(tmp_path), obs_halt_on="error",
                      recover_policy="density_collapse=degrade:1:2", **SMALL)
    with Trainer(cfg) as t:
        t.train(1)
        assert t.monitor.recovery({"rule": "density_collapse", "step": 1})
        t.train(2)                       # applies degrade, then dense
        assert t._degraded
        t.train(3)                       # the cooldown of 2 steps ends
        assert not t._degraded
        assert t.step == 6 and t.optimizer.warmup_dense_steps == 0
        t.finalize_resilience("completed")
    recs = _records(tmp_path / "metrics.jsonl")
    actions = [r["action"] for r in recs if r["kind"] == "recovery"]
    assert actions == ["degrade", "sparse_resume", "summary"]
    dens = {r["step"]: r["achieved_density"] for r in recs
            if r["kind"] == "obs"}
    assert dens[3] == 1.0 and dens[4] == 1.0  # the dense cooldown
    assert dens[5] < 0.1 and dens[1] < 0.1


def test_rollback_restores_the_newest_checkpoint(tmp_path):
    cfg = TrainConfig(out_dir=str(tmp_path), inject="nan_grad@4",
                      recover_policy="nan_loss=rollback:2:0", **SMALL)
    with Trainer(cfg) as t:
        t.train(2)
        t.save()
        saved = _state(t)
        t.train(2)                       # step 4 is NaN: back to step 2
        assert t.step == 2
        for name, v in saved.items():
            assert torch.equal(t.checkpoint_state()[name], v), name
        t.train(1)
        assert t.step == 3
    recs = _records(tmp_path / "metrics.jsonl")
    (rb,) = [r for r in recs if r.get("action") == "rollback"]
    assert rb["step"] == 2 and rb["use"] == 1 and rb["backoff_s"] == 0.0


def test_rollback_without_a_checkpoint_halts():
    cfg = TrainConfig(inject="nan_grad@2",
                      recover_policy="nan_loss=rollback", **SMALL)
    with Trainer(cfg) as t:
        with pytest.raises(AnomalyHalt):
            t.train(2)
    assert t.monitor.events[0]["rule"] == "nan_loss"
