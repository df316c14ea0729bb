"""The port's resilience layer against the JAX package's: the ``--inject``
grammar, parsed on the same specs (valid and malformed) by both
``parse_inject``s; the exit-code registry; ``retry_call`` and
``PreemptionGuard``; and, through the port's command line on the CPU, a
preemption (an injected SIGTERM) exiting 45 and the resume reproducing
the uninterrupted run bitwise, at P = 1 and at P = 2 over gloo (every
rank saving the same step); ``corrupt_ckpt@latest`` falling back to the
previous step; the loader fault absorbed; ``nan_grad``, ``slow_rank`` and
``reshape`` firing where their step says."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from gtopkssgd_tpu import exit_codes as jax_exit_codes
from gtopkssgd_tpu.resilience import inject as jax_inject
from gtopkssgd_tpu.resilience import preempt as jax_preempt
from gtopkssgd_tpu_torch import dist_trainer, exit_codes
from gtopkssgd_tpu_torch.resilience import (
    FaultInjector,
    InjectedLoaderError,
    PreemptionGuard,
    corrupt_checkpoint_dir,
    parse_inject,
    retry_call,
)
from gtopkssgd_tpu_torch.resilience import inject as port_inject
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", prefetch=1)
CLI = ["--dnn", "resnet20", "--batch-size", "4", "--compression", "gtopk",
       "--density", "0.01", "--topk-method", "twostage", "--eval-batches",
       "1", "--device", "cpu", "--prefetch", "1"]

VALID = [
    "nan_grad@120", "nan_grad@2-99", "slow_rank:2:2.5s@50-60",
    "slow_rank:0:0.1@3", "loader_raise@75", "preempt@200",
    "corrupt_ckpt@latest", "reshape@9", "reshape@4-6", "resize@3:1",
    "resize@10:8", "evict_rank:1@5", "evict_rank:0@1",
    "nan_grad@3, preempt@7 ,loader_raise@1",
    "preempt@3,resize@5:2,corrupt_ckpt@latest,reshape@2",
]
MALFORMED = [
    "", " , ", "nan_grad", "bogus@3", "nan_grad@latest", "nan_grad@0",
    "nan_grad@5-3", "nan_grad@x", "slow_rank@3", "slow_rank:1@3",
    "slow_rank:x:1s@3", "slow_rank:1:-1s@3", "corrupt_ckpt@3",
    "resize@3", "resize:2@3", "resize@0:1", "resize@3:0", "resize@a:b",
    "evict_rank@3", "evict_rank:x@3", "evict_rank:-1@3",
    "evict_rank:1@3-5", "preempt:1@3", "reshape@2-1",
]


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


# --------------------------------------------------------------- grammar

@pytest.mark.parametrize("spec", VALID)
def test_inject_grammar_parses_as_jax(spec):
    ours = [dataclasses.asdict(f) for f in parse_inject(spec)]
    theirs = [dataclasses.asdict(f) for f in jax_inject.parse_inject(spec)]
    assert ours == theirs
    assert [f.spec() for f in parse_inject(spec)] == [
        f.spec() for f in jax_inject.parse_inject(spec)]


@pytest.mark.parametrize("spec", MALFORMED)
def test_inject_grammar_refuses_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        parse_inject(spec)
    with pytest.raises(ValueError) as theirs:
        jax_inject.parse_inject(spec)
    assert str(ours.value) == str(theirs.value)


def test_malformed_spec_refused_before_training():
    with pytest.raises(ValueError, match="unknown inject kind"):
        TrainConfig(inject="bogus@3", device="cpu").resolved()


@pytest.mark.parametrize("spec", ["nan_grad@3", "nan_grad@2-5",
                                  "resize@4:1", "corrupt_ckpt@latest"])
def test_fault_windows_as_jax(spec):
    ours, theirs = parse_inject(spec)[0], jax_inject.parse_inject(spec)[0]
    for prev in range(0, 7):
        for new in range(prev + 1, prev + 4):
            assert ours.window(prev, new) == theirs.window(prev, new)


def test_corrupt_checkpoint_dir_as_jax(tmp_path):
    for tree in ("a", "b"):
        root = tmp_path / tree
        (root / "sub").mkdir(parents=True)
        (root / "big.pt").write_bytes(b"x" * 200)
        (root / "sub" / "big2").write_bytes(b"y" * 100)
        (root / "small").write_bytes(b"z" * 10)
    assert corrupt_checkpoint_dir(str(tmp_path / "a")) == \
        jax_inject.corrupt_checkpoint_dir(str(tmp_path / "b")) == 2
    for name in ("big.pt", "sub/big2", "small"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


# ------------------------------------------------------------ exit codes

def test_exit_code_registry_equals_jax():
    assert exit_codes.REGISTRY == jax_exit_codes.REGISTRY
    names = [n for n in dir(jax_exit_codes) if n.startswith("EXIT_")]
    assert names == [n for n in dir(exit_codes) if n.startswith("EXIT_")]
    for name in names:
        assert getattr(exit_codes, name) == getattr(jax_exit_codes, name)
    for code in list(exit_codes.REGISTRY) + [7]:
        assert exit_codes.describe(code) == jax_exit_codes.describe(code)
    assert exit_codes.EXIT_PREEMPTED == 45
    assert exit_codes.EXIT_RESIZE_RESTART == 46


# ------------------------------------------------- retry_call and guard

def test_retry_call_retries_then_succeeds(monkeypatch):
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("blip")
        return "ok"

    assert retry_call(flaky, retries=3, delay=0.5, backoff=2.0) == "ok"
    assert slept == [0.5, 1.0] and len(calls) == 3
    calls.clear()
    slept_jax = []
    monkeypatch.setattr("time.sleep", slept_jax.append)
    assert jax_preempt.retry_call(flaky, retries=3, delay=0.5,
                                  backoff=2.0) == "ok"
    assert slept_jax == slept


def test_retry_call_reraises_the_original(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)

    def broken():
        raise KeyError("still")

    with pytest.raises(KeyError, match="still"):
        retry_call(broken, retries=2)
    with pytest.raises(ValueError):  # not in `exceptions`: no retry
        retry_call(lambda: int("x"), retries=5, exceptions=(KeyError,))


def test_preemption_guard_sets_a_flag_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered and guard.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    guard.install()  # idempotent
    os.kill(os.getpid(), signal.SIGUSR1)
    assert guard.triggered
    guard.close()


# ---------------------------------------------------- preempt -> resume

def _ckpt(out_dir, step, rank=0):
    return torch.load(os.path.join(out_dir, "ckpt", str(step),
                                   f"rank{rank}.pt"), weights_only=True)


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for name, t in a.items():
        assert torch.equal(t, b[name]), name


@pytest.mark.parametrize("nworkers", [1, 2])
def test_preempt_exits_45_and_the_resume_is_the_straight_run(tmp_path,
                                                            nworkers):
    """``--inject preempt@2`` (a real SIGTERM to rank 0 after step 2,
    under the default ``--preempt-save``): exit 45 with step 2 saved by
    every rank; the same command with ``--resume`` to step 4 holds the
    state of 4 straight steps, bitwise, on every rank."""
    cli = CLI + ["--nworkers", str(nworkers)]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert dist_trainer.main(cli + ["--num-iters", "4", "--out-dir", a,
                                    "--inject", "preempt@2"]) == 45
    assert sorted(os.listdir(os.path.join(a, "ckpt"))) == [
        "2", "integrity-2.json"]
    assert sorted(os.listdir(os.path.join(a, "ckpt", "2"))) == [
        f"rank{r}.pt" for r in range(nworkers)]
    assert dist_trainer.main(cli + ["--num-iters", "2", "--out-dir", a,
                                    "--resume"]) == 0
    assert dist_trainer.main(cli + ["--num-iters", "4", "--out-dir",
                                    b]) == 0
    for rank in range(nworkers):
        _assert_same_state(_ckpt(a, 4, rank), _ckpt(b, 4, rank))
    name = "metrics.jsonl" if nworkers == 1 else "metrics.rank0.jsonl"
    recs = _records(os.path.join(a, name))
    kinds = [r["kind"] for r in recs]
    assert "inject" in kinds
    save = next(r for r in recs if r["kind"] == "recovery"
                and r["action"] == "emergency_save")
    assert save["step"] == 2
    summary = [r for r in recs if r.get("action") == "summary"]
    assert summary[0]["final_status"] == "preempted"
    if nworkers == 2:  # rank 1 was never signalled, and stopped with 0
        r1 = _records(os.path.join(a, "metrics.rank1.jsonl"))
        assert not [r for r in r1 if r["kind"] == "inject"]
        assert [r["step"] for r in r1 if r.get("action") ==
                "emergency_save"] == [2]


def test_no_preempt_save_keeps_the_default_disposition(tmp_path):
    """Without a guard the preempt fault only warns (a SIGTERM would
    otherwise kill the process): the run completes."""
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             inject="preempt@1", **SMALL)) as t:
        t.train(2)
        assert t.step == 2
    assert dist_trainer.build_argparser().parse_args(
        ["--no-preempt-save"]).preempt_save is False


def test_corrupt_latest_falls_back_to_the_previous_step(tmp_path):
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             **SMALL)) as t:
        for _ in range(2):
            t.train(1)
            t.save()
        want = {k: v.clone() for k, v in t.checkpoint_state().items()}
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             resume=True, inject="corrupt_ckpt@latest",
                             **SMALL)) as t:
        assert t.step == 1 and t._ckpt.last_restored_step == 1
        t.train(1)
        _assert_same_state(t.checkpoint_state(), want)
    recs = _records(tmp_path / "metrics.jsonl")
    fired = [r for r in recs if r["kind"] == "inject"]
    assert [(r["fault"], r["step"]) for r in fired] == [("corrupt_ckpt", 2)]


# -------------------------------------------------- the other firings

def test_loader_fault_is_absorbed(tmp_path):
    with Trainer(TrainConfig(device="cpu", **SMALL)) as clean:
        want = clean.train(3)["losses"]
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             inject="loader_raise@2", **SMALL)) as t:
        assert t.train(3)["losses"] == want
        assert t.injector.summary() == {"loader_raise": 1}
    injector = FaultInjector("loader_raise@1")
    with pytest.raises(InjectedLoaderError):
        injector.check_loader(0, 1)
    injector.check_loader(0, 1)  # consumed


def test_nan_grad_poisons_its_step_only_from_there(tmp_path):
    """The first parameter goes NaN before step 2: its loss is NaN, step
    1's is not. (``exact`` selects here: the stage-1 twin has no answer
    for a bucket whose maximum is NaN; see ROADMAP.md section 3.)"""
    with Trainer(TrainConfig(device="cpu", inject="nan_grad@2",
                             **dict(SMALL, topk_method="exact"))) as t:
        losses = t.train(3)["losses"]
        assert torch.isnan(next(t.model.parameters())).all()
    assert np.isfinite(losses[0]) and np.isnan(losses[1])


def test_slow_rank_and_reshape_fire_at_their_steps(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(port_inject.time, "sleep", slept.append)
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             inject="slow_rank:0:0.25s@2-3,reshape@2",
                             **SMALL)) as t:
        stats = t.train(3)
        assert t.injector.summary() == {"slow_rank": 2, "reshape": 1}
    assert slept == [0.25, 0.25]
    assert all(np.isfinite(stats["losses"]))
    recs = [r for r in _records(tmp_path / "metrics.jsonl")
            if r["kind"] == "inject"]
    assert [(r["fault"], r["step"]) for r in recs] == [
        ("slow_rank", 2), ("reshape", 2), ("slow_rank", 3)]
    assert recs[1]["from_dim"] == 4 and recs[1]["to_dim"] == 2


def test_injector_hooks_as_jax():
    """The hooks' return values and firing counts equal the JAX
    injector's over the same dispatch windows."""
    spec = "resize@3:2,evict_rank:1@5,loader_raise@2"
    ours, theirs = FaultInjector(spec), jax_inject.FaultInjector(spec)
    for prev in range(0, 6):
        assert ours.pending_resize(prev, prev + 1) == \
            theirs.pending_resize(prev, prev + 1)
        assert ours.pending_evict(prev, prev + 1) == \
            theirs.pending_evict(prev, prev + 1)
    assert ours.summary() == theirs.summary() == {"resize": 1,
                                                  "evict_rank": 1}


def test_sigterm_to_the_command_stops_every_rank_at_one_step(tmp_path):
    """A SIGTERM to the command that spawned two ranks (as a scheduler
    sends it) reaches both, they agree on one step, save it and the
    command exits 45; rank 0 is slowed so the signal lands mid-run."""
    import subprocess
    import sys
    import time

    out = str(tmp_path / "run")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gtopkssgd_tpu_torch.dist_trainer", *CLI,
         "--nworkers", "2", "--num-iters", "60", "--log-interval", "1",
         "--out-dir", out, "--inject", "slow_rank:0:0.2s@1-60"],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    shard = os.path.join(out, "metrics.rank0.jsonl")
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and proc.poll() is None:
        if os.path.exists(shard) and any(
                r["kind"] == "train" for r in _records(shard)):
            break
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=240)
    assert proc.returncode == 45, err[-3000:]
    ckpt = os.path.join(out, "ckpt")
    steps = [n for n in os.listdir(ckpt) if n.isdigit()]
    assert len(steps) == 1 and 0 < int(steps[0]) < 60
    assert sorted(os.listdir(os.path.join(ckpt, steps[0]))) == [
        "rank0.pt", "rank1.pt"]
    assert os.path.exists(os.path.join(ckpt, f"integrity-{steps[0]}.json"))
    for rank in range(2):
        saves = [r["step"] for r in _records(os.path.join(
            out, f"metrics.rank{rank}.jsonl"))
            if r.get("action") == "emergency_save"]
        assert saves == [int(steps[0])]
