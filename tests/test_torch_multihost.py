"""``--multihost``: two processes launched from outside, each told its rank
by ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, join one gloo group on the CPU and train; both ranks'
final parameters are bitwise those of ``--nworkers 2`` spawned from the
same seed (and their whole state: residuals, momentum), rank 0 prints the
summary; a missing variable or another ``--nworkers`` is refused."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from gtopkssgd_tpu_torch import dist_trainer
from gtopkssgd_tpu_torch.parallel.dist import ENV_VARS, init_from_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--dnn", "resnet20", "--batch-size", "4", "--compression", "gtopk",
        "--density", "0.01", "--topk-method", "twostage", "--eval-batches",
        "1", "--device", "cpu", "--num-iters", "3", "--prefetch", "1"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ckpt(out_dir, rank):
    return torch.load(os.path.join(out_dir, "ckpt", "3", f"rank{rank}.pt"),
                      weights_only=True)


def test_two_env_launched_ranks_are_the_spawned_run(tmp_path):
    spawned, launched = str(tmp_path / "spawned"), str(tmp_path / "mh")
    assert dist_trainer.main(ARGS + ["--nworkers", "2", "--out-dir",
                                     spawned]) == 0
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
               "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
               "MASTER_PORT": port, "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gtopkssgd_tpu_torch.dist_trainer",
             *ARGS, "--multihost", "--out-dir", launched], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    assert summary["nworkers"] == 2 and summary["step"] == 3
    assert summary["dist_backend"] == "gloo"
    assert not outs[1][0].strip()  # only rank 0 prints
    for rank in range(2):
        mine, theirs = _ckpt(launched, rank), _ckpt(spawned, rank)
        assert sorted(mine) == sorted(theirs)
        for name, t in theirs.items():
            assert torch.equal(mine[name], t), (rank, name)
    assert not torch.equal(_ckpt(launched, 0)["residual"],
                           _ckpt(launched, 1)["residual"])


def test_missing_environment_and_other_nworkers_refused(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_from_env("gloo", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="WORLD_SIZE"):
        dist_trainer.main(ARGS + ["--multihost", "--nworkers", "3"])
