"""The port's experiment grid (gtopkssgd_tpu_torch.experiments) against
the root ``experiments`` package: the same registry, the same --list, the
same resolved config handed to each trainer; a CI-scale launch through
the port's own launch path (two gloo ranks on the CPU); the sweep."""

import dataclasses
import json

import pytest
import torch

import experiments
import experiments.run as jax_run
from gtopkssgd_tpu_torch import benchmark, dist_trainer
from gtopkssgd_tpu_torch import experiments as port
from gtopkssgd_tpu_torch.experiments import run as port_run
from gtopkssgd_tpu_torch.parallel import dist as port_dist

NAMES = list(experiments.EXPERIMENTS)
PORT_ONLY = {"device", "resume", "model_config", "cuda_allocator"}
OVERRIDES = ["--nworkers", "4", "--batch-size", "4", "--max-epochs", "3",
             "--eval-batches", "1", "--log-interval", "5"]


def test_registry_equals_the_root_registry():
    assert port.EXPERIMENTS == experiments.EXPERIMENTS
    assert list(port.EXPERIMENTS) == NAMES and len(NAMES) == 15
    assert port.SWEEP_NAME == experiments.SWEEP_NAME


def test_list_prints_the_root_runners_lines(capsys):
    assert jax_run.main(["--list"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_run.main(["--list"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 16
    assert got[:-1] == want[:-1]
    # The sweep's line names the harness that runs it.
    assert got[-1].split(" -> ")[0] == want[-1].split(" -> ")[0]
    assert got[-1].endswith("-> gtopkssgd_tpu_torch.benchmark")


class _StubJaxTrainer:
    """The root runner's Trainer, recording its config."""
    seen = []

    def __init__(self, cfg):
        self.seen.append(cfg)
        self.logger = __import__("logging").getLogger("stub")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def restore(self):
        return False

    def train(self, n):
        return {"losses": [1.0] * n}

    def test(self):
        return {"val_loss": 1.0}

    def fit(self):
        return {"losses": [1.0]}


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["registry", "overridden"])
@pytest.mark.parametrize("name", NAMES)
def test_trainer_gets_the_root_runners_config(monkeypatch, name, overrides):
    """With both trainers stubbed, each entry under the same overrides
    hands its trainer configs equal field by field, but for the port's
    own device and resume; P > 1 goes through ``spawn`` as P ranks."""
    import gtopkssgd_tpu.trainer as jax_trainer

    _StubJaxTrainer.seen = []
    monkeypatch.setattr(jax_trainer, "Trainer", _StubJaxTrainer)
    assert jax_run.main([name, "--num-iters", "1", *overrides]) == 0
    (want,) = _StubJaxTrainer.seen

    seen = []

    def fake_run(cfg, num_iters, *rest):
        seen.append(("run", 1, cfg, num_iters))
        return {"rc": 0}

    def fake_spawn(fn, nworkers, cfg, num_iters, *rest, backend, device,
                   **kw):
        assert fn is dist_trainer._rank_run and backend == "gloo"
        seen.append(("spawn", nworkers, cfg, num_iters))
        return [{"rc": 0, "rank": r} for r in range(nworkers)]

    monkeypatch.setattr(dist_trainer, "run", fake_run)
    monkeypatch.setattr(port_dist, "spawn", fake_spawn)
    assert port_run.main([name, "--num-iters", "1", "--device", "cpu",
                          *overrides]) == 0
    ((how, ranks, got, num_iters),) = seen
    assert num_iters == 1 and got.device == "cpu" and got.resume is False
    assert ranks == got.nworkers == want.nworkers
    assert how == ("spawn" if ranks > 1 else "run")
    got_fields = dataclasses.asdict(got.resolved())
    for key in PORT_ONLY:
        got_fields.pop(key)
    assert got_fields == dataclasses.asdict(want.resolved())


def _done(caplog) -> dict:
    (line,) = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("done: ")]
    return json.loads(line[len("done: "):])


def test_ci_scale_launch_over_gloo(caplog):
    """Two rank processes over gloo on the CPU through the port's launch
    path; the done line holds rank 0's train and test stats."""
    caplog.set_level("INFO", logger="gtopkssgd_tpu_torch.experiments")
    rc = port_run.main(["cifar10_resnet20_gtopk", "--nworkers", "2",
                        "--batch-size", "4", "--num-iters", "2",
                        "--eval-batches", "1", "--device", "cpu"])
    assert rc == 0
    done = _done(caplog)
    assert done["nworkers"] == 2 and done["dist_backend"] == "gloo"
    assert done["step"] == 2 and len(done["losses"]) == 2
    assert "val_loss" in done and "val_top1" in done


def test_p1_runs_in_process_and_resumes(tmp_path, caplog):
    caplog.set_level("INFO", logger="gtopkssgd_tpu_torch.experiments")
    args = ["cifar10_resnet20_gtopk_recommended", "--nworkers", "1",
            "--batch-size", "4", "--num-iters", "2", "--eval-batches", "1",
            "--out-dir", str(tmp_path), "--device", "cpu"]
    dones = []
    for extra in ([], ["--resume"]):
        caplog.clear()
        assert port_run.main(args + extra) == 0
        dones.append(_done(caplog))
    first, resumed = dones
    assert first["step"] == 2 and resumed["step"] == 4
    for done in dones:
        assert done["compression"] == "gtopk" and done["density"] == 0.001
        assert len(done["losses"]) == 2 and "val_loss" in done


def test_sweep_runs_the_harness_once_a_density(monkeypatch):
    calls = []
    monkeypatch.setattr(benchmark, "main",
                        lambda argv: calls.append(list(argv)) or 0)
    assert port_run.main([port.SWEEP_NAME, "--device", "cpu"]) == 0
    assert len(calls) == 4
    densities = [float(argv[argv.index("--density") + 1]) for argv in calls]
    assert densities == [1.0, 0.01, 0.001, 0.0001]
    for argv in calls:
        assert argv[:2] == ["--dnn", "resnet50"]
        assert argv[argv.index("--device") + 1] == "cpu"


def test_cuda_without_a_card_fails(monkeypatch):
    """No fallback: --device cuda (the default) with no card visible
    exits non-zero before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist_trainer, "run", lambda *a: pytest.fail("ran"))
    with pytest.raises(SystemExit) as e:
        port_run.main(["cifar10_resnet20_gtopk", "--nworkers", "1"])
    assert e.value.code not in (0, None)


def test_unknown_name_is_a_usage_error():
    for main in (jax_run.main, port_run.main):
        with pytest.raises(SystemExit) as e:
            main(["no_such_experiment"])
        assert e.value.code == 2
