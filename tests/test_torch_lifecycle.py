"""The trainer's lifecycle and host path in the port, against the JAX
package on the CPU: the metrics logger and the run manifest, the
prefetcher, the native data prep, ``synth_hard``, checkpoints that keep
the residual (``--resume``), the CLI's flags, and a JAX checkpoint carried
into the port.

Tolerances: a resumed run equals the uninterrupted one bitwise (the CPU
is deterministic and the resume restores every tensor of the state,
the dropout generator's included); the native library and the numpy path
are bitwise equal, and so are the ``synth_hard`` arrays; the step after
a carried JAX checkpoint holds the slice test's tolerances (loss within
1e-3 relative, keep sets with a Jaccard index of at least 0.99 --
float32 convolutions sum in another order in each framework).
"""

import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

import test_torch_rank_programs as programs
from gtopkssgd_tpu_torch import dist_trainer, native
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.data.cifar import _synthetic
from gtopkssgd_tpu_torch.parallel.dist import spawn
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer
from gtopkssgd_tpu_torch.utils import (
    CheckpointMismatch,
    MetricsLogger,
    Prefetcher,
)
from gtopkssgd_tpu_torch.utils.manifest import (
    config_hash,
    git_sha,
    run_manifest,
)
from gtopkssgd_tpu_torch.utils.metrics import shard_filename, shard_rank

torch.set_num_threads(2)
LOSS_RTOL = 1e-3
MIN_JACCARD = 0.99
SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", eval_batches=1,
             max_epochs=1)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


# ------------------------------------------------------------ metrics

def test_metrics_logger_context_manager(tmp_path):
    with MetricsLogger(str(tmp_path)) as m:
        m.log("train", step=1, loss=2.0)
        m.log("eval", step=1, top1=0.5)
    assert m._fh is None
    recs = _records(tmp_path / "metrics.jsonl")
    assert [r["kind"] for r in recs] == ["train", "eval"]
    assert set(recs[0]) == {"kind", "time", "rank", "step", "loss"}
    m.log("train", step=2, loss=1.0)  # after close: no crash, no write
    assert len(_records(tmp_path / "metrics.jsonl")) == 2


def test_metrics_logger_rank_nonzero_writes_nothing(tmp_path):
    with MetricsLogger(str(tmp_path / "r1"), rank=1) as m:
        m.log("train", step=1, loss=2.0)
    assert not os.path.exists(tmp_path / "r1" / "metrics.jsonl")


def test_metrics_logger_flush_is_durable_and_kind_validated(tmp_path):
    m = MetricsLogger(str(tmp_path))
    try:
        m.log("manifest", flush=True, config_hash="x", step=3)
        assert _records(tmp_path / "metrics.jsonl")[-1]["step"] == 3
        for bad in ("", None, "trian"):
            with pytest.raises(ValueError):
                m.log(bad, step=1)
    finally:
        m.close()


def test_metrics_shards_one_file_a_rank(tmp_path):
    for rank in (0, 3):
        with MetricsLogger(str(tmp_path), rank=rank, shard=True) as m:
            m.log("train", step=1, loss=1.0)
    assert sorted(os.listdir(tmp_path)) == [shard_filename(0),
                                            shard_filename(3)]
    assert shard_rank(str(tmp_path / shard_filename(3))) == 3
    assert shard_rank("metrics.jsonl") is None
    from gtopkssgd_tpu.utils.metrics import shard_filename as jax_name

    assert shard_filename(3) == jax_name(3)


def test_manifest_roundtrip_and_hash_stability():
    from gtopkssgd_tpu.obs.manifest import config_hash as jax_hash

    cfg = {"dnn": "resnet20", "density": 0.01, "nworkers": 2,
           "batch_size": 4, "seed": 42, "compression": "gtopk"}
    man = run_manifest(cfg, extra_field="x")
    back = json.loads(json.dumps(man))
    assert back == man
    assert back["config_hash"] == config_hash(cfg) == jax_hash(cfg)
    assert back["extra_field"] == "x"
    for key in ("dnn", "density", "nworkers", "batch_size", "seed"):
        assert back[key] == cfg[key]
    assert back["torch_version"] == torch.__version__
    assert back["device_name"] is None and back["world_size"] == 1
    assert config_hash(dict(reversed(list(cfg.items())))) == config_hash(cfg)
    assert config_hash({**cfg, "density": 0.02}) != config_hash(cfg)
    sha = git_sha()
    assert sha is None or isinstance(sha, str)


def test_trainer_records_match_the_jax_trainer(tmp_path):
    """ResNet-20, 2 steps and ``test()``, the counters off on both sides:
    the same record kinds in the same order with the same fields. A
    "spans" record holds each tracer's own span paths (the port's are its
    dispatch's ranges), so only its step and "dispatch" are compared; the
    manifest's backend fields are the port's own."""
    from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
    from gtopkssgd_tpu.trainer import Trainer as JaxTrainer

    common = dict(dnn="resnet20", batch_size=4, compression="gtopk",
                  density=0.01, topk_method="exact", max_epochs=1,
                  eval_batches=1, log_interval=1, prefetch=0)
    jt = JaxTrainer(JaxConfig(nworkers=1, out_dir=str(tmp_path / "jax"),
                              obs_counters=False, obs_goodput=False,
                              **common))
    jt.train(2)
    jt.test()
    jt.metrics.close()
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path / "port"),
                             obs_counters=False, obs_goodput=False,
                             **common)) as pt:
        pt.train(2)
        pt.test()
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for g, w in zip(got[1:], want[1:]):
        if g["kind"] == "spans":
            assert g["step"] == w["step"] and "dispatch" in g
            assert "dispatch" in w
        else:
            assert set(g) == set(w), g["kind"]
    man = got[0]
    assert man["config_hash"] == config_hash(pt._identity())
    for key in ("dnn", "dataset", "compression", "density", "wire_codec",
                "nworkers", "batch_size", "seed", "num_params",
                "steps_per_epoch"):
        assert man[key] == want[0][key], key
    assert man["native_dataprep"] is True and man["dispatch"] == "staged"
    for key in ("torch_version", "cuda_version", "device_name",
                "power_limit", "backend", "world_size"):
        assert key in man
    steps = [(r["kind"], r["step"]) for r in got[1:]]
    assert steps == [("train", 1), ("spans", 1), ("train", 2),
                     ("spans", 2), ("eval", 2)]


def test_fit_writes_epoch_records_and_checkpoints(tmp_path, monkeypatch):
    """``fit()`` logs an ``epoch`` record with the JAX trainer's fields
    and saves after each epoch. Both packages' synthetic CIFAR-10 is cut
    to 32 training images, so an epoch is 4 steps of 8; the counters are
    off on both sides, and "spans" records are held by kind and step (each
    tracer has its own span paths)."""
    import gtopkssgd_tpu.data.cifar as jax_cifar
    import gtopkssgd_tpu_torch.data.cifar as port_cifar
    from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
    from gtopkssgd_tpu.trainer import Trainer as JaxTrainer

    for mod in (jax_cifar, port_cifar):
        monkeypatch.setattr(mod, "SYNTH_TRAIN", 32)
        monkeypatch.setattr(mod, "SYNTH_TEST", 8)
        mod._synthetic.cache_clear()
    try:
        common = dict(dnn="resnet20", batch_size=8, compression="gtopk",
                      density=0.01, topk_method="exact", max_epochs=1,
                      eval_batches=1, log_interval=2, seed=17)
        jt = JaxTrainer(JaxConfig(nworkers=1, out_dir=str(tmp_path / "jax"),
                                  obs_counters=False, obs_goodput=False,
                                  prefetch=0, **common))
        jt.fit()
        jt.metrics.close()
        with Trainer(TrainConfig(device="cpu",
                                 out_dir=str(tmp_path / "port"),
                                 obs_counters=False, obs_goodput=False,
                                 **common)) as pt:
            assert pt.steps_per_epoch == 4
            pt.fit()
    finally:
        for mod in (jax_cifar, port_cifar):
            mod._synthetic.cache_clear()
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert [r["kind"] for r in got] == ["manifest", "train", "spans",
                                        "train", "spans", "eval", "epoch"]
    for g, w in zip(got[1:], want[1:]):
        if g["kind"] == "spans":
            assert g["step"] == w["step"]
        else:
            assert set(g) == set(w), g["kind"]
    assert pt.step == 4 and got[-1]["epoch"] == 0
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == [
        "4", "integrity-4.json"]


# ------------------------------------------------------------ prefetch

def test_prefetch_order_preserved():
    src = iter(range(100))
    pf = Prefetcher(lambda: next(src), depth=3)
    got = [next(pf) for _ in range(50)]
    pf.close()
    assert got == list(range(50))


def test_prefetch_worker_exception_propagates_and_keeps_raising():
    def produce():
        raise ValueError("boom")

    pf = Prefetcher(produce, depth=2)
    for _ in range(3):  # every call fails; none may block
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            next(pf)
    pf.close()


def test_prefetch_close_unblocks_full_queue():
    pf = Prefetcher(lambda: 1, depth=1)
    time.sleep(0.2)  # the worker fills the queue and blocks on put
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_bad_depth_and_next_after_close():
    with pytest.raises(ValueError):
        Prefetcher(lambda: 1, depth=0)
    pf = Prefetcher(lambda: 1, depth=1)
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)


def test_trainer_train_after_close_raises():
    t = Trainer(TrainConfig(device="cpu", batch_size=2, compression=None,
                            eval_batches=1))
    t.close()
    with pytest.raises(RuntimeError, match="closed"):
        t.train(1)


def test_trainer_stream_identical_with_and_without_prefetch():
    """Same seed, prefetch 0 and 2: the same losses, bitwise, and the
    same host batches."""
    def run(prefetch):
        with Trainer(TrainConfig(device="cpu", prefetch=prefetch,
                                 **SMALL)) as t:
            return t.train(3)["losses"], [t._next_host()["image"]
                                          for _ in range(2)]

    (la, ba), (lb, bb) = run(0), run(2)
    assert la == lb
    for a, b in zip(ba, bb):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ native

def test_native_builds_here_and_matches_numpy_and_jax():
    from gtopkssgd_tpu import native as jax_native

    assert native.available()
    assert native.library_path().exists()
    rng = np.random.default_rng(0)
    b = 16
    images = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
    ys = rng.integers(0, 9, b).astype(np.int32)
    xs = rng.integers(0, 9, b).astype(np.int32)
    flips = rng.random(b) < 0.5
    got = native.cifar_augment_batch(images, ys, xs, flips)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, native.augment_numpy(
        images, ys, xs, flips))
    np.testing.assert_array_equal(got, jax_native.cifar_augment_batch(
        images, ys, xs, flips))
    # the crop offsets at both ends of the reflect padding
    ys, xs = np.array([0, 8, 0, 8], np.int32), np.array([8, 0, 0, 8],
                                                        np.int32)
    flips = np.array([True, False, True, False])
    np.testing.assert_array_equal(
        native.cifar_augment_batch(images[:4], ys, xs, flips),
        native.augment_numpy(images[:4], ys, xs, flips))


@pytest.mark.parametrize("a,b,d", [
    ([], [], 0),
    ([1, 2, 3], [], 3),
    ([1, 2, 3], [1, 2, 3], 0),
    ([1, 2, 3], [1, 3], 1),
    ([1, 2, 3, 4], [2, 3, 5], 2),
    ([5, 5, 5], [5], 2),
])
def test_native_edit_distance(a, b, d):
    assert native.edit_distance(a, b) == d
    assert native.edit_distance(b, a) == d
    assert native.edit_distance_py(a, b) == d


def test_cifar_batches_go_through_the_native_library(monkeypatch):
    """The pipeline's augmentation calls the library, and its batches
    are the numpy path's."""
    ds = get_dataset("cifar10", split="train", batch_size=8, seed=3)
    want = next(ds.epoch(1))["image"]
    calls = []
    real = native.cifar_augment_batch
    monkeypatch.setattr(native, "cifar_augment_batch",
                        lambda *a: calls.append(1) or real(*a))
    np.testing.assert_array_equal(next(ds.epoch(1))["image"], want)
    assert calls
    monkeypatch.setattr(native, "load", lambda: None)  # the numpy path
    np.testing.assert_array_equal(next(ds.epoch(1))["image"], want)


# ------------------------------------------------------------ synth_hard

@pytest.mark.parametrize("split", ["train", "test"])
def test_synth_hard_arrays_are_the_jax_packages(split):
    from gtopkssgd_tpu.data.cifar import _synthetic as jax_synthetic

    for hard in (False, True):
        ji, jl = jax_synthetic(split, 5, hard=hard)
        pi, pl = _synthetic(split, 5, hard=hard)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
    easy, hard = _synthetic("train", 5)[1], _synthetic("train", 5, True)[1]
    assert (easy != hard).any() if split == "train" else True


def test_synth_hard_reaches_the_trainer():
    with Trainer(TrainConfig(device="cpu", synth_hard=True, prefetch=0,
                             **SMALL)) as t:
        assert t.cfg.synth_hard
        np.testing.assert_array_equal(t.train_data.images,
                                      _synthetic("train", 42, True)[0])


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("extra", [
    dict(),
    dict(topk_method="pallas", momentum_correction=True, nsteps_update=2),
], ids=["twostage", "pallas-correction-accumulate"])
def test_resume_equals_an_uninterrupted_run(tmp_path, extra):
    """6 steps straight against 3, save, a new trainer with resume, 3
    more: mid-epoch (512 steps an epoch), every tensor of the state and
    every loss bitwise."""
    out = programs.resume_run("cpu", {**SMALL, **extra}, str(tmp_path),
                              total=6, split=3)
    assert out["restored_step"] == 3 and out["step"] == 6
    assert out["full_losses"] == out["resumed_losses"]
    assert set(out["full"]) == set(out["resumed"])
    for name, t in out["full"].items():
        assert torch.equal(t, out["resumed"][name]), name
    if extra:
        assert {"residual.v", "residual.u"} <= set(out["full"])


def test_resume_keeps_the_dropout_generator_and_the_carry(tmp_path):
    """The PTB model at a small width: dropout masks and the BPTT carry
    continue across a resume, bitwise."""
    from gtopkssgd_tpu_torch import models
    from gtopkssgd_tpu_torch.models import ModelSpec, PTBLSTM

    small = ModelSpec("lstm", lambda **kw: PTBLSTM(hidden_size=16, **kw),
                      "ptb", (35,), has_batchnorm=False, recurrent=True)
    saved = models._ZOO["lstm"]
    models._ZOO["lstm"] = small
    try:
        out = programs.resume_run("cpu", dict(
            dnn="lstm", batch_size=2, compression="gtopk", density=0.01,
            topk_method="twostage", eval_batches=1), str(tmp_path),
            total=4, split=2)
    finally:
        models._ZOO["lstm"] = saved
    assert "dropout_rng" in out["full"] and "carry.0" in out["full"]
    assert out["full_losses"] == out["resumed_losses"]
    for name, t in out["full"].items():
        assert torch.equal(t, out["resumed"][name]), name


def test_resume_at_two_ranks_and_another_p_refused(tmp_path):
    """P = 2 over gloo: each rank's resumed state equals its uninterrupted
    one; every rank wrote its own metrics shard, both led by a manifest
    with one config hash; resuming a P = 1 checkpoint at P = 2 without
    ``elastic`` raises, naming ``--elastic``."""
    p1 = str(tmp_path / "p1")
    with Trainer(TrainConfig(device="cpu", out_dir=p1, **SMALL)) as t:
        t.train(1)
        t.save()
    ranks = spawn(programs.resume_run, 2, dict(SMALL, nworkers=2),
                  str(tmp_path / "p2"), 4, 2, p1, backend="gloo",
                  device="cpu", timeout=300)
    for rank, out in enumerate(ranks):
        assert out["restored_step"] == 2 and out["step"] == 4
        assert out["full_losses"] == out["resumed_losses"]
        for name, t in out["full"].items():  # numpy, from the ranks
            np.testing.assert_array_equal(t, out["resumed"][name],
                                          err_msg=f"{rank} {name}")
        assert "--elastic" in out["other_p_error"]
    assert not np.array_equal(ranks[0]["full"]["residual"],
                              ranks[1]["full"]["residual"])
    hashes = set()
    for rank in range(2):
        recs = _records(tmp_path / "p2" / f"metrics.rank{rank}.jsonl")
        assert recs[0]["kind"] == "manifest" and recs[0]["rank"] == rank
        assert recs[0]["backend"] == "gloo" and recs[0]["world_size"] == 2
        hashes.add(recs[0]["config_hash"])
    assert len(hashes) == 1
    assert sorted(os.listdir(tmp_path / "p2" / "ckpt" / "2")) == [
        "rank0.pt", "rank1.pt"]


def test_config_mismatch_refused_unless_allowed(tmp_path):
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             **SMALL)) as t:
        t.train(1)
        t.save()
    other = dict(SMALL, density=0.02)
    with pytest.raises(CheckpointMismatch, match="config_hash"):
        Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                            resume=True, **other))
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             resume=True, allow_ckpt_mismatch=True,
                             **other)) as t:
        assert t.step == 1
    # A state of another structure (momentum correction adds "u").
    with pytest.raises(CheckpointMismatch, match="state digest"):
        Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                            resume=True, momentum_correction=True, **SMALL))


def test_torn_latest_step_restores_the_previous(tmp_path, caplog):
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             **SMALL)) as t:
        for _ in range(4):
            t.train(1)
            t.save()
        kept = sorted(os.listdir(tmp_path / "ckpt"))
        want = {name: v.clone() for name, v in t.checkpoint_state().items()}
    # max_to_keep = 3
    assert kept == ["2", "3", "4", "integrity-2.json", "integrity-3.json",
                    "integrity-4.json"]
    path = tmp_path / "ckpt" / "4" / "rank0.pt"
    path.write_bytes(path.read_bytes()[:1000])
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             resume=True, **SMALL)) as t:
        assert t.step == 3
        assert t._ckpt.last_restored_step == 3
        assert "FALLBACK" in caplog.text
        t.train(1)  # step 4 again, from step 3's state and batches
        for name, v in t.checkpoint_state().items():
            assert torch.equal(v, want[name]), name


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    with Trainer(TrainConfig(device="cpu", out_dir=str(tmp_path),
                             resume=True, **SMALL)) as t:
        assert t.step == 0 and not t.restore()


# ------------------------------------------------------------ the CLI

# JAX flags the port does not have yet, by ROADMAP.md item: the
# observability planes that read beyond one run (item 7c, second half).
MISSING_FLAGS = {
    # item 7c, the forecast plane and the run registry
    "--obs-forecast", "--obs-forecast-targets", "--obs-forecast-drift-x",
    "--registry",
    # item 7c, eviction (it reads the fleet's goodput)
    "--evict-after-windows",
}


def _flags(parser):
    return {opt: action for action in parser._actions
            for opt in action.option_strings if opt.startswith("--")}


def test_cli_flags_and_defaults_match_the_jax_cli():
    """Every flag the port shares with the JAX CLI has its name and
    default; the JAX flags the port lacks are exactly MISSING_FLAGS."""
    from gtopkssgd_tpu.dist_trainer import build_argparser as jax_parser

    port, jax = _flags(dist_trainer.build_argparser()), _flags(jax_parser())
    port.pop("--help", None)
    jax.pop("--help", None)
    # The port's own: the process group's backend, the device, and
    # --no-obs-* style negations the JAX parser spells out.
    own = {"--dist-backend", "--device"}
    assert set(port) - set(jax) == own
    missing = {f for f in set(jax) - set(port) if not f.startswith("--no-")}
    assert missing == MISSING_FLAGS
    for flag in set(port) & set(jax):
        assert port[flag].default == jax[flag].default, flag
    # 71 of the JAX CLI's 74 (--help aside, a --no- twin counts as one).
    assert len({a.dest for a in port.values()}) == 71
    assert len({a.dest for a in jax.values()}) == 74
    for flag in ("--out-dir", "--log-interval", "--resume",
                 "--allow-ckpt-mismatch", "--dtype", "--synth-hard",
                 "--prefetch", "--steps-per-dispatch", "--decode-workers",
                 "--inject", "--elastic", "--no-elastic", "--min-fleet",
                 "--preempt-save", "--no-preempt-save", "--multihost",
                 "--obs-counters", "--no-obs-counters", "--obs-interval",
                 "--obs-layers", "--no-obs-layers", "--obs-audit-interval",
                 "--obs-watchdog", "--obs-events", "--no-obs-events",
                 "--obs-halt-on", "--obs-timeline", "--obs-export-port",
                 "--recover-policy", "--profile-dir", "--profile-steps",
                 "--obs-goodput", "--no-obs-goodput",
                 "--obs-goodput-interval", "--obs-goodput-collapse-windows",
                 "--obs-calib", "--no-obs-calib", "--obs-calib-interval",
                 "--obs-critpath", "--no-obs-critpath",
                 "--obs-critpath-shift-windows", "--obs-linkmap",
                 "--no-obs-linkmap", "--obs-link-degraded-x",
                 "--obs-link-degraded-windows", "--obs-mem", "--no-obs-mem",
                 "--obs-mem-interval", "--obs-recompile-warmup",
                 "--obs-mem-leak-windows", "--obs-hbm-headroom-frac"):
        assert flag in port


def test_nworkers_zero_is_every_visible_device(capsys, monkeypatch):
    """``--nworkers 0`` (the default, as in JAX) trains one rank on the
    CPU and reads the card count on CUDA; ``resolved()`` refuses fewer
    than one rank, so the trainer never sees 0."""
    args = ["--batch-size", "4", "--num-iters", "1", "--eval-batches", "1",
            "--device", "cpu", "--prefetch", "0"]
    assert dist_trainer.main(args + ["--nworkers", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nworkers"] == 1 and out["step"] == 1
    parse = dist_trainer.build_argparser().parse_args
    assert parse([]).nworkers == 0
    assert dist_trainer.resolve_nworkers(parse(["--device", "cpu"])) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert dist_trainer.resolve_nworkers(parse([])) == 3
    assert dist_trainer.resolve_nworkers(parse(["--nworkers", "2"])) == 2
    for bad in (0, -1):
        with pytest.raises(ValueError, match="nworkers"):
            TrainConfig(nworkers=bad, device="cpu").resolved()


def test_cli_resumes_from_out_dir(tmp_path, capsys):
    args = ["--compression", "gtopk", "--density", "0.01", "--topk-method",
            "twostage", "--batch-size", "4", "--device", "cpu",
            "--eval-batches", "1", "--out-dir", str(tmp_path),
            "--log-interval", "1", "--synth-hard", "--prefetch", "1"]
    assert dist_trainer.main(args + ["--num-iters", "2"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["step"] == 2
    assert dist_trainer.main(args + ["--num-iters", "2", "--resume"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 4 and len(out["losses"]) == 2
    kinds = [r["kind"] for r in _records(tmp_path / "metrics.jsonl")]
    # The counters are on by default, as in the JAX CLI: an "obs" record
    # a step, and the span means with each "train" record; so is the
    # goodput ledger, whose summary closes each run.
    assert kinds == ["manifest", "obs", "train", "spans", "obs", "train",
                     "spans", "eval", "goodput"] * 2


# ------------------------------------------------------- JAX checkpoints

def test_a_jax_checkpoint_carries_into_the_port(tmp_path):
    """The JAX trainer saves with its own CheckpointManager; a fresh JAX
    trainer restores it with orbax, and its state, as numpy, goes into
    the port through ``convert.load_jax_state``, which also moves the
    port's step and data stream there (mid-epoch). One more step of
    each from there agrees: the loss within 1e-3 and the keep sets with a
    Jaccard index of at least 0.99, the slice test's tolerances (not
    bitwise: each framework's float32 gradient flips a few coordinates
    at tau, 0.9982 measured); the port's next batch is bitwise the one
    the JAX trainer reads there."""
    from gtopkssgd_tpu.trainer import TrainConfig as JaxConfig
    from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
    from gtopkssgd_tpu_torch.convert import load_jax_state
    from test_torch_slice import jax_state_as_numpy

    common = dict(dnn="resnet20", batch_size=8, compression="gtopk",
                  density=0.01, topk_method="pallas", max_epochs=1, seed=3)
    jcfg = JaxConfig(nworkers=1, prefetch=0, out_dir=str(tmp_path),
                     obs_counters=False, obs_goodput=False, **common)
    first = JaxTrainer(jcfg)
    first.train(3)
    first.save()
    jt = JaxTrainer(jcfg)
    assert jt.restore() and int(jt.state.step) == 3
    with Trainer(TrainConfig(device="cpu", **common)) as pt:
        assert pt.step == 0
        load_jax_state(pt, **jax_state_as_numpy(jt),
                       step=int(jt.state.step))
        assert pt.step == 3 and pt.optimizer.state["count"] == 3
        jloss = jt.train(1)["loss"]
        ploss = pt.train(1)["loss"]
        np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
        jkeep = np.asarray(jt.state.opt_state.residual) == 0
        pkeep = pt.optimizer.state["residual"].numpy() == 0
        jac = np.sum(jkeep & pkeep) / np.sum(jkeep | pkeep)
        assert jac >= MIN_JACCARD, jac  # 0.9982 measured
    # The stream moved to step 3: the next batch is the fourth of epoch 0.
    with Trainer(TrainConfig(device="cpu", prefetch=0, **common)) as fresh:
        load_jax_state(fresh, **jax_state_as_numpy(first), step=3)
        want = list(itertools.islice(fresh.train_data.epoch(0), 4))[3]
        got = fresh._next_host()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
