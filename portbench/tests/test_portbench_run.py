"""The run's refusals, the trace's reading, and ``correct`` against the
faults planted under the timed path (the harness's look for a card
skipped: a tiny cell on the CPU, held to the real cell's limits)."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import check, spec, trace
from portbench.rank import rank_main


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "resnet50.gtopk.b32.p1", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _run(spec.ROOT, env)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    got = _run(str(tmp_path), env)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _two_steps():
    """Two steps of 100 us: forward_backward launches a 30 us kernel from
    the trainer's thread and a 10 us one from another thread; select a 5
    us one inside optimizer."""
    evs = []
    for s in range(2):
        t = 100.0 * s
        evs += [_ev("user_annotation", trace.STEP_RANGE, t, 100),
                _ev("user_annotation", "data", t, 10),
                _ev("user_annotation", "forward_backward", t + 10, 50),
                _ev("user_annotation", "optimizer", t + 60, 30),
                _ev("user_annotation", "select", t + 65, 10),
                _ev("cuda_runtime", "cudaLaunchKernel", t + 12, 1, 3 * s),
                _ev("cuda_runtime", "cudaLaunchKernel", t + 40, 1, 3 * s + 1,
                    tid=2),
                _ev("cuda_runtime", "cudaLaunchKernel", t + 66, 1,
                    3 * s + 2),
                _ev("kernel", "conv", t + 13, 30, 3 * s),
                _ev("kernel", "conv_bwd", t + 45, 10, 3 * s + 1),
                _ev("kernel", "stage1", t + 70, 5, 3 * s + 2)]
    return evs


def test_trace_attribution():
    got = trace.summarize(_two_steps())
    assert got["steps"] == 2
    assert got["device_ms"]["forward_backward"] == pytest.approx(0.040)
    assert got["device_ms"]["optimizer"] == pytest.approx(0.005)
    assert got["device_ms"]["select"] == pytest.approx(0.005)
    assert got["host_ms"]["data"] == pytest.approx(0.010)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops["conv"] == pytest.approx(60e-6)
    assert sum(v for _, v in got["breakdown"]["idle_gaps"]) == \
        pytest.approx(200e-6 - 90e-6)
    assert got["busy_s"] == pytest.approx(90e-6)
    assert got["window_s"] == pytest.approx(200e-6)


def test_todays_cells_read_todays_ranges():
    """No metric of today's cells declares a range, so each cell's trace
    is read by the ranges it was read by before metrics could add any,
    and its summary is the same."""
    evs = _two_steps()
    for w in spec.benchmark()["workloads"]:
        ranges = trace.cell_ranges(spec.Cell(w["name"]))
        assert ranges == ("data", "dispatch", "forward_backward",
                          "optimizer", "select", "exchange", "obs_read",
                          trace.STEP_RANGE)
        assert trace.summarize(evs, 2, None, ranges) == \
            trace.summarize(evs, 2)


def test_graph_replays_take_the_capture_ranges():
    """A capture launches three nodes (two in forward_backward, one in
    select inside optimizer) that run nothing; a replay's three device
    operations, launched by one graph launch, take their ranges by
    order."""
    capture = [_ev("user_annotation", "forward_backward", 0, 20),
               _ev("user_annotation", "optimizer", 20, 20),
               _ev("user_annotation", "select", 25, 10),
               _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, 1),
               _ev("cuda_driver", "cuLaunchKernel", 5, 1, 2),
               _ev("cuda_runtime", "cudaMemsetAsync", 27, 1, 3)]
    nodes = trace.graph_nodes(capture)
    assert nodes == [frozenset({"forward_backward"}),
                     frozenset({"forward_backward"}),
                     frozenset({"optimizer", "select"})]
    replay = [_ev("user_annotation", trace.STEP_RANGE, 100, 50),
              _ev("cuda_runtime", "cudaGraphLaunch", 101, 1, 9),
              _ev("kernel", "conv", 110, 10, 9),
              _ev("kernel", "conv_bwd", 120, 10, 9),
              _ev("gpu_memset", "Memset", 130, 5, 9)]
    got = trace.summarize(replay, 2, nodes)
    assert got["replays_attributed"] == 1
    assert got["device_ms"]["forward_backward"] == pytest.approx(0.010)
    assert got["device_ms"]["select"] == pytest.approx(0.0025)
    assert trace.summarize(replay, 2, nodes[:2])["device_ms"] == {}


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch"])
def test_correct_at_p1(tiny_root, fault):
    got = rank_main("cpu", "tiny.p1", 2 ** 31 + 21, 0.0, False, time.time(),
                    tiny_root, fault=fault, window=False)
    cell = spec.Cell("tiny.p1", tiny_root)
    assert check.passed(check.verdict(got["numbers"], cell.limits)) is (
        fault is None)


def test_correct_at_p4_without_the_exchange(tiny_root):
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    ranks = spawn(rank_main, 4, "tiny.p4", 2 ** 31 + 22, 0.0, False,
                  time.time(), tiny_root, "no_exchange", False,
                  backend="gloo", device="cpu", timeout=900)
    cell = spec.Cell("tiny.p4", tiny_root)
    for r in ranks:
        assert not check.passed(check.verdict(r["numbers"], cell.limits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet50.gtopk.b32.p1",
                                  "alexnet.gtopk.b64.p1",
                                  "alexnet.dense.b64.p1"])
def test_the_precision_control_fails_on_the_card(card, name):
    """The reference with its operands in fp8, in the program's place, at
    the cell's own size: not correct on three seeds."""
    from portbench.readings import control_numbers

    cell = spec.Cell(name)
    for seed in (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33):
        numbers = control_numbers(cell, seed, 0, card)
        assert not check.passed(check.verdict(numbers, cell.limits))
