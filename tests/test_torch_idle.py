"""The device's idle time between dispatches on its own clock
(``obs.tracing``: ``split_gap``, ``Tracer.mark``, ``Tracer.idle_split``
and the record ``idle``): the gap arithmetic over fake mark times, the
CPU trainer that records nothing, the "spans" keys, and on the card
(skipped here) the record a graph dispatch fills and known sleeps in the
host's staging and between dispatches, each landing in its own part.
This file imports no JAX, so the card runs it with ``--noconftest``.
"""

import json
import statistics
import time

import pytest
import torch

from gtopkssgd_tpu_torch.obs import tracing
from gtopkssgd_tpu_torch.obs.tracing import Tracer, split_gap
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer
from gtopkssgd_tpu_torch.utils.metrics import MetricsLogger
from portbench.metrics import idle_data_ms, idle_tail_ms

SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", eval_batches=1)


@pytest.mark.parametrize("marks,want", [
    # end(n-1) at 0: staging opens 2 ms later, the first copy at 10 ms,
    # over 2 steps.
    ((0.0, 0.002, 0.010, 2), (0.004, 0.001)),
    # staging opened before the previous dispatch's end: all staging.
    ((0.0, -0.003, 0.004, 1), (0.004, 0.0)),
    # an empty staging: the first copy as staging opens.
    ((0.0, 0.006, 0.006, 3), (0.0, 0.002)),
    # a first dispatch: no previous end, no record.
    ((None, 0.001, 0.004, 1), None),
], ids=["serial", "overlapped", "empty-staging", "first-dispatch"])
def test_split_gap(marks, want):
    got = split_gap(*marks)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, abs=1e-12)
        assert sum(got) * marks[3] == pytest.approx(marks[2] - marks[0])


def test_cpu_trainer_records_nothing():
    """A Trainer on the CPU marks nothing and records no split: the
    record (emptied as the Trainer is built) stays empty, its "spans"
    records carry no idle keys, and both readers find nothing."""
    tracing.idle.append((4, 1.0, 1.0))
    with Trainer(TrainConfig(device="cpu", steps_per_dispatch=2,
                             log_interval=2, **SMALL)) as t:
        assert list(tracing.idle) == []
        t.train(4)
        assert list(tracing.idle) == []
    assert idle_data_ms.read(None) is None
    assert idle_tail_ms.read(None) is None


def test_flush_writes_the_idle_keys_only_with_a_record(tmp_path):
    with MetricsLogger(str(tmp_path)) as metrics:
        tr = Tracer(metrics=metrics)
        with tr.span("data"):
            pass
        assert "device_idle/data" not in tr.flush(step=1)
        with tr.span("data"):
            pass
        # Two dispatches' splits, of 2 and 6 steps: step-weighted means.
        tr._idle.extend([(2, 0.004, 0.001), (6, 0.002, 0.003)])
        got = tr.flush(step=2)
        assert got["device_idle/data"] == pytest.approx(0.0025)
        assert got["device_idle/tail"] == pytest.approx(0.0025)
        assert "device_idle/data" not in tr.flush(step=3)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    spans = [r for r in recs if r["kind"] == "spans"]
    assert [r["step"] for r in spans] == [1, 2]
    assert "device_idle/tail" not in spans[0]
    assert spans[1]["device_idle/data"] == 0.0025
    assert spans[1]["device_idle/tail"] == 0.0025


# ---------------------------------------------------------------- card

K = 4
DISPATCHES = 12


def _card_trainer(monkeypatch, pause):
    """A graph dispatch of K steps whose host fetch hands back one fixed
    batch after sleeping `pause` seconds (``pause[0]``, which the test
    may change): staging is then the sleeps, the stack and the copy, and
    no generator or prefetch thread moves it between runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = Trainer(TrainConfig(**dict(SMALL, batch_size=32, device="cuda",
                                   steps_per_dispatch=K, prefetch=0)))
    batch = t._next_host()

    def fetch(k=1):
        time.sleep(pause[0])
        return batch

    monkeypatch.setattr(t, "_next_host", fetch)
    return t


def _medians(t, dispatches=DISPATCHES, between=0.0):
    """The median idle_data and idle_tail, ms a step, over `dispatches`
    dispatches of `t`, sleeping `between` seconds between them."""
    tracing.idle.clear()
    for _ in range(dispatches):
        t.train(K)
        time.sleep(between)
    assert len(tracing.idle) == dispatches
    return (1e3 * statistics.median(r[1] for r in tracing.idle),
            1e3 * statistics.median(r[2] for r in tracing.idle))


@pytest.mark.cuda
def test_graph_dispatch_fills_the_idle_record_on_card(monkeypatch):
    """One record a dispatch after the first, each of K steps; every
    event read is complete when it is read (no sync of its own)."""
    reads = []
    elapsed = torch.cuda.Event.elapsed_time

    def checked(self, other):
        reads.append(self.query() and other.query())
        return elapsed(self, other)

    monkeypatch.setattr(torch.cuda.Event, "elapsed_time", checked)
    with _card_trainer(monkeypatch, [0.0]) as t:
        assert list(tracing.idle) == []
        out = t.train(6 * K)
        record = list(tracing.idle)
    assert out["dispatch"] == "graph"
    assert len(record) == 5 and len(reads) == 10 and all(reads)
    for steps, data, tail in record:
        assert steps == K and data >= 0.0 and tail >= 0.0
    assert idle_data_ms.read(None) is not None
    assert idle_tail_ms.read(None) is not None


@pytest.mark.cuda
def test_staging_sleep_lands_in_idle_data_on_card(monkeypatch):
    """A sleep of s a micro-batch inside staging raises idle_data by s a
    step (within 25%) and leaves idle_tail where it was."""
    s, pause = 0.02, [0.0]
    with _card_trainer(monkeypatch, pause) as t:
        t.train(2 * K)  # the capture
        data0, tail0 = _medians(t)
        pause[0] = s
        data1, tail1 = _medians(t)
    assert data1 - data0 == pytest.approx(1e3 * s, rel=0.25)
    assert abs(tail1 - tail0) < 0.25 * 1e3 * s


@pytest.mark.cuda
def test_caller_sleep_lands_in_idle_tail_on_card(monkeypatch):
    """A sleep of t between ``train(K)`` calls raises idle_tail by t / K
    a step (within 25%) and leaves idle_data where it was."""
    pause = 0.04
    with _card_trainer(monkeypatch, [0.0]) as t:
        t.train(2 * K)
        data0, tail0 = _medians(t)
        data1, tail1 = _medians(t, between=pause)
    assert tail1 - tail0 == pytest.approx(1e3 * pause / K, rel=0.25)
    assert abs(data1 - data0) < 0.25 * 1e3 * pause / K
