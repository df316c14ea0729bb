"""The idle readers: the median over the program's record of the
device's idle split (``obs.tracing.idle``) in ms a step, and None where
the record is empty or the program keeps none (a program before it)."""

from __future__ import annotations

import pytest

from gtopkssgd_tpu_torch.obs import tracing
from portbench import spec
from portbench.metrics import idle_data_ms, idle_tail_ms


def test_readers_take_the_median_in_ms(monkeypatch):
    monkeypatch.setattr(tracing, "idle", [
        (8, 0.004, 0.0001), (8, 0.005, 0.0003), (8, 0.090, 0.0002)])
    assert idle_data_ms.read(None) == pytest.approx(5.0)
    assert idle_tail_ms.read(None) == pytest.approx(0.2)


def test_readers_find_nothing_in_an_empty_record(monkeypatch):
    monkeypatch.setattr(tracing, "idle", [])
    assert idle_data_ms.read(None) is None
    assert idle_tail_ms.read(None) is None


def test_readers_find_nothing_in_a_program_without_the_record(monkeypatch):
    monkeypatch.delattr(tracing, "idle")
    assert idle_data_ms.read(None) is None
    assert idle_tail_ms.read(None) is None


def test_both_cells_report_both():
    for cell in ("resnet50.gtopk.b32.p1", "alexnet.gtopk.b64.p1"):
        names = [m["name"] for m in spec.Cell(cell).per_layer]
        assert {"idle_data_ms", "idle_tail_ms"} <= set(names)
        assert spec.reader("idle_data_ms") is idle_data_ms.read
