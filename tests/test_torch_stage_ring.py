"""Dispatch-grained staging (``utils.staging`` and ``Trainer._stage``):
the prefetch worker groups a dispatch's micro-batches and copies them
once into a reused ring slot. On the CPU the pinned slots are plain
tensors: the groups against ``np.stack``, the fallback on a shape change,
the loss trajectory with and without the grouping, the worker's wait on a
slot's event and the close that ends it, and the "spans" keys. On the
card (skipped here): a graph dispatch from the ring against
``prefetch=0``, and slots that outlive a delayed copy. This file imports
no JAX, so the card runs it with ``--noconftest``.
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer, _stop_prefetch
from gtopkssgd_tpu_torch.utils.prefetch import Prefetcher
from gtopkssgd_tpu_torch.utils.staging import (
    Slot,
    StagingRing,
    group_producer,
)

SMALL = dict(dnn="resnet20", batch_size=4, compression="gtopk",
             density=0.01, topk_method="twostage", eval_batches=1)


def _stream(shape=(2, 4, 4, 3), odd=None):
    """Micro-batches b = 0, 1, ...: uint8 images and int32 labels drawn
    from b, the label's first entry b itself; micro-batch `odd` one row
    longer."""
    for b in itertools.count():
        rng = np.random.default_rng(b)
        n = shape[0] + (b == odd)
        label = rng.integers(0, 10, n, dtype=np.int32)
        label[0] = b
        yield {"image": rng.integers(0, 256, (n,) + shape[1:],
                                     dtype=np.uint8),
               "label": label}


def _order(group):
    """The stream indices of a group's micro-batches."""
    if isinstance(group, Slot):
        return group.fields["label"][:, 0].tolist()
    return [int(h["label"][0]) for h in group]


def _ring_trainer(**kw):
    """A CPU Trainer whose prefetcher stages into a ring of plain
    tensors, as the card's does into pinned ones."""
    t = Trainer(TrainConfig(device="cpu", **kw))
    t._ring = StagingRing(t._group_depth + 1)
    t._set_iters(0)
    return t


class _Event:
    """An event that completes once the test sets ``done``; counts the
    worker's queries."""

    def __init__(self):
        self.done = False
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.done


def _polled(events, timeout=10.0):
    """Wait until the worker has queried one of `events` twice."""
    deadline = time.monotonic() + timeout
    while not any(ev.queries >= 2 for ev in events):
        assert time.monotonic() < deadline, "the worker never polled"
        time.sleep(0.001)


@pytest.mark.parametrize("k,m", [(1, 1), (1, 2), (8, 1), (8, 2)])
def test_ring_groups_equal_np_stack(k, m):
    """Three dispatches through a 2-slot ring: each slot holds, bitwise,
    ``np.stack`` of the same K*m micro-batches, and the slots are
    reused."""
    n = k * m
    ring = StagingRing(2)
    produce = group_producer(_stream().__next__, n, ring, threading.Event())
    want = _stream()
    seen = []
    for _ in range(3):
        slot = produce()
        assert isinstance(slot, Slot)
        hosts = [next(want) for _ in range(n)]
        for key in ("image", "label"):
            got = slot.fields[key].numpy()
            ref = np.stack([h[key] for h in hosts])
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        seen.append(id(slot))
        ring.release(slot)
    assert len(set(seen)) == 2


@pytest.mark.parametrize("odd", [5, 1], ids=["mid-stream", "first-group"])
def test_shape_change_falls_back_for_that_group_in_order(odd):
    """A micro-batch one row longer sends its group over as the plain
    list; the groups before and after it come from the ring, and the
    stream keeps its order."""
    ring = StagingRing(2)
    produce = group_producer(_stream(odd=odd).__next__, 4, ring,
                             threading.Event())
    routes, order = [], []
    for _ in range(4):
        g = produce()
        routes.append(isinstance(g, Slot))
        order += _order(g)  # read before the slot goes back
        if isinstance(g, Slot):
            ring.release(g)
        else:
            assert len(g[odd % 4]["label"]) == 3
    assert routes == [i != odd // 4 for i in range(4)]
    assert order == list(range(16))


@pytest.mark.parametrize("route", ["plain", "ring"])
def test_cpu_trainer_losses_bitwise_with_and_without_grouping(route):
    """K = 4, three dispatches: the losses with the worker's grouping (its
    plain groups on the CPU, or a ring of plain tensors) equal, bitwise,
    those of ``prefetch=0``; every dispatch is counted, from the ring
    where there is one."""
    cfg = dict(SMALL, steps_per_dispatch=4)
    with Trainer(TrainConfig(device="cpu", prefetch=0, **cfg)) as t:
        want = t.train(12)["losses"]
        assert t.stage_stats["dispatches"] == 0
    make = (_ring_trainer if route == "ring"
            else lambda **kw: Trainer(TrainConfig(device="cpu", **kw)))
    with make(prefetch=2, **cfg) as t:
        got = t.train(12)["losses"]
        stats = dict(t.stage_stats)
    assert got == want
    assert stats["dispatches"] == 3
    assert stats["ring"] == (3 if route == "ring" else 0)
    assert stats["wait_s"] >= 0.0


def test_card_rule_engages_the_ring_only_where_it_fits():
    """The ring is made on the card with a prefetcher and no injector;
    on the CPU, as here, never."""
    with Trainer(TrainConfig(device="cpu", steps_per_dispatch=2,
                             **SMALL)) as t:
        assert t._ring is None and t._group == 2 and t._group_depth == 1


def test_next_host_takes_a_ring_group_apart_in_order():
    """``_next_host`` hands out a slot's rows one micro-batch at a time;
    a dispatch staged while some are left takes them one by one too, the
    next one, aligned again, comes from the ring, and the stream stays
    the stream ``prefetch=0`` reads."""
    cfg = dict(SMALL, steps_per_dispatch=2)
    with Trainer(TrainConfig(device="cpu", prefetch=0, **cfg)) as t:
        want = [t._next_host()["image"] for _ in range(6)]
    with _ring_trainer(prefetch=2, **cfg) as t:
        got = [t._next_host()["image"]]
        for fetch in ("stage", "host", "stage"):
            if fetch == "host":
                got.append(t._next_host()["image"])
                assert t.stage_stats["dispatches"] == 0
                continue
            got += [mb["image"].numpy() for step in t._stage(2)
                    for mb in step]
        assert t.stage_stats["dispatches"] == t.stage_stats["ring"] == 1
    assert len(got) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_worker_waits_for_a_slots_event_before_writing():
    """A slot handed back with a pending event keeps its rows until the
    event completes: the worker polls it and only then writes."""
    ring = StagingRing(2)
    stop = threading.Event()
    pf = Prefetcher(group_producer(_stream().__next__, 2, ring, stop),
                    depth=1)
    try:
        a = next(pf)
        rows = a.fields["image"].clone()
        a.event = _Event()
        ring.release(a)
        b = next(pf)  # the worker then takes `a` and waits on it
        _polled([a.event])
        assert torch.equal(a.fields["image"], rows) and _order(a) == [0, 1]
        a.event.done = True
        ring.release(b)
        c = next(pf)
        assert c is a and _order(c) == [4, 5]
    finally:
        _stop_prefetch(pf, stop)


def test_close_returns_while_a_slot_event_is_pending():
    """Both slots handed back with events that never complete: the worker
    polls one of them, and the close ends its wait and joins it."""
    ring = StagingRing(2)
    stop = threading.Event()
    pf = Prefetcher(group_producer(_stream().__next__, 2, ring, stop),
                    depth=1)
    never = []
    for _ in range(2):
        slot = next(pf)
        slot.event = _Event()
        never.append(slot.event)
        ring.release(slot)
    _polled(never)
    t0 = time.monotonic()
    _stop_prefetch(pf, stop)
    assert time.monotonic() - t0 < 5.0
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("route", ["prefetch0", "plain", "ring"])
def test_spans_record_has_staging_keys_only_from_the_ring(tmp_path, route):
    """``staging/ring_share`` and ``staging/wait`` appear in the "spans"
    records of a run whose dispatches came from the ring, and in no
    other."""
    cfg = dict(SMALL, steps_per_dispatch=2, log_interval=2,
               out_dir=str(tmp_path), prefetch=0 if route == "prefetch0"
               else 2)
    make = (_ring_trainer if route == "ring"
            else lambda **kw: Trainer(TrainConfig(device="cpu", **kw)))
    with make(**cfg) as t:
        t.train(4)
    spans = [r for r in map(json.loads, open(tmp_path / "metrics.jsonl"))
             if r["kind"] == "spans"]
    assert len(spans) == 2
    for r in spans:
        if route == "ring":
            assert r["staging/ring_share"] == 1.0
            assert r["staging/wait"] >= 0.0
        else:
            assert "staging/ring_share" not in r
            assert "staging/wait" not in r


# ---------------------------------------------------------------- card

K = 8


def _card(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dict(SMALL, batch_size=32, device="cuda", steps_per_dispatch=K)
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


@pytest.mark.cuda
def test_graph_dispatch_from_the_ring_matches_prefetch0_on_card():
    """Four graph dispatches of K = 8 under deterministic algorithms
    (cuDNN's default convolution backward is not): the losses and the
    state from the ring equal, bitwise, those of ``prefetch=0``, and
    every dispatch came from the ring. The stream sleeps before the
    first dispatch, so the prefetch thread polls the first slot's event
    while the step is captured."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with _card(prefetch=0) as t:
            want = t.train(4 * K)
            want_state = t.checkpoint_state()
            assert t._ring is None
        with _card(prefetch=2) as t:
            torch.cuda._sleep(200_000_000)  # about 0.1 s
            got = t.train(4 * K)
            got_state = t.checkpoint_state()
            stats = dict(t.stage_stats)
            assert t._ring is not None and t._ring.device.type == "cuda"
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    assert want["dispatch"] == got["dispatch"] == "graph"
    assert got["losses"] == want["losses"]
    for name, t in got_state.items():
        assert torch.equal(t, want_state[name]), name
    assert stats["dispatches"] == stats["ring"] == 4


@pytest.mark.cuda
def test_no_slot_is_overwritten_before_its_copy_lands_on_card():
    """The stream sleeps on the card before each dispatch's copy, so the
    copy lands long after its slot went back to the worker: every staged
    device batch still equals its source micro-batches."""
    with _card(prefetch=2, steps_per_dispatch=4) as t:
        data = t.train_data
        want = itertools.chain.from_iterable(
            data.epoch(e) for e in itertools.count())
        for _ in range(6):
            torch.cuda._sleep(50_000_000)  # about 25 ms
            staged = t._stage(4)
            torch.cuda.synchronize()
            for step in staged:
                for mb in step:
                    ref = next(want)
                    for key in ("image", "label"):
                        np.testing.assert_array_equal(mb[key].cpu().numpy(),
                                                      ref[key])
        assert t.stage_stats["ring"] == 6
