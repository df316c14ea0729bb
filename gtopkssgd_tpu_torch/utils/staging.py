"""Dispatch-grained host staging: a ring of reused host buffers that the
prefetch thread fills with whole dispatches.

A dispatch of K steps of m micro-batches reads K*m host batches. The
prefetch worker (``group_producer``) pulls them from the stream in order
and, where every field of every micro-batch has the shape and dtype the
ring's slots were made for, copies each micro-batch once into the rows of
a free slot: one tensor a field, shaped (K*m, *field shape), pinned for
the card. The consumer takes the ready slot, issues its asynchronous
copies to the device, records an event after them and hands the slot back
(``StagingRing.release``). The worker waits for a slot's event before it
writes the slot again, polling it against a stop flag, so a closing
prefetcher never hangs on it.

A group whose fields do not fit the slots (variable lengths, a shape
change, a field that is not an array) goes over as the plain list of its
micro-batches, in the same place in the stream: the consumer stacks and
copies it itself. The slots are made for the first group that fits and
kept for the ring's life, so a new prefetcher on the same ring (a
restore, a rollback) reuses them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

#: Seconds between two polls of a pending slot's event.
POLL_S = 2e-4

Host = Dict[str, np.ndarray]


class Slot:
    """One dispatch's host buffers: a tensor a field, shaped (K*m, *field
    shape), and the event recorded after the last copy out of them (None:
    nothing pending)."""

    __slots__ = ("fields", "event")

    def __init__(self, fields: Dict[str, torch.Tensor]):
        self.fields = fields
        self.event = None

    def hosts(self) -> List[Host]:
        """The slot's rows as micro-batches of numpy arrays, copied out."""
        n = len(next(iter(self.fields.values())))
        return [{key: t[i].numpy().copy() for key, t in self.fields.items()}
                for i in range(n)]


def _spec(hosts: List[Host]):
    """(count, ((field, shape, dtype), ...)) shared by every micro-batch
    of `hosts`; None where they differ or a field is not an array."""
    first = hosts[0]
    if not all(isinstance(v, np.ndarray) for v in first.values()):
        return None
    fields = tuple((key, v.shape, v.dtype) for key, v in first.items())
    for h in hosts[1:]:
        if len(h) != len(first) or any(
                not isinstance(h.get(key), np.ndarray)
                or h[key].shape != shape or h[key].dtype != dtype
                for key, shape, dtype in fields):
            return None
    return len(hosts), fields


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """`a` as a tensor sharing its memory; a copy only where its strides
    are negative (a flipped view), which tensors cannot hold."""
    if any(s < 0 for s in a.strides):
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


class StagingRing:
    """`count` reused slots of whole dispatches, made for the first group
    that fits (``fill``): pinned for a CUDA `device`, whose events the
    worker polls with that device current; plain tensors without one."""

    def __init__(self, count: int = 2,
                 device: Optional[torch.device] = None):
        if count < 2:
            raise ValueError(f"a ring needs 2 slots or more, got {count}")
        self.count = count
        if device is not None and device.index is None:  # "cuda": current
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self._slots: Optional[List[Slot]] = None
        self._spec = None
        self._free: queue.Queue = queue.Queue()

    def reset(self) -> None:
        """Every slot free, for a new prefetcher once the last one's worker
        has stopped. An event still pending keeps its slot unwritten."""
        self._free = queue.Queue()
        for slot in self._slots or ():
            self._free.put(slot)

    def _acquire(self, stop: threading.Event) -> Optional[Slot]:
        """A free slot whose last copy out has landed; None once `stop`
        is set."""
        while not stop.is_set():
            try:
                slot = self._free.get(timeout=0.05)
            except queue.Empty:
                continue
            while slot.event is not None and not slot.event.query():
                if stop.is_set():
                    return None
                time.sleep(POLL_S)
            return slot
        return None

    def fill(self, hosts: List[Host], stop: threading.Event
             ) -> Optional[Slot]:
        """The worker's side: `hosts` (one dispatch's micro-batches, in
        order) copied once into the rows of a free slot, which it returns;
        None where they do not fit the slots, or once `stop` is set."""
        spec = _spec(hosts)
        if spec is None:
            return None
        if self.device is not None:  # this thread's device, not card 0
            torch.cuda.set_device(self.device)
        if self._slots is None:
            self._spec = spec
            self._slots = [Slot({
                key: torch.empty((len(hosts),) + shape,
                                 dtype=torch.from_numpy(
                                     np.empty(0, dtype)).dtype,
                                 pin_memory=self.device is not None)
                for key, shape, dtype in spec[1]})
                for _ in range(self.count)]
            self.reset()
        elif spec != self._spec:
            return None
        slot = self._acquire(stop)
        if slot is None:
            return None
        for i, h in enumerate(hosts):
            for key, t in slot.fields.items():
                t[i].copy_(_as_tensor(h[key]))
        return slot

    def release(self, slot: Slot) -> None:
        """The consumer's side: `slot` back to the free list, its event
        (``slot.event``) recorded after its last copy out."""
        self._free.put(slot)


def group_producer(pull: Callable[[], Host], n: int,
                   ring: Optional[StagingRing], stop: threading.Event
                   ) -> Callable[[], Union[Slot, List[Host]]]:
    """A prefetcher's ``produce``: the next `n` micro-batches of `pull`,
    in order, staged into a slot of `ring` where they fit, else as the
    plain list."""
    def produce():
        hosts = [pull() for _ in range(n)]
        slot = ring.fill(hosts, stop) if ring is not None else None
        return hosts if slot is None else slot

    return produce
