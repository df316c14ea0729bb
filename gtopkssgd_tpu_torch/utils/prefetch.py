"""Background host-batch prefetcher, the port of
``gtopkssgd_tpu/utils/prefetch.py``: one daemon thread assembles numpy
batches (augmentation included; the native library releases the GIL)
while the device runs the step.

* Order: one worker pulls from the underlying iterator in order, so the
  stream is the synchronous stream.
* The worker touches numpy only; the copy to the device stays on the
  consumer thread.
* A worker's exception is re-raised at the consumer's next ``__next__``,
  and every call after it raises too.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class Prefetcher:
    """A zero-argument `produce` (returns the next host batch) behind a
    bounded queue of `depth` batches assembled ahead."""

    _STOP = object()

    def __init__(self, produce: Callable[[], object], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._produce()
            except BaseException as e:  # handed to the consumer
                self._err = e
                self._q.put(self._STOP)
                return
            while not self._stop.is_set():  # a put that close() can end
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise RuntimeError("prefetcher is closed")
        if self._err is not None:
            raise RuntimeError("prefetch worker failed") from self._err
        item = self._q.get()
        if item is self._STOP:
            raise RuntimeError("prefetch worker failed") from self._err
        return item

    def close(self):
        """Stop the worker and drop the queued batches. Raises if the
        worker cannot be joined: a replacement must never race it on the
        same iterator."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "prefetch worker did not stop within 60 s; refusing to "
                "hand its iterator to a replacement")
