"""Dispatch stall watchdog, the port of ``gtopkssgd_tpu/obs/watchdog.py``:
fail fast with a diagnostic, never hang blind.

A step queued on the card that never completes (a wedged card, a lost
peer in a collective) blocks the next host read of a device value inside
the CUDA runtime, where Python cannot interrupt it. A monitor THREAD
notices that the training thread has waited too long, emits a structured
diagnostic (the last completed step, the span means, the device) and ends
the process with exit code 43 (``exit_codes.EXIT_STALL``), so the
supervisor gets its slot back.

Protocol (``Trainer.train`` wires it up):

    wd.arm("train", step=s)           # entering a region that must make
                                      # progress within deadline_s
    wd.heartbeat(step=s)              # progress proof -- resets the clock
                                      # (call AFTER a blocking device read,
                                      # not after an asynchronous launch)
    wd.disarm()                       # leaving the region

The device information is taken at construction (``torch.cuda`` and
``nvidia-smi``'s name and power limit, ``utils.manifest.card_identity``):
asking a wedged card from the monitor thread could itself hang.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

# Exit code for a detected stall, distinct from a generic failure so a
# supervisor can tell a hung run without parsing logs (exit_codes.py).
from gtopkssgd_tpu_torch.exit_codes import EXIT_STALL as STALL_EXIT_CODE


def _device_info() -> Dict[str, object]:
    """The backend, the card and its power limit, the visible cards."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"backend": "cpu", "device_kind": "cpu",
                    "device_count": 0}
        from gtopkssgd_tpu_torch.utils.manifest import card_identity

        info: Dict[str, object] = {
            "backend": "cuda",
            "device_kind": torch.cuda.get_device_name(
                torch.cuda.current_device()),
            "device_count": torch.cuda.device_count(),
        }
        try:
            info["card"] = card_identity()
        except Exception as e:  # no nvidia-smi on this host
            info["card"] = repr(e)
        return info
    except Exception as e:  # the runtime not initialized, or dead
        return {"error": repr(e)}


def _default_on_stall(record: Dict[str, object]) -> None:
    """Last-resort action: dump the diagnostic to stderr and hard-exit.
    os._exit, not sys.exit — the main thread is blocked in a C call and
    will never run an exception handler or atexit hook."""
    print("STALL WATCHDOG: " + json.dumps(record), file=sys.stderr,
          flush=True)
    os._exit(STALL_EXIT_CODE)


class StallWatchdog:
    """Monitor thread that fires when an armed region exceeds its deadline.

    ``on_stall(record)`` is called ONCE (from the monitor thread) with the
    structured diagnostic; the default dumps it to stderr and hard-exits
    with STALL_EXIT_CODE. ``diagnostics`` is an optional zero-arg callable
    whose dict is merged into the record at fire time (the trainer passes
    its span phase-means through here) — it must only touch host-side
    state, never the device."""

    def __init__(
        self,
        deadline_s: float,
        *,
        on_stall: Optional[Callable[[Dict[str, object]], None]] = None,
        diagnostics: Optional[Callable[[], Dict[str, object]]] = None,
        poll_s: Optional[float] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = poll_s if poll_s is not None else min(
            1.0, self.deadline_s / 4)
        self._on_stall = on_stall or _default_on_stall
        self._diagnostics = diagnostics
        self.device_info = _device_info()
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._label: Optional[str] = None
        self._armed_step: Optional[int] = None
        self._last_step: Optional[int] = None
        self._fired = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-stall-watchdog")
        self._thread.start()

    # ------------------------------------------------------------- control
    def arm(self, label: str, step: Optional[int] = None) -> None:
        with self._lock:
            self._armed_at = time.monotonic()
            self._label = label
            self._armed_step = step

    def heartbeat(self, step: Optional[int] = None) -> None:
        """Progress proof: resets the deadline clock; records the last
        step known complete. No-op when disarmed."""
        with self._lock:
            if step is not None:
                self._last_step = step
            if self._armed_at is not None:
                self._armed_at = time.monotonic()

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None
            self._label = None

    @contextmanager
    def watch(self, label: str, step: Optional[int] = None):
        self.arm(label, step)
        try:
            yield self
        finally:
            self.disarm()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self.poll_s + 1.0)

    # ------------------------------------------------------------- monitor
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed_at = self._armed_at
                label = self._label
                armed_step = self._armed_step
                last_step = self._last_step
            if armed_at is None or self._fired.is_set():
                continue
            waited = time.monotonic() - armed_at
            if waited < self.deadline_s:
                continue
            record: Dict[str, object] = {
                "kind": "stall",
                "time": time.time(),
                "label": label,
                "waited_s": round(waited, 3),
                "deadline_s": self.deadline_s,
                "armed_step": armed_step,
                "last_completed_step": last_step,
                "device": self.device_info,
            }
            if self._diagnostics is not None:
                try:
                    record.update(self._diagnostics() or {})
                except Exception as e:
                    record["diagnostics_error"] = repr(e)
            self._fired.set()
            self._on_stall(record)
