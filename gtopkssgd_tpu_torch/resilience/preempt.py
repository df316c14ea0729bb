"""Preemption handling and the shared retry helper, the port of
``gtopkssgd_tpu/resilience/preempt.py``.

The contract: a SIGTERM (or SIGINT) reaches a process whose
``PreemptionGuard`` is installed; the handler only sets a flag (a handler
must be async-signal-safe: no I/O, no device sync); the trainer reads the
flag at its next dispatch boundary, saves a step-granular emergency
checkpoint and raises ``Preempted``; the command line exits
``PREEMPT_EXIT_CODE`` (45). ``--resume`` then restores that step and
fast-forwards the data stream mid-epoch, so the resumed run is the
uninterrupted one. At P ranks the flag is agreed on at the boundary
(``Trainer._stop_requested``), so every rank saves the same step.

``retry_call`` is the transient-failure helper (exponential backoff,
bounded attempts) around ``torch.distributed.init_process_group`` under
``--multihost`` and the host batch fetch (how an injected
``loader_raise`` is absorbed).
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional, Tuple, Type

from gtopkssgd_tpu_torch.exit_codes import EXIT_PREEMPTED as PREEMPT_EXIT_CODE


class Preempted(RuntimeError):
    """Raised by the trainer once the emergency checkpoint is on disk; the
    command line maps it to ``PREEMPT_EXIT_CODE``."""


class PreemptionGuard:
    """Flag-setting SIGTERM/SIGINT handlers, the old ones restored on
    ``close()``.

    Installed by the command line, not by ``Trainer``: a library object
    must not take the host process's signal handlers. The handler only
    sets ``triggered``; the save happens on the training thread at the
    next dispatch boundary."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT),
                 logger=None):
        self.signals = signals
        self.logger = logger
        self.triggered = False
        self.signum: Optional[int] = None
        self._old: dict = {}
        self._installed = False

    def _handler(self, signum, frame):
        self.triggered = True
        self.signum = signum

    def install(self) -> "PreemptionGuard":
        """Idempotent; off the main thread (where ``signal.signal``
        raises) the guard stays inert rather than failing the run."""
        if self._installed:
            return self
        try:
            for sig in self.signals:
                self._old[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:
            if self.logger is not None:
                self.logger.warning(
                    "preemption guard: not on the main thread; signals "
                    "not intercepted")
        return self

    def close(self) -> None:
        """Restore the original handlers."""
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.close()


def retry_call(fn: Callable[[], Any], *, retries: int = 3,
               delay: float = 0.5, backoff: float = 2.0,
               exceptions: Tuple[Type[BaseException], ...] = (Exception,),
               logger=None, desc: str = "call") -> Any:
    """``fn()`` with up to `retries` retries on `exceptions`, sleeping
    delay * backoff**attempt between tries; the last failure re-raises
    the original exception."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            if attempt >= retries:
                raise
            wait = delay * (backoff ** attempt)
            attempt += 1
            if logger is not None:
                logger.warning(
                    "%s failed (%s: %s); retry %d/%d in %.2gs",
                    desc, type(e).__name__, e, attempt, retries, wait)
            time.sleep(wait)
