"""Deterministic, step-keyed fault injection (``--inject SPEC``), the
port of ``gtopkssgd_tpu/resilience/inject.py``: the same grammar, parsed
the same way, and the same firings on the port's trainer.

Faults are keyed to the optimizer step, so a spec perturbs the same point
of the same data stream on every run. Grammar (comma-separated faults)::

    SPEC  := FAULT ("," FAULT)*
    FAULT := KIND (":" ARG)* "@" WHEN
    WHEN  := STEP | STEP "-" STEP | "latest"       (steps are 1-based)

Kinds:

  nan_grad@K          multiply the first parameter by NaN before step K:
                      the loss and the gradients go NaN as in a real
                      blow-up. A point fault fires once; a range
                      (``@2-99``) fires every step of the window.
  slow_rank:R:DUR@A-B sleep DUR (``2.5s`` or ``0.1``) before each step in
                      [A, B] on rank R: a deterministic straggler.
  loader_raise@K      raise InjectedLoaderError from the host batch fetch
                      at step K, once; the trainer's ``retry_call``
                      around the fetch absorbs it.
  preempt@K           a real SIGTERM to this process right after step K's
                      dispatch, through the installed PreemptionGuard.
                      At P ranks only rank 0 is signalled, as when one
                      host of a job is preempted: the ranks' agreement at
                      the boundary stops every rank at the same step.
  corrupt_ckpt@latest truncate the files of the newest checkpoint step
                      right before the next restore: the torn-step
                      fallback to the previous step.
  reshape@K           halve the batch axis of step K's host batch (a new
                      shape a dispatch; a graph dispatch runs that step
                      eagerly). A point fault fires once.
  resize@K:NEWP       an elastic resize at the step-K boundary: drain,
                      save, rewrite ``elastic.json`` for NEWP ranks, exit
                      46 (``resilience.elastic``). Needs ``--elastic``;
                      without it the firing is recorded and ignored.
  evict_rank:R@K      the same resize to P - 1 with rank R named as
                      evicted. Point fault only; needs ``--elastic``.

Every firing writes one flushed "inject" record (fault, step, spec and
details) through ``utils.metrics``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, List, Optional, Tuple

KINDS = ("nan_grad", "slow_rank", "loader_raise", "preempt", "corrupt_ckpt",
         "reshape", "resize", "evict_rank")

# WHEN == "latest" sentinel (corrupt_ckpt: fires at the next restore).
LATEST = -1


class InjectedLoaderError(IOError):
    """The loader_raise fault; retried away by resilience.retry_call."""


@dataclasses.dataclass
class Fault:
    kind: str
    start: int           # first step of the window (LATEST for @latest)
    end: int             # last step (== start for point faults)
    args: Tuple[str, ...] = ()
    fired: int = 0       # firings so far; point faults are consumed at 1

    @property
    def point(self) -> bool:
        return self.start == self.end

    def window(self, prev: int, new: int) -> Optional[int]:
        """The step in (prev, new] this fault fires for, or None. Point
        faults never re-fire (a skip-recovery rewinds the step counter
        past an already-consumed fault); range faults fire once per
        dispatch while the window overlaps."""
        if self.start == LATEST:
            return None
        if self.point and self.fired:
            return None
        lo, hi = max(self.start, prev + 1), min(self.end, new)
        return lo if lo <= hi else None

    def spec(self) -> str:
        if self.kind == "resize":
            # canonical grammar puts the target P after the step:
            # resize@K:NEWP (args holds NEWP; see parse_inject)
            return f"resize@{self.start}:{self.args[0]}"
        head = ":".join((self.kind,) + self.args)
        if self.start == LATEST:
            return f"{head}@latest"
        if self.point:
            return f"{head}@{self.start}"
        return f"{head}@{self.start}-{self.end}"


def _parse_duration(text: str) -> float:
    seconds = float(text[:-1] if text.endswith("s") else text)
    if seconds < 0:
        raise ValueError(f"negative duration {text!r}")
    return seconds


def parse_inject(spec: str) -> List[Fault]:
    """Parse an ``--inject`` spec; raises ValueError with the offending
    fragment on any malformed input (fail at argparse time, not at step
    K three hours in)."""
    faults: List[Fault] = []
    for frag in (f.strip() for f in spec.split(",") if f.strip()):
        if "@" not in frag:
            raise ValueError(
                f"inject fault {frag!r} has no '@WHEN' (grammar: "
                "KIND[:ARG...]@STEP|A-B|latest)")
        head, _, when = frag.rpartition("@")
        parts = head.split(":")
        kind, args = parts[0], tuple(parts[1:])
        if kind not in KINDS:
            raise ValueError(
                f"unknown inject kind {kind!r} (known: {', '.join(KINDS)})")
        if when == "latest":
            if kind != "corrupt_ckpt":
                raise ValueError(
                    f"@latest only applies to corrupt_ckpt, not {kind!r}")
            start = end = LATEST
        elif kind == "resize":
            # resize@K:NEWP — the WHEN carries the target fleet size,
            # so the generic STEP|A-B parse below does not apply.
            if args:
                raise ValueError(
                    f"resize takes no ':' args before '@'; the target P "
                    f"goes after the step (resize@K:NEWP), got {frag!r}")
            lo, sep, newp = when.partition(":")
            try:
                start = end = int(lo)
                new_p = int(newp) if sep else 0
            except ValueError:
                raise ValueError(
                    f"inject fault {frag!r}: resize WHEN must be "
                    "STEP:NEW_P (e.g. resize@3:1)") from None
            if not sep or start < 1 or new_p < 1:
                raise ValueError(
                    f"inject fault {frag!r}: resize needs STEP >= 1 "
                    "and NEW_P >= 1 (grammar resize@K:NEWP)")
            args = (str(new_p),)
        else:
            lo, sep, hi = when.partition("-")
            try:
                start = int(lo)
                end = int(hi) if sep else start
            except ValueError:
                raise ValueError(
                    f"inject fault {frag!r}: WHEN must be STEP, A-B, or "
                    "latest") from None
            if start < 1 or end < start:
                raise ValueError(
                    f"inject fault {frag!r}: bad step window "
                    f"[{start}, {end}]")
            if kind == "corrupt_ckpt":
                raise ValueError(
                    "corrupt_ckpt is keyed to restore time; use "
                    "corrupt_ckpt@latest")
        if kind == "slow_rank":
            if len(args) != 2:
                raise ValueError(
                    f"slow_rank needs RANK:DURATION args, got {frag!r}")
            int(args[0])
            _parse_duration(args[1])
        elif kind == "evict_rank":
            if len(args) != 1:
                raise ValueError(
                    f"evict_rank needs a RANK arg, got {frag!r}")
            try:
                rank = int(args[0])
            except ValueError:
                raise ValueError(
                    f"evict_rank RANK must be an int, got {frag!r}"
                ) from None
            if rank < 0:
                raise ValueError(
                    f"evict_rank RANK must be >= 0, got {frag!r}")
            if start != end:
                raise ValueError(
                    f"evict_rank is a point fault (a fleet re-forms "
                    f"once, not per-step), got {frag!r}")
        elif kind == "resize":
            pass  # args minted from the WHEN parse above
        elif args:
            raise ValueError(f"{kind} takes no ':' args, got {frag!r}")
        faults.append(Fault(kind=kind, start=start, end=end, args=args))
    if not faults:
        raise ValueError(f"empty inject spec {spec!r}")
    return faults


class FaultInjector:
    """The parsed fault list and one hook an injection point; the trainer
    calls each hook with the step window (prev, new] of the dispatch it
    prepares or retires. `rank` is this process's rank."""

    def __init__(self, spec: str, metrics=None, logger=None, rank: int = 0):
        self.faults = parse_inject(spec)
        self.metrics = metrics
        self.logger = logger
        self.rank = rank

    def _record(self, fault: Fault, step: int, **extra: Any) -> None:
        fault.fired += 1
        if self.logger is not None:
            self.logger.warning("inject: %s fired at step %d",
                                fault.spec(), step)
        if self.metrics is not None:
            self.metrics.log("inject", flush=True, fault=fault.kind,
                             step=step, spec=fault.spec(), **extra)

    def _active(self, kind: str, prev: int, new: int):
        for f in self.faults:
            if f.kind != kind:
                continue
            at = f.window(prev, new)
            if at is not None:
                yield f, at

    # ------------------------------------------------------------- hooks
    def sleep_if_slow(self, prev: int, new: int) -> float:
        """Pre-dispatch: the slow_rank straggler. Returns seconds slept."""
        slept = 0.0
        for f, at in self._active("slow_rank", prev, new):
            if int(f.args[0]) != self.rank:
                continue
            dur = _parse_duration(f.args[1])
            self._record(f, at, seconds=dur)
            time.sleep(dur)
            slept += dur
        return slept

    def check_loader(self, prev: int, new: int) -> None:
        """Inside the host batch fetch: loader_raise. Consumed on the
        first raise, so the surrounding retry_call's retry succeeds."""
        for f, at in self._active("loader_raise", prev, new):
            self._record(f, at)
            raise InjectedLoaderError(
                f"injected loader failure at step {at}")

    def poison_params(self, params, prev: int, new: int) -> bool:
        """Before the dispatch: nan_grad. Multiplies the first of
        `params` (the model's parameter tensors) by NaN in place, so the
        step computes a NaN loss and NaN gradients. True when it fired."""
        hit = False
        for f, at in self._active("nan_grad", prev, new):
            self._record(f, at)
            hit = True
        if hit:
            import torch

            with torch.no_grad():
                next(iter(params)).mul_(float("nan"))
        return hit

    def reshape_batch(self, batch, prev: int, new: int, axis: int = 2):
        """Before the transfer: reshape. Halves axis `axis` (the batch
        axis) of every array of the host batch dict `batch`; a 1-sample
        batch cannot halve, and the firing is then recorded as a no-op."""
        for f, at in self._active("reshape", prev, new):
            dim = min(v.shape[axis] for v in batch.values())
            if dim < 2:
                self._record(f, at, batch_axis=axis, from_dim=dim,
                             to_dim=dim)
                continue
            half = dim // 2
            self._record(f, at, batch_axis=axis, from_dim=dim, to_dim=half)
            cut = (slice(None),) * axis + (slice(0, half),)
            batch = {k: v[cut] for k, v in batch.items()}
        return batch

    def maybe_preempt(self, prev: int, new: int, guard=None) -> None:
        """After the dispatch: preempt. Sends this process a real SIGTERM
        so the PreemptionGuard and the emergency save run as under an
        external preemption; only on rank 0 (see the module docstring).
        Without an installed guard the default handler would kill the
        process, so the fault is then only a warning."""
        for f, at in self._active("preempt", prev, new):
            if self.rank != 0:
                f.fired += 1
                continue
            if guard is None:
                if self.logger is not None:
                    self.logger.warning(
                        "inject: preempt@%d skipped: no PreemptionGuard "
                        "installed (run through dist_trainer)", at)
                continue
            self._record(f, at)
            os.kill(os.getpid(), signal.SIGTERM)

    def pending_resize(self, prev: int, new: int) -> Optional[int]:
        """Step-boundary check: resize@K:NEW_P. Returns the target
        fleet size when a resize fault fires in (prev, new], else None.
        The durable "inject" record lands here, BEFORE the trainer's
        drain/save/unwind — the process exits 46 shortly after."""
        for f, at in self._active("resize", prev, new):
            new_p = int(f.args[0])
            self._record(f, at, new_p=new_p)
            return new_p
        return None

    def pending_evict(self, prev: int, new: int) -> Optional[int]:
        """Step-boundary check: evict_rank:R@K — the chaos stand-in for
        a goodput-advised straggler eviction. Returns the rank to
        evict, else None."""
        for f, at in self._active("evict_rank", prev, new):
            rank = int(f.args[0])
            self._record(f, at, evicted_rank=rank)
            return rank
        return None

    def maybe_corrupt_ckpt(self, directory: Optional[str]) -> bool:
        """At restore: corrupt_ckpt@latest. Truncates every file of the
        newest checkpoint step, so its load raises while the step still
        lists: a checkpoint torn by a kill mid-save."""
        fired = False
        for f in self.faults:
            if f.kind != "corrupt_ckpt" or f.fired:
                continue
            if not directory or not os.path.isdir(directory):
                continue
            step_dirs = sorted(
                (int(name), os.path.join(directory, name))
                for name in os.listdir(directory) if name.isdigit())
            if not step_dirs:
                continue
            step, target = step_dirs[-1]
            n = corrupt_checkpoint_dir(target)
            self._record(f, step, files=n)
            fired = True
        return fired

    def summary(self):
        """{kind: firings} over the injector's lifetime."""
        out = {}
        for f in self.faults:
            if f.fired:
                out[f.kind] = out.get(f.kind, 0) + f.fired
        return out


def corrupt_checkpoint_dir(step_dir: str, keep_bytes: int = 16) -> int:
    """Truncate every file over 64 bytes under one checkpoint step dir
    (shared by the injector and tests); returns files corrupted."""
    n = 0
    for root, _, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                if os.path.getsize(path) > 64:
                    with open(path, "r+b") as fh:
                        fh.truncate(keep_bytes)
                    n += 1
            except OSError:
                continue
    return n
