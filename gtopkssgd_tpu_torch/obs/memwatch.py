"""The compile and memory planes, the port of ``gtopkssgd_tpu/obs/
memwatch.py`` for the CUDA caching allocator.

What the JAX module reads from XLA has a torch counterpart here:

  * ``"compile"`` records, one a batch-shape key (``batch_shape_key``):
    where XLA reports the compiled step's cost and memory analysis, the
    port runs the first step of each new shape eagerly and times it
    (``compile_s``: one-off set-up, cuDNN and cuBLAS included), counts
    its FLOPs with one ``FlopCounterMode`` pass (``step_flops``, the
    function ``benchmark.py``'s MFU uses too, so the two cannot drift),
    and reads its peak from the allocator (``peak_hbm_bytes`` =
    ``torch.cuda.max_memory_allocated`` over that step; left out on the
    CPU, which has no allocator statistics).
  * recompiles (``CompileWatch``): where JAX watches jit's executable
    cache, the port counts the executables it makes -- a new batch-shape
    key, and a CUDA-graph capture beyond the expected ones (one a step
    variant and lr: with the recall audit two, the audit's and the plain
    step's; a restore drops them and expects a recapture). The first
    ``recompile_warmup`` polls set the baseline; growth feeds the
    ``recompile_storm`` rule and writes a ``{"event": "recompile"}``
    compile record.
  * ``"mem"`` records every ``mem_interval`` steps
    (``live_memory_summary``): on the card ``torch.cuda.memory_stats()``
    -- the allocated bytes now and at peak and the allocations now as
    ``live_bytes``, ``peak_bytes_in_use`` and ``live_count``,
    ``memory_reserved()`` as ``bytes_in_use``, the total of
    ``mem_get_info()`` as ``bytes_limit`` -- and their ``headroom_frac``;
    on the CPU what JAX's CPU record carries and torch can give: the live
    tensors' storages (count, bytes, bytes a dtype) found by the garbage
    collector. They feed ``device_mem_leak`` (live bytes) and
    ``hbm_headroom`` (in use over the limit; the CPU never arms it).

Every record is written before the monitor sees its sample, so a halt
never loses the evidence behind it. Nothing here makes up a number: a
figure the device cannot give is left out.
"""

from __future__ import annotations

import gc
import hashlib
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch


def step_flops(fn: Callable[[], Any]) -> Tuple[Any, int]:
    """(fn(), the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
    counts in it: matrix products and convolutions, forward and
    backward). The one FLOP count of the port: the trainer's "compile"
    records and the benchmark's MFU."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, int(counter.get_total_flops())


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _leaves(sub)


def batch_shape_key(tree) -> str:
    """Text key of the shapes and dtypes of a tree's tensors (dicts,
    lists, tuples): the identity of a dispatch shape. A long key becomes
    a digest, so a record stays a line."""
    parts = ["x".join(str(int(s)) for s in t.shape) + ":"
             + str(t.dtype).replace("torch.", "") for t in _leaves(tree)]
    key = ";".join(parts)
    if len(key) > 160:
        digest = hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]
        key = f"sha1:{digest}:{len(parts)}leaves"
    return key


def compile_record(*, shape_key: str, compile_s: Optional[float] = None,
                   flops: Optional[float] = None,
                   peak_bytes: Optional[int] = None) -> Dict[str, Any]:
    """One "compile" record body: the dispatch-shape key, the first
    step's seconds, its FLOPs and its allocator peak (where given)."""
    rec: Dict[str, Any] = {"shape_key": str(shape_key)}
    if compile_s is not None:
        rec["compile_s"] = round(float(compile_s), 6)
    if flops is not None:
        rec["flops"] = float(flops)
    if peak_bytes is not None:
        rec["peak_hbm_bytes"] = int(peak_bytes)
    return rec


class CompileWatch:
    """Growth detector over the executables a run makes.
    ``size_fn()`` is the count (the trainer's ``_compile_cache_size``:
    batch-shape keys plus unexpected graph captures). The first poll
    adopts the size as the baseline."""

    def __init__(self, size_fn: Callable[[], int]):
        self.size_fn = size_fn
        self.last: Optional[int] = None
        self.compile_events = 0

    def cache_size(self) -> Optional[int]:
        try:
            return int(self.size_fn())
        except Exception:
            return None

    def poll(self) -> Optional[Tuple[int, int]]:
        """(entries grown, current size) when the count grew since the
        last poll, else None."""
        size = self.cache_size()
        if size is None:
            return None
        if self.last is None:
            self.last = size
            return None
        if size > self.last:
            grown = size - self.last
            self.last = size
            self.compile_events += grown
            return (grown, size)
        self.last = size
        return None


def live_memory_summary(device) -> Dict[str, Any]:
    """The live-memory window of `device`: the caching allocator's
    figures on the card; on the CPU the live tensors' storages
    (``live_count``, ``live_bytes``, ``live_bytes_<dtype>``), as the JAX
    CPU record's live arrays."""
    device = torch.device(device)
    if device.type == "cuda":
        st = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
        return {
            "live_count": int(st.get("allocation.all.current", 0)),
            "live_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_in_use": int(torch.cuda.memory_reserved(device)),
            "bytes_limit": int(total),
            "devices_reporting": 1,
        }
    seen: Dict[Any, Tuple[int, str]] = {}
    with warnings.catch_warnings():
        # isinstance() on some module objects warns of their deprecation
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if (not isinstance(obj, torch.Tensor)
                        or obj.device.type != "cpu"):
                    continue
                storage = obj.untyped_storage()
                seen.setdefault(storage.data_ptr(), (
                    int(storage.nbytes()),
                    str(obj.dtype).replace("torch.", "")))
            except Exception:
                continue
    by_dtype: Dict[str, int] = {}
    for nbytes, dtype in seen.values():
        by_dtype[dtype] = by_dtype.get(dtype, 0) + nbytes
    out: Dict[str, Any] = {"live_count": len(seen),
                           "live_bytes": int(sum(by_dtype.values()))}
    for dtype in sorted(by_dtype):
        out[f"live_bytes_{dtype}"] = int(by_dtype[dtype])
    return out


class MemWatch:
    """Trainer-facing compile and memory watch (``--obs-mem``).

    ``account(fn, shape_key=, step=)`` runs the first step of a new batch
    shape, timed and counted, and logs its "compile" record (one a key
    for the run); ``attach(size_fn)`` arms the ``CompileWatch``;
    ``poll(step)`` is the hook at the trainer's sync point: a recompile
    record a growth (then ``observe_compile``), and every
    ``mem_interval`` steps a "mem" record (then ``observe_memory``). A
    failing read degrades to a logger warning."""

    def __init__(self, metrics=None, monitor=None, mem_interval: int = 50,
                 device="cpu", logger=None):
        self.metrics = metrics
        self.monitor = monitor
        self.mem_interval = max(1, int(mem_interval))
        self.device = torch.device(device)
        self.logger = logger
        self.watch: Optional[CompileWatch] = None
        self.recompile_count = 0
        self.shapes: Dict[str, Dict[str, Any]] = {}
        self._last_mem_step: Optional[int] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def account(self, fn: Callable[[], Any], *, shape_key: str,
                step: int = 0) -> Tuple[Any, Optional[Dict[str, Any]]]:
        """(fn(), its "compile" record): fn runs once, timed between two
        syncs, under ``step_flops``, with the allocator's peak reset
        before it. A key seen before runs fn plainly (record None)."""
        if shape_key in self.shapes:
            return fn(), None
        cuda = self.device.type == "cuda"
        self._sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out, flops = step_flops(fn)
        self._sync()
        seconds = time.perf_counter() - t0
        rec = compile_record(
            shape_key=shape_key, compile_s=seconds, flops=flops,
            peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                        if cuda else None))
        rec["step"] = int(step)
        rec["shape_index"] = len(self.shapes)
        self.shapes[shape_key] = rec
        self.log_compile(rec)
        return out, rec

    def log_compile(self, rec: Dict[str, Any]) -> None:
        """Durably write one "compile" record (fsynced)."""
        if self.metrics is not None:
            self.metrics.log("compile", flush=True, **rec)

    @property
    def peak_hbm_bytes(self) -> Optional[int]:
        """The largest first-step peak seen so far."""
        peaks = [rec.get("peak_hbm_bytes") for rec in self.shapes.values()]
        peaks = [p for p in peaks if isinstance(p, (int, float))]
        return int(max(peaks)) if peaks else None

    def attach(self, size_fn: Callable[[], int]) -> None:
        """Arm the recompile watch on the trainer's executable count."""
        self.watch = CompileWatch(size_fn)

    def poll(self, step: int) -> None:
        """The sync-point hook; may raise AnomalyHalt through the
        monitor, after every record is written."""
        self._poll_recompile(step)
        if (self._last_mem_step is None
                or step - self._last_mem_step >= self.mem_interval):
            self._last_mem_step = int(step)
            self.sample(step)

    def _poll_recompile(self, step: int) -> None:
        if self.watch is None:
            return
        growth = self.watch.poll()
        if growth is not None:
            grown, size = growth
            self.recompile_count += grown
            if self.metrics is not None:
                self.metrics.log(
                    "compile", flush=True, event="recompile",
                    step=int(step), cache_size=int(size),
                    recompile_count=int(self.recompile_count),
                    compile_events=int(self.watch.compile_events))
        if self.monitor is not None and self.watch.last is not None:
            self.monitor.observe_compile(
                step, cache_size=self.watch.last,
                grew=growth is not None)

    def sample(self, step: int) -> Dict[str, Any]:
        """One live-memory window: a "mem" record, then the leak and
        headroom rules."""
        rec: Dict[str, Any] = {"step": int(step)}
        try:
            rec.update(live_memory_summary(self.device))
        except Exception as e:  # a failing read must not stop training
            if self.logger is not None:
                self.logger.warning("memory read failed: %s", e)
        in_use, limit = rec.get("bytes_in_use"), rec.get("bytes_limit")
        if in_use and limit:
            rec["headroom_frac"] = round(float(in_use) / float(limit), 6)
        rec["recompile_count"] = int(self.recompile_count)
        if self.metrics is not None:
            self.metrics.log("mem", **rec)
        if self.monitor is not None:
            self.monitor.observe_memory(
                step, live_bytes=rec.get("live_bytes"),
                bytes_in_use=in_use, bytes_limit=limit)
        return rec
