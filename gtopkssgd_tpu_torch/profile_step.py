"""Where a training step's time goes on the card, at one rank or P.

    python -m gtopkssgd_tpu_torch.profile_step
    python -m gtopkssgd_tpu_torch.profile_step --nworkers P [--dnn D] \\
        [--compression C] [--topk-method M] [--buckets B] \\
        [--pipeline serial|overlap|auto]

Without arguments: for each arm (gtopk/twostage, gtopk/pallas, dense) of
ResNet-20 on synthetic CIFAR-10, batch 32, at density 0.001, one rank.
With ``--nworkers`` (or any other flag): the one arm the flags name, on
P ranks spawned by ``parallel.dist`` (NCCL with one rank a card when
there are P cards, else gloo with the ranks sharing the card), each rank
profiling its own steps. Each rank warms up WARMUP steps, times
TIMED_STEPS steps unprofiled, then profiles STEPS steps with
``torch.profiler`` (CPU + CUDA activity, every thread, so the optimizer's
merge thread too), and reports, per step,

* wall ms (host clock, each step ends in a device sync), profiled, and the
  median of the TIMED_STEPS unprofiled steps just before;
* device busy ms (union of this process's kernel and copy intervals) and
  the idle share 1 - busy/wall;
* per range -- the trainer's "data", "forward_backward" and "optimizer",
  and the optimizer's "select" and "exchange" (one of each a unit) --
  host ms, the device ms of the kernels launched inside it, and its span
  on the card's timeline (first to last kernel, gaps included);
* the overlap share: of the device time of the kernels each "select"
  range launched, the share that falls inside another unit's exchange
  window -- from the first to the end of the last device event its
  "exchange" range launched -- read from the window's Chrome trace
  (``trace_overlap_share``). Under
  ``serial`` a unit's selection is issued after the previous exchange has
  returned, so the share is 0; under ``overlap`` it is the part of the
  selections that ran while a merge was in flight;
* the top kernels by device time, the top-k kernels' included;
* at one rank, for a gtopk arm, the selection alone: ``select_tau`` on
  the step's own gradient and residual, as the P = 1 step calls it once a
  step -- device launches (kernels, copies, memsets) per call, host ms
  per call (enqueue, unprofiled) and device ms per call.

Rank 0 prints every rank's report. It imports only the port's public
entry points, so it also profiles an older checkout of the port. From
that checkout's root, ``python -c "import runpy;
runpy.run_path('<this file>', run_name='__main__')"`` runs this script on
that checkout's package.

Needs a CUDA card: a measurement path that finds none fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

from gtopkssgd_tpu_torch.obs import trace_attr
from gtopkssgd_tpu_torch.ops import k_for_density, select_tau
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer
from gtopkssgd_tpu_torch.utils.manifest import card_identity

ARMS = (("gtopk", "twostage"), ("gtopk", "pallas"), ("dense", "exact"))
RANGES = ("data", "forward_backward", "optimizer", "select", "exchange")
STEPS = 10
TIMED_STEPS = 50
WARMUP = 5
BATCH_SIZE = 32
TOPK_KERNELS = ("count_kernel", "stage1_kernel", "multisection_kernel")

Interval = Tuple[float, float]


def overlap_share(select_kernels: Sequence[Sequence[Interval]],
                  exchanges: Sequence[Interval]) -> Optional[float]:
    """Of the kernel time of unit i's selection (``select_kernels[i]``),
    summed over the units, the share inside the exchange window of any
    other unit j != i (``exchanges[j]``); None without selection kernels,
    or when the units' selections and exchanges do not pair up."""
    if len(select_kernels) != len(exchanges):
        return None
    total = inside = 0.0
    for i, kernels in enumerate(select_kernels):
        others = [w for j, w in enumerate(exchanges) if j != i]
        for kern in kernels:
            total += kern[1] - kern[0]
            inside += trace_attr.overlap_length([kern], others)
    return inside / total if total else None


def trace_overlap_share(prof) -> Optional[float]:
    """``overlap_share`` of a profiled window, read from its Chrome trace.
    A device event (kernel, copy, memset) belongs to the "select" or
    "exchange" range its launch (the runtime call with the same
    correlation id) started in, on that range's thread. An exchange is in
    flight on the card's timeline from its first device event to the end
    of its last (a gloo merge's encode and host copy open it and its last
    merge kernels close it; an NCCL merge's host range ends before its
    kernels run); one that launched nothing keeps its host range.
    Selections and exchanges pair up in the order they started."""
    with tempfile.TemporaryDirectory(prefix="gtopk-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    launches = {e["args"]["correlation"]: (e["tid"], e["ts"])
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def launched(name):
        """The ranges called `name` in start order, each (start, end, its
        device events' intervals)."""
        ranges = sorted(((e["tid"], e["ts"], e["ts"] + e["dur"])
                         for e in events if e.get("cat") == "user_annotation"
                         and e.get("name") == name), key=lambda r: r[1])
        inside: List[List[Interval]] = [[] for _ in ranges]
        for e in events:
            if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
                continue
            launch = launches.get(e["args"].get("correlation"))
            if launch is None:
                continue
            tid, t = launch
            for i, (rtid, start, end) in enumerate(ranges):
                if rtid == tid and start <= t <= end:
                    inside[i].append((e["ts"], e["ts"] + e["dur"]))
                    break
        return [(start, end, kern) for (_, start, end), kern
                in zip(ranges, inside)]

    windows = [(min(a for a, _ in kern), max(b for _, b in kern)) if kern
               else (start, end) for start, end, kern in launched("exchange")]
    return overlap_share([kern for _, _, kern in launched("select")],
                         windows)


def summarize(prof, stats: Dict[str, object], steps: int) -> Dict[str, object]:
    """The report of a profiled window of `steps` trainer steps
    (``Trainer.train``'s `stats`)."""
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    # The card's timeline also carries the ranges as annotation spans;
    # busy time counts kernels, copies and memsets only.
    device = [e for e in on_card if not e.is_user_annotation]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = trace_attr.union_length(
        [(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / steps
    wall_ms = sum(stats["step_times"]) * 1e3 / steps
    ranges = {}
    for name in RANGES:
        host = [e for e in events
                if e.device_type == DeviceType.CPU and e.name == name]
        span = [e for e in on_card if e.is_user_annotation and e.name == name]
        ranges[name] = dict(
            count=len(host) / steps,
            host_ms=sum(e.time_range.elapsed_us() for e in host) / 1e3 / steps,
            device_ms=sum(e.device_time_total for e in host) / 1e3 / steps,
            device_span_ms=sum(e.time_range.elapsed_us() for e in span)
            / 1e3 / steps)
    share = trace_overlap_share(prof)
    by_kernel: Dict[str, float] = {}
    for e in device:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        wall_ms=wall_ms,
        median_step_ms=statistics.median(stats["step_times"]) * 1e3,
        device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        n_device_events_per_step=len(device) / steps,
        ranges=ranges, overlap_share=share,
        top_kernels=[dict(name=k[:90], device_ms=v / 1e3 / steps)
                     for k, v in top],
        topk_kernels={k[:60]: v / 1e3 / steps for k, v in by_kernel.items()
                      if any(s in k for s in TOPK_KERNELS)})


def profile_trainer(trainer: Trainer,
                    steps: int = STEPS) -> Dict[str, object]:
    """Warm-up, unprofiled and profiled steps of `trainer`; the report."""
    trainer.train(WARMUP)
    unprofiled = trainer.train(TIMED_STEPS)["step_times"]
    with trace_attr.profiler() as prof:
        stats = trainer.train(steps)
    out = summarize(prof, stats, steps)
    out["median_step_ms_unprofiled"] = statistics.median(unprofiled) * 1e3
    return out


def profile_arm(compression: str, method: str) -> Dict[str, object]:
    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=BATCH_SIZE, compression=compression,
        density=0.001, topk_method=method, device="cuda"))
    out = profile_trainer(trainer)
    out.update(compression=compression, method=method, rank=0, selection=None)
    if compression == "gtopk":
        opt = trainer.optimizer
        out["selection"] = profile_selection(method, opt.flat_grad,
                                             opt.state["residual"])
    return out


def profile_rank(device, cfg: TrainConfig,
                 steps: int) -> Dict[str, object]:
    """One rank's report (spawned by ``profile_ranks``)."""
    import dataclasses

    import torch.distributed as dist

    trainer = Trainer(dataclasses.replace(cfg, device=str(device)))
    try:
        out = profile_trainer(trainer, steps)
    finally:
        trainer.optimizer.close()
    bplan = trainer.bucket_plan
    out.update(compression=cfg.compression, method=cfg.topk_method,
               rank=dist.get_rank(), device=str(device), selection=None,
               pipeline=None if bplan is None else bplan.pipeline,
               buckets=None if bplan is None else bplan.n_buckets)
    return out


def profile_ranks(cfg: TrainConfig,
                  steps: int = STEPS) -> List[Dict[str, object]]:
    """Every rank's report of `cfg` at ``cfg.nworkers`` ranks."""
    from gtopkssgd_tpu_torch.parallel.dist import shared_backend, spawn

    p = cfg.nworkers
    return spawn(profile_rank, p, cfg, steps,
                 backend=shared_backend(p, "cuda"), device="cuda",
                 timeout=1200)


def profile_selection(method: str, grad: torch.Tensor,
                      residual: torch.Tensor) -> Dict[str, float]:
    """``select_tau`` alone, STEPS calls: launches, host ms and device ms
    per call."""
    k = k_for_density(grad.shape[0], 0.001)

    def call():
        return select_tau(grad, k, method, residual=residual)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(STEPS):
            call()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    return dict(
        launches_per_call=len(device) / STEPS, host_ms_per_call=host_ms,
        device_ms_per_call=sum(e.time_range.elapsed_us() for e in device)
        / 1e3 / STEPS)


def report(a: Dict[str, object]) -> None:
    """Print one rank's report."""
    share = a["overlap_share"]
    unprof = a["median_step_ms_unprofiled"]
    print(f"{a['compression']}/{a['method']} rank {a['rank']}"
          + (f" pipeline {a['pipeline']} ({a['buckets']} buckets)"
             if a.get("pipeline") else "")
          + ": median step "
          + (f"{unprof:.3f} ms unprofiled; " if unprof is not None else "")
          + f"profiled: wall {a['wall_ms']:.3f} ms/step, device busy "
          f"{a['device_busy_ms']:.3f} ms, idle {a['idle_share']:.3f}, "
          f"{a['n_device_events_per_step']:.0f} device events/step, "
          "overlap share "
          + ("not defined" if share is None else f"{share:.4f}"))
    for name, r in a["ranges"].items():
        print(f"  {name:17s} {r['count']:.0f}/step, host {r['host_ms']:.3f} "
              f"ms, kernels {r['device_ms']:.3f} ms, span on the card "
              f"{r['device_span_ms']:.3f} ms")
    for kern in a["top_kernels"][:6]:
        print(f"  kernel {kern['device_ms']:.4f} ms  {kern['name']}")
    print(f"  top-k kernels: {a['topk_kernels']}")
    s = a["selection"]
    if s is not None:
        print(f"  selection alone (select_tau): "
              f"{s['launches_per_call']:.0f} device launches, host "
              f"{s['host_ms_per_call']:.3f} ms, device "
              f"{s['device_ms_per_call']:.4f} ms per call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nworkers", type=int, default=None)
    ap.add_argument("--dnn", default=None)
    ap.add_argument("--compression", default=None)
    ap.add_argument("--topk-method", default=None)
    ap.add_argument("--buckets", default=None)
    ap.add_argument("--pipeline", default=None)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="profiled steps a rank")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    print(card_identity())
    flags = (args.nworkers, args.dnn, args.compression, args.topk_method,
             args.buckets, args.pipeline)
    if all(f is None for f in flags):
        for arm in (profile_arm(c, m) for c, m in ARMS):
            report(arm)
        return 0
    cfg = TrainConfig(
        dnn=args.dnn or "resnet20", batch_size=BATCH_SIZE,
        compression=args.compression or "gtopk", density=0.001,
        topk_method=args.topk_method or "twostage",
        buckets=args.buckets or "concat", pipeline=args.pipeline or "serial",
        nworkers=args.nworkers or 1, device="cuda")
    if cfg.nworkers == 1:
        trainer = Trainer(cfg)
        try:
            out = profile_trainer(trainer, args.steps)
        finally:
            trainer.optimizer.close()
        out.update(compression=cfg.compression, method=cfg.topk_method,
                   rank=0, selection=None, pipeline=None, buckets=None)
        ranks = [out]
    else:
        ranks = profile_ranks(cfg, args.steps)
    for r in ranks:
        report(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
