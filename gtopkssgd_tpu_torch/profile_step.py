"""Where a training step's time goes on the card.

    python -m gtopkssgd_tpu_torch.profile_step

For each arm (gtopk/twostage, gtopk/pallas, dense) of ResNet-20 on
synthetic CIFAR-10, batch 32, at density 0.001: warm up WARMUP steps, time
TIMED_STEPS steps unprofiled, then profile STEPS steps with
``torch.profiler`` (CPU + CUDA activity) and report, per step,

* wall ms (host clock, each step ends in a device sync), profiled, and the
  median of the TIMED_STEPS unprofiled steps just before;
* device busy ms (union of all kernel and copy intervals) and the idle
  share 1 - busy/wall;
* per trainer range ("data", "forward_backward", "optimizer"): host ms,
  the device ms of the kernels launched inside it, and its span on the
  card's timeline (first to last kernel, gaps included);
* the top kernels by device time, the top-k kernels' included;
* for a gtopk arm, the selection alone: ``select_tau`` on the step's own
  gradient and residual, as the P = 1 step calls it once a step --
  device launches (kernels, copies, memsets) per call, host ms per call
  (enqueue, unprofiled) and device ms per call.

It imports only the port's public entry points, so it also profiles an
older checkout of the port. From that checkout's root, ``python -c
"import runpy; runpy.run_path('<this file>', run_name='__main__')"``
runs this script on that checkout's package.

Needs a CUDA card: a measurement path that finds none fails.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from typing import Dict, List

import torch
from torch.autograd import DeviceType

from gtopkssgd_tpu_torch.ops import k_for_density, select_tau
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

ARMS = (("gtopk", "twostage"), ("gtopk", "pallas"), ("dense", "exact"))
RANGES = ("data", "forward_backward", "optimizer")
STEPS = 10
TIMED_STEPS = 50
WARMUP = 5
BATCH_SIZE = 32
TOPK_KERNELS = ("count_kernel", "stage1_kernel", "multisection_kernel")


def _union_us(intervals: List[tuple]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile_arm(compression: str, method: str) -> Dict[str, object]:
    steps = STEPS
    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=BATCH_SIZE, compression=compression,
        density=0.001, topk_method=method, device="cuda"))
    trainer.train(WARMUP)
    unprofiled = trainer.train(TIMED_STEPS)["step_times"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        stats = trainer.train(steps)
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    # The card's timeline also carries the trainer's ranges as annotation
    # spans; busy time counts kernels, copies and memsets only.
    device = [e for e in on_card if not e.is_user_annotation]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in device]) / 1e3 / steps
    wall_ms = sum(stats["step_times"]) * 1e3 / steps
    ranges = {}
    for name in RANGES:
        host = [e for e in events
                if e.device_type == DeviceType.CPU and e.name == name]
        span = [e for e in on_card if e.is_user_annotation and e.name == name]
        ranges[name] = dict(
            host_ms=sum(e.time_range.elapsed_us() for e in host) / 1e3 / steps,
            device_ms=sum(e.device_time_total for e in host) / 1e3 / steps,
            device_span_ms=sum(e.time_range.elapsed_us() for e in span)
            / 1e3 / steps)
    by_kernel: Dict[str, float] = {}
    for e in device:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    selection = None
    if compression == "gtopk":
        opt = trainer.optimizer
        selection = profile_selection(method, opt.flat_grad,
                                      opt.state["residual"])
    return dict(
        compression=compression, method=method,
        wall_ms=wall_ms,
        median_step_ms=statistics.median(stats["step_times"]) * 1e3,
        median_step_ms_unprofiled=statistics.median(unprofiled) * 1e3,
        device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        n_device_events_per_step=len(device) / steps,
        ranges=ranges,
        top_kernels=[dict(name=k[:90], device_ms=v / 1e3 / steps)
                     for k, v in top],
        topk_kernels={k[:60]: v / 1e3 / steps for k, v in by_kernel.items()
                      if any(s in k for s in TOPK_KERNELS)},
        selection=selection,
    )


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    card = card_identity()
    print(card)
    arms = [profile_arm(c, m) for c, m in ARMS]
    for a in arms:
        print(f"{a['compression']}/{a['method']}: median step "
              f"{a['median_step_ms_unprofiled']:.3f} ms unprofiled; "
              f"profiled: wall {a['wall_ms']:.3f} ms/step, device busy "
              f"{a['device_busy_ms']:.3f} ms, idle {a['idle_share']:.3f}, "
              f"{a['n_device_events_per_step']:.0f} device events/step")
        for name, r in a["ranges"].items():
            print(f"  {name:17s} host {r['host_ms']:.3f} ms, kernels "
                  f"{r['device_ms']:.3f} ms, span on the card "
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
