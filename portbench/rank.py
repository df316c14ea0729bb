"""One rank of a run: set-up, the first three steps that ``correct``
judges, the warm-up, the window through ``Trainer.train(K)`` with the
cell's K (``steps_per_dispatch``), the profiled stretch, and after the
window the reference's comparison.

``rank_main(device, ...)`` runs in the process that prints the result at
P = 1, and in each rank process that ``parallel.dist.spawn`` starts at
P > 1 (one rank a card over NCCL, the port's own P > 1 path). The ranks
agree on the window's step count from the warm-up's rate before the
window opens; inside it they run no collective of the harness's.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch
import torch.distributed as dist

from portbench import check, faults, source, spec, trace, yardstick
from portbench.reference.run import reference_steps

CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "gtopkssgd_tpu", "bench", "benchmarks")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the
    harness must not load, compared as whole names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _pool(cell: spec.Cell, seed: int, rank: int):
    """Rank `rank`'s pool of host batches, by the configuration's kind."""
    c, t = cell.config, cell.traffic
    return spec.kind(c).pool(c, seed, rank, int(t["pool_batches"]),
                             int(t["train_config"]["batch_size"]))


def rank_main(device, cell_name: str, seed: int, seconds: float,
              traced: bool, proc_start: float, root: str,
              fault: Optional[str] = None, window: bool = True) -> Dict:
    from gtopkssgd_tpu_torch.parallel import collectives
    from gtopkssgd_tpu_torch.trainer import Trainer, TrainConfig

    cell = spec.Cell(cell_name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank() if cell.chips > 1 else 0
    pool = _pool(cell, seed, rank)
    trainer = Trainer(TrainConfig(**cell.train_config(seed, str(dev))))
    source.attach(trainer, pool, int(cell.config["epoch_samples"]))
    mend = faults.plant(fault, trainer) if fault else (lambda: None)
    rec = check.ProgramRecord(trainer, cell.config["weight_decay"])
    rec.before()
    # A traced run profiles its first dispatch: it holds the capture of a
    # CUDA graph, whose nodes attribute the replays (trace.graph_nodes).
    cap = trace.Capture() if traced and window else None
    if cap is not None:
        cap.start()
    losses = first_steps(trainer, rec)
    nodes, ranges = None, trace.cell_ranges(cell)
    if cap is not None:
        cap.stop()
        nodes = trace.graph_nodes(cap.events(), ranges)
    rec.after_last(losses[:CHECK_STEPS])
    mend()
    out: Dict = {"rank": rank}
    if window:
        out.update(_window(trainer, cell, dev, seconds, traced, proc_start,
                           collectives, nodes, ranges))
    trainer.close()
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["forbidden"] = forbidden_modules()
    out["detail"] = {}
    out["numbers"] = judge(cell, seed, rec, rank, dev, out["detail"])
    return out


def first_steps(trainer, rec: check.ProgramRecord) -> list:
    """Drive `trainer` through its first dispatches, ``train(K)`` with its
    own K, until CHECK_STEPS steps have run; `rec` reads the state after
    the first step and the parameters after step CHECK_STEPS, from inside
    the dispatch (a hook on the trainer's per-step call). Returns the
    dispatches' per-step losses."""
    step, count = trainer._step, [0]

    def hooked(batches):
        out = step(batches)
        count[0] += 1
        if count[0] == 1:
            rec.after_first()
        if count[0] == CHECK_STEPS:
            rec.params_now()
        return out

    trainer._step = hooked
    losses = []
    try:
        while len(losses) < CHECK_STEPS:
            losses += trainer.train(trainer.cfg.steps_per_dispatch)["losses"]
    finally:
        del trainer._step
    return losses


def judge(cell: spec.Cell, seed: int, rec: check.ProgramRecord, rank: int,
          dev: torch.device, detail: Optional[Dict] = None
          ) -> Dict[str, float]:
    """The reference's three steps on the same batches, and the numbers
    of this rank's record against them."""
    batches = [_pool(cell, seed, r)[:CHECK_STEPS] for r in range(cell.chips)]
    ref = reference_steps(cell.config, cell.traffic, seed, cell.chips,
                          batches, CHECK_STEPS, dev)
    return check.compare(rec, ref, rank, dev, detail)


def _window(trainer, cell: spec.Cell, dev, seconds: float, traced: bool,
            proc_start: float, collectives, nodes, ranges) -> Dict:
    t = cell.traffic
    k = trainer.cfg.steps_per_dispatch
    times = []
    for _ in range(-(-int(t["warmup_steps"]) // k)):
        t0 = time.perf_counter()
        trainer.train(k)
        times.append(time.perf_counter() - t0)
    est = statistics.median(times[len(times) // 2:])  # s a dispatch
    n = max(4, int(round(seconds / est)))
    if cell.chips > 1:
        agreed = torch.tensor([n], device=dev)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
        n = int(agreed.item())
    # One profiled stretch of nc dispatches in the middle of the window.
    nc = min(n // 3, max(3, int(round(float(t["capture_seconds"]) / est))))
    c0 = (n - nc) // 2 if traced else n
    cap, cap_wall = trace.Capture(), 0.0
    wire0 = collectives.wire["bytes"]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - proc_start
    steps = []
    w0 = time.perf_counter()
    for i in range(n):
        if i == c0:
            c_t0 = time.perf_counter()
            cap.start()
        t0 = time.perf_counter()
        with trace.step_range():
            trainer.train(k)
        steps += [(time.perf_counter() - t0) / k] * k
        if i == c0 + nc - 1:
            cap.stop()
            cap_wall = time.perf_counter() - c_t0
    window_s = time.perf_counter() - w0
    out = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
           "wire_bytes_per_step": (collectives.wire["bytes"] - wire0)
           / (n * k)}
    if not traced:
        return out
    summary = trace.summarize(cap.events(), k, nodes, ranges)
    c, batch = cell.config, int(t["train_config"]["batch_size"])
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    n_params = int(c["num_params"])
    outside = window_s - cap_wall
    ctx = SimpleNamespace(
        trace=summary, cell=cell, config=c, traffic=t, card=card,
        chips=cell.chips, n=n_params,
        k=yardstick.k_for_density(n_params,
                                  t["train_config"].get("density", 1.0)),
        flops_per_step=yardstick.step_flops(c, batch),
        peak_flops=yardstick.peak_flops(card, c["dtype"]),
        peak_bytes=yardstick.peak_bytes(card),
        rate_outside=(n - nc) * k / outside if outside > 0 else None,
        wire_bytes_per_step=out["wire_bytes_per_step"])
    out["per_layer"] = {m["name"]: spec.reader(m["name"])(ctx)
                        for m in cell.per_layer}
    out["busy_s"] = summary.get("busy_s")
    out["trace_window_s"] = summary.get("window_s")
    out["breakdown"] = summary.get("breakdown")
    out["graph"] = {"nodes": len(nodes or ()),
                    "replays": summary.get("replays"),
                    "attributed": summary.get("replays_attributed")}
    return out
