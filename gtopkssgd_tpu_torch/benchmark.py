"""The benchmark harness: a step's throughput, and the paper's breakdown
of a step into forward+backward, compression, exchange and apply.

    python -m gtopkssgd_tpu_torch.benchmark [--dnn resnet50] \\
        [--modes gtopk,dense] [--density 0.001] [--topk-method twostage] \\
        [--batch-size 32] [--nworkers P] [--buckets B --pipeline ORDER] \\
        [--min-seconds S] [--steps N] [--dtype float32] [--device cpu]

Counterpart of ``gtopkssgd_tpu/benchmark.py``, with its records:

* ``measure_throughput`` -- the whole step (forward, backward,
  ``GTopKSGD.step``) timed end to end over a window of at least
  ``min_seconds``, after 3 warm-up steps; the clock stops after a
  device sync, which fences every stream and so the whole updated state
  (parameters, velocity, residual). FLOPs per step come from
  ``torch.utils.flop_counter.FlopCounterMode`` over one step (matrix
  products and convolutions, forward and backward; ``obs.memwatch.
  step_flops``, which the trainer's "compile" records use too), the MFU
  from a peak
  looked up by the card's name, the dtype and the TF32 setting (None for
  a card not in ``PEAK_FLOPS``). The model computes in ``dtype``
  (bfloat16 by default, as the JAX harness; ``models.layers``).
* ``measure_breakdown`` -- each phase timed alone, ``steps`` calls then a
  sync: ``forward_backward``; ``compress`` (the flat selection), or
  under ``gtopk_layerwise`` ``compress_per_leaf`` (the per-leaf
  selection of the concat wire) or ``compress_per_bucket`` (each
  bucket's selection stage); ``comm`` (the exchange, on per-rank distinct
  sets: replicated sets would hand the merge its cheapest case); and
  ``apply`` (the averaged update into the parameters, SGD). A bucketed
  wire also times ``select_and_comm``, the bucket loop in the
  configured order (``pipeline``), the phase where the order matters.
  The sum is an upper bound on the step: the step interleaves nothing
  the phases would hide, but each phase pays its own sync.
* ``attr_from_breakdown`` -- the three-term split (compute, select,
  comm) of a breakdown, the JAX package's record.

Batches are fixed and on the device (random, from a seed, one a rank:
rank r takes row r of a (P, batch) draw, as the JAX harness does): the
harness times the framework step, not the input pipeline. At ``nworkers`` P > 1
each measurement runs inside P ranks spawned by ``parallel.dist`` (NCCL
with one rank a card when there are P cards, else gloo with the ranks
sharing the card); the ranks agree on every window, and rank 0's record
is returned. Runs on the CUDA card unless the config asks for the CPU;
float32 only (TF32 off, as the trainer runs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gtopkssgd_tpu_torch.convert import flat_layout
from gtopkssgd_tpu_torch.models import get_model
from gtopkssgd_tpu_torch.modes import DENSE_MODES, HIER_MODES, LAYERWISE_MODES
from gtopkssgd_tpu_torch.obs.memwatch import step_flops
from gtopkssgd_tpu_torch.ops import scatter_add_dense
from gtopkssgd_tpu_torch.optimizer import GTopKSGD, wire_k
from gtopkssgd_tpu_torch.parallel.collectives import (
    comm_bytes_per_step,
    dense_allreduce,
    sparse_allreduce,
)
from gtopkssgd_tpu_torch.parallel.dist import shared_backend, spawn

# Peak FLOP/s of one card by (name, dtype, TF32 on) for the MFU: NVIDIA's
# data sheet for the H100 SXM (float32 outside the tensor cores; TF32
# dense; bfloat16 dense on the tensor cores, 989.4 TFLOP/s, half the
# sheet's figure with sparsity). A card not listed reports mfu None.
PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", "float32", False): 67e12,
    ("NVIDIA H100 80GB HBM3", "float32", True): 495e12,
    ("NVIDIA H100 80GB HBM3", "bfloat16", False): 989.4e12,
    ("NVIDIA H100 80GB HBM3", "bfloat16", True): 989.4e12,
}


@dataclasses.dataclass
class BenchConfig:
    dnn: str = "resnet50"
    batch_size: int = 128
    steps: int = 40              # breakdown: calls per phase
    min_seconds: float = 2.0     # throughput: the window's least length
    density: float = 0.001
    dtype: str = "bfloat16"      # compute dtype: bfloat16 | float32
    topk_method: str = "auto"
    nworkers: int = 1            # 0 = one rank a visible card
    hier_ici: int = 1            # gtopk_hier: ranks per slice
    s2d: bool = False            # resnet50: the space-to-depth stem
    momentum_correction: bool = False
    buckets: str = "concat"      # gtopk_layerwise: concat | leaf | auto | B
    pipeline: str = "serial"     # bucketed: serial | overlap | auto
    select_gamma: Optional[float] = None  # default: the card's fit
    device: str = "cuda"         # cuda (default) | cpu

    def world(self) -> int:
        if self.nworkers:
            return self.nworkers
        return (torch.cuda.device_count()
                if torch.device(self.device).type == "cuda" else 1)


def _peak_flops(device: torch.device, dtype: str) -> Optional[float]:
    if device.type != "cuda":
        return None
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    return PEAK_FLOPS.get((torch.cuda.get_device_name(device), dtype, tf32))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree(x: float, device: torch.device, group) -> float:
    """The largest `x` over the ranks (x itself at P = 1)."""
    if group is None:
        return x
    on = device if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([x], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


class _Bench:
    """One rank's model, fixed batch and optimizer for `mode`."""

    def __init__(self, cfg: BenchConfig, mode: Optional[str],
                 density: float, device: torch.device, group):
        self.cfg, self.mode, self.device, self.group = cfg, mode, device, group
        self.p = 1 if group is None else dist.get_world_size(group)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model, self.spec = get_model(cfg.dnn, space_to_depth=cfg.s2d,
                                          dtype=cfg.dtype)
        if self.spec.recurrent:
            raise ValueError(f"the harness times the vision zoo, not "
                             f"{cfg.dnn!r}")
        self.model.reset_parameters(torch.Generator().manual_seed(0))
        self.model.to(device).train()
        # One batch a rank, as the JAX harness draws (P,) + shape from one
        # seed: rank r takes row r, so the ranks' gradients and sets differ.
        rank = 0 if group is None else dist.get_rank(group)
        gen = torch.Generator().manual_seed(1)
        classes = 10 if self.spec.dataset == "cifar10" else 1000
        self.x = torch.randn((self.p, cfg.batch_size)
                             + self.spec.example_shape,
                             generator=gen)[rank].to(device)
        self.y = torch.randint(0, classes, (self.p, cfg.batch_size),
                               generator=gen)[rank].to(device)
        self.layout = flat_layout(self.model)
        self.opt = GTopKSGD(
            self.model.parameters(), 0.1, momentum=0.9, compression=mode,
            density=density, topk_method=cfg.topk_method,
            hier_ici_size=cfg.hier_ici if mode in HIER_MODES else 1,
            momentum_correction=(cfg.momentum_correction
                                 and mode not in DENSE_MODES),
            buckets=cfg.buckets if mode in LAYERWISE_MODES else "concat",
            pipeline=cfg.pipeline if mode in LAYERWISE_MODES else "serial",
            select_gamma=cfg.select_gamma, layout=self.layout,
            process_group=group)

    def forward_backward(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        F.cross_entropy(self.model(self.x), self.y).backward()

    def step(self) -> None:
        self.forward_backward()
        self.opt.step()

    def close(self) -> None:
        self.opt.close()


def _window(fn: Callable[[], None], bench: _Bench, min_seconds: float,
            steps: int = 8):
    """(seconds a call, calls timed): `steps` calls then a sync, the count
    grown until the window lasts `min_seconds` on every rank."""
    while True:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(bench.device)
        elapsed = _agree(time.perf_counter() - t0, bench.device,
                         bench.group)
        if elapsed >= min_seconds:
            return elapsed / steps, steps
        steps = int(steps * min(10.0, max(
            2.0, 1.25 * min_seconds / max(elapsed, 1e-4)))) + 1


def _timeit(fn: Callable[[], None], bench: _Bench, calls: int) -> float:
    """Seconds a call: one call, a sync, then `calls` calls and a sync."""
    fn()
    _sync(bench.device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(bench.device)
    return (time.perf_counter() - t0) / calls


def _throughput(device, cfg: BenchConfig, mode: Optional[str],
                density: float) -> Dict[str, object]:
    group = dist.group.WORLD if dist.is_initialized() else None
    bench = _Bench(cfg, mode, density, torch.device(device), group)
    try:
        for _ in range(3):
            bench.step()
        _sync(bench.device)
        _, flops = step_flops(bench.step)
        sec, steps = _window(bench.step, bench, cfg.min_seconds)
    finally:
        bench.close()
    n = bench.layout.n
    opt = bench.opt
    k = (opt.bucket_plan.k_total if opt.bucket_plan
         else wire_k(mode, density, n, bench.layout.sizes))
    peak = _peak_flops(bench.device, cfg.dtype)
    achieved = flops / sec if flops else None
    buckets = opt.bucket_plan.pairs() if opt.bucket_plan else ((n, k),)
    return {
        "mode": mode or "dense",
        "density": density,
        "sec_per_step": sec,
        "images_per_sec_per_chip": cfg.batch_size / sec,
        "steps_timed": steps,
        "window_seconds": sec * steps,
        "flops_per_step": flops,
        "achieved_tflops_per_chip": (achieved / 1e12 if achieved is not None
                                     else None),
        "mfu": achieved / peak if achieved is not None and peak else None,
        "comm_bytes_model": sum(comm_bytes_per_step(
            mode, n_b, k_b, bench.p, ici_size=opt.ici,
            codec=opt.codec.name,
            schedule=None if opt.plan is None else opt.plan.schedule)
            for n_b, k_b in buckets),
        "num_params": n,
        "nworkers": bench.p,
    }


def _distinct_set(vals: torch.Tensor, n: int, rank: int):
    """This rank's own set of len(vals) distinct indices: the values
    scaled by a rank-seeded normal draw, the indices a rank-seeded sample
    of [0, n) without repeats (the merge's precondition)."""
    gen = torch.Generator().manual_seed(2 + rank)
    k = vals.shape[0]
    scale = torch.randn(k, generator=gen).to(vals.device)
    idx = torch.randperm(n, generator=gen)[:k].to(torch.int32)
    return vals * scale, idx.to(vals.device)


def _breakdown(device, cfg: BenchConfig, mode: Optional[str],
               density: float) -> Dict[str, object]:
    group = dist.group.WORLD if dist.is_initialized() else None
    bench = _Bench(cfg, mode, density, torch.device(device), group)
    opt, lay, p, calls = bench.opt, bench.layout, bench.p, cfg.steps
    rank = 0 if group is None else dist.get_rank(group)
    n = lay.n
    res: Dict[str, object] = {"mode": mode or "dense", "density": density}
    bplan = opt.bucket_plan
    concat = mode in LAYERWISE_MODES and bplan is None
    if mode in LAYERWISE_MODES:
        res.update(k_total=(bplan.k_total if bplan
                            else wire_k(mode, density, n, lay.sizes)),
                   n=n)
    try:
        res["forward_backward"] = _timeit(bench.forward_backward, bench,
                                          calls)
        flat = lay.ravel([q.grad for q in lay.params])
        zeros = torch.zeros_like(flat)
        if mode in DENSE_MODES:
            res["compress"] = 0.0
            res["comm"] = 0.0 if group is None else _timeit(
                lambda: dense_allreduce(flat, group=group), bench, calls)
            update = flat / p
        else:
            # The selection's units (leaves, buckets or the whole vector)
            # and the exchange's sets ((offset, n, k) each).
            units = (list(zip(lay.offsets, lay.sizes)) if concat
                     else opt._units())
            name = ("compress_per_leaf" if concat else "compress_per_bucket"
                    if bplan is not None else "compress")

            def select():
                return [opt._select(flat[o:o + s], zeros[o:o + s], None)
                        for o, s in units]

            res[name] = _timeit(select, bench, calls)
            picked = [st["vals"] for st in select()]
            if concat:
                sets, picked = [(0, n, sum(opt.leaf_ks))], [torch.cat(picked)]
            else:
                sets = [(o, s, opt.compressor.k(s)) for o, s in units]
            wires = [_distinct_set(v, s, rank)
                     for v, (_, s, _) in zip(picked, sets)]
            if group is None:  # nothing to exchange at P = 1
                res["comm"] = 0.0
                got = [(v, i) for v, i in wires]
            else:
                def comm():
                    return [sparse_allreduce(
                        opt.mode, v, i, k=k, n=s, group=group,
                        ici_size=opt.ici, codec=opt.codec, plan=opt.plan)[:2]
                        for (v, i), (_, s, k) in zip(wires, sets)]

                res["comm"] = _timeit(comm, bench, calls)
                got = comm()
                if bplan is not None:
                    res["select_and_comm"] = _timeit(
                        lambda: opt._by_unit(flat, zeros, None), bench,
                        calls)
                    res.update(buckets=bplan.n_buckets,
                               pipeline=bplan.pipeline)
            update = torch.cat([
                (r if i is None else scatter_add_dense(s, i, r)) / p
                for (r, i), (_, s, _) in zip(got, sets)])
        grads = [q.grad for q in lay.params]

        def apply():
            lay.unravel_into(update, grads)
            torch.optim.SGD.step(opt)

        res["apply"] = _timeit(apply, bench, calls)
    finally:
        bench.close()
    res["sum"] = sum(v for q, v in res.items()
                     if q in ("forward_backward", "compress",
                              "compress_per_leaf", "compress_per_bucket",
                              "comm", "apply"))
    return res


def _run(fn, cfg: BenchConfig, mode: Optional[str], density: float):
    p = cfg.world()
    if p <= 1:
        return fn(cfg.device, cfg, mode, density)
    return spawn(fn, p, cfg, mode, density,
                 backend=shared_backend(p, cfg.device), device=cfg.device,
                 timeout=1200)[0]


def measure_throughput(cfg: BenchConfig, mode: Optional[str],
                       density: float) -> Dict[str, object]:
    """The whole step's time, images/s per card, FLOPs and MFU, and the
    modeled wire bytes, for one (mode, density) point."""
    return _run(_throughput, cfg, mode, density)


def measure_breakdown(cfg: BenchConfig, mode: Optional[str],
                      density: float) -> Dict[str, object]:
    """Seconds of each phase, timed alone (module docstring)."""
    return _run(_breakdown, cfg, mode, density)


def attr_from_breakdown(breakdown: Dict[str, float]) -> Dict[str, float]:
    """The three-term split of a ``measure_breakdown`` record: forward and
    backward plus apply -> compute, compress(_per_leaf) -> select, comm ->
    comm (isolated phases, so an upper-bound decomposition)."""
    t = {
        "compute": (breakdown.get("forward_backward", 0.0)
                    + breakdown.get("apply", 0.0)),
        "select": (breakdown.get("compress", 0.0)
                   + breakdown.get("compress_per_leaf", 0.0)
                   + breakdown.get("compress_per_bucket", 0.0)),
        "comm": breakdown.get("comm", 0.0),
    }
    total = sum(t.values())
    rec: Dict[str, float] = {
        "mode": breakdown.get("mode"),
        "source": "host_breakdown",
        "t_total_us": round(total * 1e6, 1),
    }
    for term, sec in t.items():
        rec[f"t_{term}_us"] = round(sec * 1e6, 1)
        rec[f"frac_{term}"] = round(sec / total, 6) if total else 0.0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dnn", default="resnet50")
    ap.add_argument("--modes", default="gtopk,dense")
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--topk-method", default="twostage")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--nworkers", type=int, default=1)
    ap.add_argument("--buckets", default="concat")
    ap.add_argument("--pipeline", default="serial")
    ap.add_argument("--min-seconds", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("benchmark: no CUDA device", file=sys.stderr)
            return 2
        from gtopkssgd_tpu_torch.profile_step import card_identity

        print(card_identity())
    for mode in args.modes.split(","):
        mode = None if mode in ("dense", "none") else mode
        cfg = BenchConfig(
            dnn=args.dnn, batch_size=args.batch_size, steps=args.steps,
            min_seconds=args.min_seconds, topk_method=args.topk_method,
            nworkers=args.nworkers, buckets=args.buckets,
            pipeline=args.pipeline, dtype=args.dtype, device=args.device)
        density = 1.0 if mode is None else args.density
        breakdown = measure_breakdown(cfg, mode, density)
        print(json.dumps({"mode": mode or "dense",
                          "throughput": measure_throughput(cfg, mode,
                                                           density),
                          "breakdown": breakdown,
                          "attr": attr_from_breakdown(breakdown)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
