#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Fails (exit != 0) at the first fault; there is no CPU fallback. Phases:

1. Card identity (nvidia-smi name and power limit); build the CUDA kernels
   from ``gtopkssgd_tpu_torch/ops/csrc/topk_kernels.cu`` (one nvcc call).
2. Each kernel against its plain PyTorch twin on the card, BITWISE, at
   N = 272,474 (ResNet-20) and N = 25,557,032 (ResNet-50's size); per
   kernel the median device time of 20 calls (CUDA events, the card kept
   busy ahead of each call so host overhead is not timed), beside the
   twin's, a one-call library yardstick the port never uses, and the bound
   max(bytes / 3.35 TB/s, operations / 67 TFLOP/s). The multisection
   kernel (lo, the 4x8 thresholds and the 4x8 counts, in abs and in
   residual mode) is also held to the four-launch path it replaced (the
   round loop counting with the single-pass count kernel), whose lo must
   be bitwise equal and whose time is reported as ``replaced_ms``.
3. The main path: the port's Trainer, ResNet-20 at full width on synthetic
   CIFAR-10, batch 32, gTop-k at density 0.001 -- 20 steps with
   ``--topk-method twostage`` (stage-1 kernel: one launch a step), 10 with
   ``pallas`` (multisection kernel in residual mode: one launch a step; no
   single-pass count launch), then 10 dense as the reference point.
   Launch counters are zeroed just before each run and read after.
4. The trainer's step on the card against the plain path on the CPU
   (where the wrappers run the twins, which the CPU tests hold bitwise to
   the JAX package's Pallas kernels): see ``reference_phase``.
5. P > 1: the trainer on P spawned ranks, 10 steps each, at P = 4 with
   ``twostage`` (stage-1 kernel, one launch a step on every rank), P = 3
   with ``pallas`` (the multisection kernel in abs mode, one cooperative
   launch a step on every rank, on one card three ranks time-sharing it;
   the ragged tree's fold, hypercube and unfold) and P = 4 dense. NCCL
   with one rank per card where there are P cards, else gloo with the
   ranks sharing the card (the model, the kernels and the merge stay on
   the card). Checks:
   launch counts on every rank; the global set bitwise equal on every
   rank after every step, and at step 1 bitwise equal to
   ``merge_tree_ref`` on the CPU over the gathered local sets; the final
   parameters bitwise equal on every rank; the gradient bytes a rank
   sends per step against ``comm_bytes_per_step`` at P = 4, the tree's
   rounds against ``tree_rounds`` at P = 3. See ``dist_phase``.
6. A ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
SIZES = (272_474, 25_557_032)
REPS = 20
LOSS_RTOL = 1e-3
SOURCE = "gtopkssgd_tpu_torch/ops/csrc/topk_kernels.cu"
# Entries of the kernels line, one per launch counter of
# ``cuda_topk.launches``: counter -> the TPU kernel it replaces.
REPLACES = {
    "multi_threshold_count": "gtopkssgd_tpu/ops/pallas_topk.py:96",
    "fused_stage1_candidates": "gtopkssgd_tpu/ops/pallas_topk.py:265",
    "fused_multi_threshold_count": "gtopkssgd_tpu/ops/pallas_topk.py:320",
    "multisection_tau_lo[abs]": "gtopkssgd_tpu/ops/pallas_topk.py:96",
    "multisection_tau_lo[residual]": "gtopkssgd_tpu/ops/pallas_topk.py:320",
}


def check_launches(got: dict, want: dict, run: str) -> None:
    """Every wrapper's count as `want` says, and 0 for the others."""
    full = {name: want.get(name, 0) for name in got}
    check(got == full, f"{run}: launches {got}, expected {full}")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def build_kernels() -> None:
    from gtopkssgd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build and load: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over `reps` calls, in ms. A 4096^3
    matmul is queued ahead of each timed call so the host enqueues the
    call before the card reaches the start event: the events then bracket
    device work only."""
    import torch

    busy = torch.ones(4096, 4096, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.mm(busy, busy)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def kernel_phase(n: int):
    """Every kernel against its twin at size n; returns the per-kernel
    records (bitwise match is required)."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk, topk

    gen = torch.Generator(device="cuda").manual_seed(n)
    g = torch.randn(n, device="cuda", generator=gen)
    r = 0.3 * torch.randn(n, device="cuda", generator=gen)
    acc = g + r
    mag = acc.abs()
    k = topk.k_for_density(n, 0.001)
    groups = topk._twostage_pallas_groups(n, k)
    sample = mag[torch.randint(0, n, (1 << 20,), device="cuda",
                               generator=gen)]
    q = torch.quantile(sample, torch.tensor(
        [0.05, 0.3, 0.5, 0.7, 0.9, 0.99, 0.999], device="cuda"))
    thr = torch.cat([q, mag[:1]]).contiguous()  # one threshold == a datum
    nb = max(1, -(-n // cuda_topk.BLOCK))
    L = nb * groups * cuda_topk.LANES
    cases = {
        "multi_threshold_count": dict(
            run=lambda: cuda_topk.multi_threshold_count(mag, thr),
            ref=lambda: cuda_topk.multi_threshold_count_ref(mag, thr),
            lib=lambda: (mag[:, None] >= thr).sum(0),
            bytes=4 * n + 64, ops=8 * n),
        "fused_stage1_candidates": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, None, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, None, r, groups=groups),
            lib=lambda: torch.topk((g + r).abs(), k),
            bytes=8 * n + 8 * L, ops=3 * n),
        "fused_stage1_candidates+counts": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, thr, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, thr, r, groups=groups),
            lib=lambda: torch.topk((g + r).abs(), k),
            bytes=8 * n + 8 * L + 64, ops=11 * n),
        "fused_multi_threshold_count": dict(
            run=lambda: cuda_topk.fused_multi_threshold_count(g, thr, r),
            ref=lambda: cuda_topk.fused_multi_threshold_count_ref(g, thr, r),
            lib=lambda: ((g + r).abs()[:, None] >= thr).sum(0),
            bytes=8 * n + 64, ops=10 * n),
        # One read of the operand in; lo, 32 thresholds, 32 counts out.
        # Operations: the add (residual), abs and max, then 4 rounds of 8
        # comparisons an element.
        "multisection_tau_lo[residual]": dict(
            run=lambda: cuda_topk.multisection_tau_lo(g, k, r),
            ref=lambda: cuda_topk.multisection_tau_lo_ref(g, k, r),
            old=lambda: cuda_topk.multisection_rounds(
                mag, k,
                lambda _m, t: cuda_topk.fused_multi_threshold_count(g, t, r)
            )[0],
            lib=lambda: torch.topk((g + r).abs(), k),
            bytes=8 * n + 260, ops=35 * n),
        "multisection_tau_lo[abs]": dict(
            run=lambda: cuda_topk.multisection_tau_lo(acc, k),
            ref=lambda: cuda_topk.multisection_tau_lo_ref(acc, k),
            old=lambda: cuda_topk.multisection_rounds(
                mag, k, cuda_topk.multi_threshold_count)[0],
            lib=lambda: torch.topk(acc.abs(), k),
            bytes=4 * n + 260, ops=34 * n),
    }
    out = {}
    for name, c in cases.items():
        got, want = c["run"](), c["ref"]()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = 0.0
        for a, b in zip(got, want):
            check((a is None) == (b is None), f"{name}: outputs differ")
            if a is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{name} n={n}: {a.dtype}{tuple(a.shape)} vs twin "
                  f"{b.dtype}{tuple(b.shape)}")
            err = max(err, max_abs_err(a, b))
            check(torch.equal(a, b),
                  f"{name} n={n}: kernel != twin (max abs err {err})")
        bnd, by = bound_ms(c["bytes"], c["ops"])
        rec = dict(n=n, groups=groups if "stage1" in name else None,
                   max_abs_err=err, ms=device_ms(c["run"]),
                   plain_ms=device_ms(c["ref"]), bound_ms=bnd, bound_by=by,
                   library_ms=device_ms(c["lib"]))
        extra = ""
        if "old" in c:
            lo_old = c["old"]()
            check(torch.equal(got[0], lo_old),
                  f"{name} n={n}: lo {float(got[0])!r} != the four-launch "
                  f"path's {float(lo_old)!r}")
            rec["replaced_ms"] = device_ms(c["old"])
            extra = f" replaced_ms={rec['replaced_ms']:.5f} (== its lo)"
        print(f"kernel {name:32s} n={n:>10,d} match=bitwise "
              f"ms={rec['ms']:.5f} plain_ms={rec['plain_ms']:.5f} "
              f"library_ms={rec['library_ms']:.5f} "
              f"bound_ms={rec['bound_ms']:.5f} ({by}){extra}")
        out[name] = rec
    return out


def train_run(method: str, compression: str, steps: int):
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=32, compression=compression,
        density=0.001, topk_method=method, device="cuda"))
    cuda_topk.reset_launches()
    stats = trainer.train(steps)
    launches = dict(cuda_topk.launches)
    losses = stats["losses"]
    check(all(math.isfinite(v) for v in losses),
          f"{compression}/{method}: non-finite loss {losses}")
    med = statistics.median(stats["step_times"])
    print(f"train resnet20 {compression}/{method}: {steps} steps, "
          f"params={trainer.num_params}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, median step {med * 1e3:.3f} ms, "
          f"launches {launches}")
    return launches


def reference_phase():
    """The trainer's step on the card against the plain path on the CPU,
    for both selection methods, from the same seed (same weights, same
    batches):

    (a) step 1 on the card and on the CPU: loss within 1e-3 relative (cuDNN
        and the CPU sum convolutions in different orders), keep sets with
        a Jaccard index >= 0.9 -- that rounding flips a few coordinates at
        tau (0.98 measured at density 0.001), while a layout or selection
        fault would give near 0;
    (b) step 2 on the card, with the residual that step 1 left: the CPU
        compressor (the kernels' twins) on the card's own flat gradient and
        residual must give the same keep mask and residual, bitwise.
    """
    import torch

    from gtopkssgd_tpu_torch.compression import TopKCompressor
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    for method in ("twostage", "pallas"):
        cfg = dict(batch_size=8, compression="gtopk", density=0.001,
                   topk_method=method)
        card = Trainer(TrainConfig(device="cuda", **cfg))
        cpu = Trainer(TrainConfig(device="cpu", **cfg))
        lg, lc = card.train(1)["loss"], cpu.train(1)["loss"]
        kg, kc = card.optimizer.last_keep.cpu(), cpu.optimizer.last_keep
        jac = float((kg & kc).sum()) / float((kg | kc).sum())
        check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
              f"reference {method}: step-1 loss {lg} vs cpu {lc}")
        check(jac >= 0.9, f"reference {method}: step-1 jaccard {jac}")

        opt = card.optimizer
        res_in = opt.state["residual"].cpu()
        card.train(1)
        grad = opt.flat_grad.cpu()
        keep, res, _ = TopKCompressor(0.001, method).compress_by_threshold(
            grad + res_in, grad=grad, residual=res_in)
        same = (torch.equal(keep, opt.last_keep.cpu())
                and torch.equal(res, opt.state["residual"].cpu()))
        print(f"reference {method}: step-1 loss card {lg:.6f} cpu {lc:.6f}, "
              f"keep {int(kg.sum())} vs {int(kc.sum())}, jaccard {jac:.4f}; "
              f"step-2 selection on the card's gradient: "
              f"{'bitwise' if same else 'DIFFERENT'} "
              f"({int(keep.sum())} kept)")
        check(same, f"reference {method}: card selection != cpu twins")


DIST_RUNS = (("twostage", "gtopk", 4), ("pallas", "gtopk", 3),
             ("exact", "dense", 4))
DIST_STEPS = 10


def dist_rank(device, method: str, compression: str, nworkers: int,
              steps: int) -> dict:
    """One rank of a P > 1 run (spawned by ``dist_phase``): trains `steps`
    steps and checks, after each, that every rank holds the same global
    set; returns this rank's launch and wire counters and its checks."""
    import torch
    import torch.distributed as dist

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.parallel import collectives
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=32, compression=compression,
        density=0.001, topk_method=method, device=str(device),
        nworkers=nworkers))
    opt, rank = trainer.optimizer, dist.get_rank()

    def gather(t):
        """Every rank's copy of t, on the CPU, in rank order."""
        out = [None] * nworkers
        dist.all_gather_object(out, t.detach().cpu())
        return out

    def wire_set(vals, idx):
        return torch.cat([vals.view(torch.int32), idx])

    cuda_topk.reset_launches()
    collectives.reset_wire()
    times, losses, agree, tree_ok = [], [], True, None
    for step in range(steps):
        stats = trainer.train(1)
        times.append(stats["step_times"][0])
        losses.append(stats["loss"])
        if opt.last_global is None:
            continue
        sets = gather(wire_set(*opt.last_global))
        agree = agree and all(torch.equal(x, sets[0]) for x in sets)
        if step == 0:
            n, k = trainer.num_params, opt.last_global[0].shape[0]
            local = [(x[:k].view(torch.float32), x[k:])
                     for x in gather(wire_set(*opt.last_local))]
            want = collectives.merge_tree_ref(local, k, n)[rank]
            tree_ok = torch.equal(wire_set(*want), sets[rank])
    launches = dict(cuda_topk.launches)
    wire = dict(collectives.wire)
    flat = trainer.layout.ravel([p.detach() for p in trainer.layout.params])
    params = gather(flat)
    return dict(rank=rank, device=str(device), launches=launches,
                wire=wire, step_times=times, losses=losses,
                sets_agree=agree, tree_ok=tree_ok,
                params_agree=all(torch.equal(x, params[0]) for x in params))


def dist_phase():
    """The P > 1 runs (see the module docstring, phase 5); returns the
    launches per kernel, summed over every rank of every run."""
    import torch

    from gtopkssgd_tpu_torch.parallel import comm_bytes_per_step, tree_rounds
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    cards = torch.cuda.device_count()
    total = {name: 0 for name in REPLACES}
    for method, compression, p in DIST_RUNS:
        backend = "nccl" if cards >= p else "gloo"
        used = min(cards, p)
        t0 = time.perf_counter()
        ranks = spawn(dist_rank, p, method, compression, p, DIST_STEPS,
                      backend=backend, device="cuda", timeout=300)
        wall = time.perf_counter() - t0
        run = f"P={p} {compression}/{method}"
        want_launches = {
            "twostage": {"fused_stage1_candidates": DIST_STEPS},
            "pallas": {"multisection_tau_lo[abs]": DIST_STEPS},
        }.get(method, {}) if compression == "gtopk" else {}
        for r in ranks:
            check_launches(r["launches"], want_launches,
                           f"{run} rank {r['rank']}")
            check(all(math.isfinite(v) for v in r["losses"]),
                  f"{run} rank {r['rank']}: non-finite loss {r['losses']}")
            check(r["params_agree"], f"{run}: final parameters differ "
                                     "across ranks")
            for name in REPLACES:
                total[name] += r["launches"][name]
        per_step = [r["wire"]["bytes"] / DIST_STEPS for r in ranks]
        if compression == "gtopk":
            check(all(r["sets_agree"] for r in ranks),
                  f"{run}: global sets differ across ranks")
            check(all(r["tree_ok"] for r in ranks),
                  f"{run}: global set != merge_tree_ref of the local sets")
            rounds = [r["wire"]["rounds"] / DIST_STEPS for r in ranks]
            check(rounds == [tree_rounds(p)] * p,
                  f"{run}: {rounds} tree rounds a step, model "
                  f"{tree_rounds(p)}")
        if p & (p - 1) == 0:
            model = comm_bytes_per_step(compression, 272_474, 273, p)
            check(per_step == [model] * p,
                  f"{run}: {per_step} bytes a step, model {model}")
        med = statistics.median(
            t for r in ranks for t in r["step_times"][1:])
        print(f"dist {run}: backend {backend}, {used} card(s) for {p} "
              f"ranks, {DIST_STEPS} steps, loss "
              f"{ranks[0]['losses'][0]:.4f} -> {ranks[0]['losses'][-1]:.4f}, "
              f"median step {med * 1e3:.3f} ms (steps 2-{DIST_STEPS}, all "
              f"ranks), bytes sent a step per rank {per_step}, launches "
              f"per rank {ranks[0]['launches']}, global sets and final "
              f"params bitwise equal across ranks"
              + (", step-1 set == merge_tree_ref"
                 if compression == "gtopk" else "")
              + f"; spawn to join {wall:.1f} s")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this test runs on the "
              "card only", file=sys.stderr)
        return 2
    try:
        from gtopkssgd_tpu_torch.profile_step import card_identity
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = card_identity()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    build_kernels()

    kernels = {n: kernel_phase(n) for n in SIZES}

    runs = [train_run("twostage", "gtopk", 20),
            train_run("pallas", "gtopk", 10),
            train_run("exact", "dense", 10)]
    check_launches(runs[0], {"fused_stage1_candidates": 20},
                   "P=1 twostage, 20 steps")
    check_launches(runs[1], {"multisection_tau_lo[residual]": 10},
                   "P=1 pallas, 10 steps")
    check_launches(runs[2], {}, "P=1 dense, 10 steps")
    total = {name: sum(r[name] for r in runs) for name in REPLACES}

    reference_phase()

    for name, count in dist_phase().items():
        total[name] += count

    n0 = SIZES[0]
    line = []
    for name in REPLACES:
        rec = kernels[n0][name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": total[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "n": n0, "match": "bitwise",
            "on_path": total[name] > 0,
            "at_n_25557032": {key: kernels[SIZES[1]][name][key] for key in
                              ("ms", "plain_ms", "bound_ms", "library_ms",
                               "max_abs_err", "replaced_ms")
                              if key in rec},
        }
        if "replaced_ms" in rec:
            entry["replaced_ms"] = rec["replaced_ms"]
        if name == "fused_stage1_candidates":
            entry["with_counts"] = {
                n: {key: kernels[n][name + "+counts"][key] for key in
                    ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                for n in SIZES}
        line.append(entry)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
