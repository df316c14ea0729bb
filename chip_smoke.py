#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Fails (exit != 0) at the first fault; there is no CPU fallback. Phases:

1. Card identity (nvidia-smi name and power limit); build the CUDA kernels
   from ``gtopkssgd_tpu_torch/ops/csrc/topk_kernels.cu`` (one nvcc call).
2. Each kernel against its plain PyTorch twin on the card, BITWISE, at
   N = 272,474 (ResNet-20), N = 14,986,698 (VGG-16), N = 19,775,200 (the
   PTB LSTM), N = 20,340,477 (the AN4 DeepSpeech model), N = 25,557,032
   (ResNet-50) and N = 61,100,840 (AlexNet, the largest flat gradient of
   the zoo); per
   kernel the median device time of 20 calls (CUDA events, the card kept
   busy ahead of each call so host overhead is not timed), beside the
   twin's, a one-call library yardstick the port never uses, and the bound
   max(bytes / 3.35 TB/s, operations / 67 TFLOP/s); first, an empty
   kernel's time, ``launch_floor_ms``. The multisection
   kernel (lo, the 4x8 thresholds and the 4x8 counts, in abs and in
   residual mode) is also held to the four-launch path it replaced (the
   round loop counting with the single-pass count kernel), whose lo must
   be bitwise equal and whose time is reported as ``replaced_ms``. The
   stage-1 kernel is also held to its twin, not timed, without the
   residual at both sizes, and on ``stage1_design.edge_cases``: n in {1,
   127, 1000, 262,143, 262,145} x groups in {1, 8, 64, 2048}, views one
   float into their buffers (4-byte loads), and equal maxima of opposite
   signs in rows that different warps read; residual on and off, counts
   off and on, each.
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
6. The flat path's options and the wire codecs, ResNet-20 at full width,
   batch 32, density 0.001 (k = 273 of N = 272,474):
   (a) P = 1 ``twostage`` with momentum correction, clip 5.0 and 3 dense
       warm-up steps, 10 steps: 7 stage-1 launches (none in the warm-up);
       at a warm-up step the update is the velocity and v is unchanged;
       at a sparse step v_new + update == v_old + u (u the velocity
       before masking) bitwise and u_new is 0 where keep holds. P = 1
       ``pallas`` with momentum correction, 5 steps: one residual-mode
       multisection launch a step. See ``correction_phase``.
   (b) The codec on the card against the codec on the CPU, bitwise in
       the words and in the decoded (vals, idx): int8, fp8 and fp8:32 at
       (k, n) = (273, 272,474) and (25,557, 25,557,032), an all-sentinel
       set, a set with k = n, the rounding midpoints of int8 and fp8, and
       block maxima whose bf16 scale is a rounding tie; the median device
       time of encode and decode at both sizes. See ``codec_phase``.
   (c) P > 1 with the codecs and the allgather baseline, 10 steps each:
       P = 4 gtopk ``twostage`` int8 and fp8 (1,400 bytes a rank a step
       by the model), P = 3 gtopk ``pallas`` fp8:32 (``tree_rounds(3)``
       rounds of 708-byte sets), P = 4 ``allgather`` ``twostage`` int8
       (2,800 bytes) and P = 4 ``topk`` ``pallas`` fp32 (8,736 bytes;
       nothing folded: residual + picks == accumulator, bitwise). The
       phase 5 checks, with ``merge_tree_ref(..., codec=)`` at step 1 for
       gtopk and, for the allgather modes, the dense union bitwise equal
       across ranks and at step 1 to the rank-order sum of the decoded
       sets on the CPU.
7. The vision zoo on the card, at full width and depth, float32 with TF32
   off, density 0.001, batch 32 a rank (see ``model_phase`` and
   ``reference_steps``):
   (a) ResNet-50 on synthetic ImageNet (224x224, k = 25,558 of N =
       25,557,032): 10 steps ``twostage`` (stage-1 kernel, one launch a
       step), 10 ``pallas`` (residual-mode multisection, one a step), 5
       dense (none); then ``test()`` on 2 batches: a finite loss, top-1
       and top-5 in [0, 1].
   (b) VGG-16 on synthetic CIFAR-10 (N = 14,986,698): 10 steps
       ``twostage``, then ``test()``.
   (c) AlexNet on synthetic ImageNet (N = 61,100,840): 10 steps
       ``pallas``, then ``test()``.
   (d) ResNet-50 at P = 4 ``pallas``, 5 steps: the abs-mode multisection
       kernel once a step on every rank, with phase 5's checks.
   (e) Each of the three models one step on the card (the kernels) and on
       the CPU (the twins) from the same seed at batch 2, dropout off on
       both: losses within 1e-3 relative, keep sets with a Jaccard index
       of at least 0.999 (1.0000 and 0.99997 measured: the two sum the
       convolutions in different orders, which flips a coordinate or two
       at tau); then a second step on the card, whose keep mask and
       residual must equal, bitwise, the CPU twins' selection on the
       card's own flat gradient and residual.
   Every run prints its median step ms and samples/s.
8. The recurrent zoo on the card, at full width, float32 with TF32 off
   (cuDNN's LSTM included), density 0.001, batch 32 a rank (see
   ``model_phase`` and ``reference_steps``):
   (a) The PTB LSTM on synthetic PTB (N = 19,775,200, k = 19,776; BPTT
       35, clip 0.25): 10 steps ``twostage`` (stage-1 kernel, one launch a
       step), 10 ``pallas`` (residual-mode multisection, one a step), 5
       dense (none); then ``test()`` on 2 windows: a finite loss and
       ``val_ppl`` == exp(``val_loss``).
   (b) The AN4 DeepSpeech model on synthetic AN4 padded to 400 frames (N
       = 20,340,477; clip 400): 10 steps ``twostage``, across the 8-step
       epoch, so the 1/1.01 anneal has taken effect; then ``test()`` on 2
       batches: a finite loss, CER and WER >= 0.
   (c) The PTB LSTM at P = 4 ``pallas``, 5 steps: the abs-mode
       multisection kernel once a step on every rank, with phase 5's
       checks, and each rank's carry distinct from every other's.
   (d) Each model one step on the card and on the CPU from the same seed
       at batch 2, dropout off (the PTB LSTM with ``twostage`` and with
       ``pallas``, the AN4 model with ``pallas``): losses within 1e-3
       relative, keep sets over the coordinates whose accumulator is
       nonzero (a PTB gradient is mostly exact zeros: the embedding rows a
       batch does not touch) with a Jaccard index of at least
       ``REFERENCE_JACCARD``; then a second step on the card, whose keep
       mask and residual must equal, bitwise, the CPU twins' selection on
       the card's own clipped flat gradient and residual.
   Every run prints its median step ms and samples/s, and tokens/s for
   PTB.
9. A ``kernels`` JSON line, then the last line
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
SIZES = (272_474, 14_986_698, 19_775_200, 20_340_477, 25_557_032,
         61_100_840)
REPS = 20
LOSS_RTOL = 1e-3
# Phases 7e and 8d; 1.00000 and 0.99997 measured (7e), 1.00000 (8d).
REFERENCE_JACCARD = 0.999
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
    from gtopkssgd_tpu_torch.stage1_design import stage1_mismatch

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
    buckets = torch.nn.functional.pad(
        mag, (0, nb * cuda_topk.BLOCK - n), value=-1.0).view(
        nb, groups, cuda_topk.BLOCK_ROWS // groups, cuda_topk.LANES)
    cases = {
        "multi_threshold_count": dict(
            run=lambda: cuda_topk.multi_threshold_count(mag, thr),
            ref=lambda: cuda_topk.multi_threshold_count_ref(mag, thr),
            lib=lambda: (mag[:, None] >= thr).sum(0),
            bytes=4 * n + 64, ops=8 * n),
        # Library: the bucket maxima and their rows over a precomputed,
        # padded |acc| (no add, CUDA's own tie rule); torch.topk is the
        # whole selection's yardstick, not this kernel's.
        "fused_stage1_candidates": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, None, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, None, r, groups=groups),
            lib=lambda: torch.max(buckets, dim=2),
            bytes=8 * n + 8 * L, ops=3 * n),
        "fused_stage1_candidates+counts": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, thr, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, thr, r, groups=groups),
            lib=lambda: torch.max(buckets, dim=2),
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
    bad = stage1_mismatch(g, None, groups)
    check(bad is None, f"fused_stage1_candidates n={n}, no residual: {bad}")
    print(f"kernel fused_stage1_candidates n={n:>10,d} without residual, "
          "counts off and on: match=bitwise (not timed)")
    return out


def stage1_edge_phase() -> int:
    """The stage-1 kernel against its twin on every edge case, in all four
    instantiations (residual on and off, counts off and on); returns the
    number of cases."""
    from gtopkssgd_tpu_torch.stage1_design import edge_cases, stage1_mismatch

    cases = 0
    for label, g, r, groups in edge_cases("cuda"):
        for res in (r, None):
            bad = stage1_mismatch(g, res, groups)
            check(bad is None, f"fused_stage1_candidates {label} "
                               f"groups={groups} residual "
                               f"{res is not None}: {bad}")
        print(f"kernel fused_stage1_candidates edge {label} groups={groups}"
              ": match=bitwise, residual on and off, counts off and on")
        cases += 1
    return cases


def train_run(method: str, compression: str, steps: int,
              dnn: str = "resnet20"):
    """`steps` steps of a fresh trainer on the card at batch 32; returns
    the launches (counters zeroed just before the run) and the
    trainer."""
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        dnn=dnn, batch_size=32, compression=compression, density=0.001,
        topk_method=method, eval_batches=2, device="cuda"))
    cuda_topk.reset_launches()
    stats = trainer.train(steps)
    launches = dict(cuda_topk.launches)
    losses = stats["losses"]
    check(all(math.isfinite(v) for v in losses),
          f"{dnn} {compression}/{method}: non-finite loss {losses}")
    med = statistics.median(stats["step_times"])
    tokens = ""
    if trainer.kind == "ptb":
        per_step = trainer.cfg.batch_size * trainer.train_data.bptt
        tokens = f"{per_step / med:.1f} tokens/s, "
    print(f"train {dnn} {compression}/{method}: {steps} steps, "
          f"params={trainer.num_params}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, median step {med * 1e3:.3f} ms, "
          f"{trainer.cfg.batch_size / med:.1f} samples/s, {tokens}"
          f"launches {launches}")
    return launches, trainer


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


# (method, compression, P, codec)
DIST_RUNS = (("twostage", "gtopk", 4, "fp32"), ("pallas", "gtopk", 3, "fp32"),
             ("exact", "dense", 4, "fp32"))
CODEC_RUNS = (("twostage", "gtopk", 4, "int8"),
              ("twostage", "gtopk", 4, "fp8"),
              ("pallas", "gtopk", 3, "fp8:32"),
              ("twostage", "allgather", 4, "int8"),
              ("pallas", "topk", 4, "fp32"))
DIST_STEPS = 10


def rank_order_union(local, k: int, n: int, codec: str):
    """The allgather union on the CPU: each rank's shipped set through the
    codec, added into a dense f32[n] one rank at a time, rank 0 first."""
    import torch

    from gtopkssgd_tpu_torch.parallel.codec import get_codec

    c = get_codec(codec)
    out = torch.zeros(n + 1)
    for vals, idx in local:
        v, i = c.decode(c.encode(vals, idx, n=n), k=k, n=n)
        out.index_add_(0, i.clamp(max=n).long(), v)
    return out[:n]


def dist_rank(device, method: str, compression: str, nworkers: int,
              steps: int, codec: str, dnn: str = "resnet20") -> dict:
    """One rank of a P > 1 run (spawned by ``dist_phase``): trains `steps`
    steps and checks, after each, that every rank holds the same global
    set (gtopk) or dense union (the allgather modes); returns this rank's
    launch and wire counters and its checks."""
    import torch
    import torch.distributed as dist

    from gtopkssgd_tpu_torch.ops import cuda_topk, scatter_add_dense
    from gtopkssgd_tpu_torch.parallel import collectives
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        dnn=dnn, batch_size=32, compression=compression,
        density=0.001, topk_method=method, device=str(device),
        nworkers=nworkers, wire_codec=codec))
    opt, rank = trainer.optimizer, dist.get_rank()

    def gather(t):
        """Every rank's copy of t, on the CPU, in rank order."""
        out = [None] * nworkers
        dist.all_gather_object(out, t.detach().cpu())
        return out

    def wire_set(vals, idx):
        return torch.cat([vals.view(torch.int32), idx])

    def local_sets():
        k = opt.last_local[0].shape[0]
        return k, [(x[:k].view(torch.float32), x[k:])
                   for x in gather(wire_set(*opt.last_local))]

    cuda_topk.reset_launches()
    collectives.reset_wire()
    times, losses, agree, ref_ok, mass_ok = [], [], True, None, None
    for step in range(steps):
        res_old = opt.state["residual"].clone()
        stats = trainer.train(1)
        times.append(stats["step_times"][0])
        losses.append(stats["loss"])
        n = trainer.num_params
        if opt.last_global is not None:
            sets = gather(wire_set(*opt.last_global))
            agree = agree and all(torch.equal(x, sets[0]) for x in sets)
            if step == 0:
                k, local = local_sets()
                want = collectives.merge_tree_ref(local, k, n,
                                                  codec=codec)[rank]
                ref_ok = torch.equal(wire_set(*want), sets[rank])
        elif opt.last_union is not None:
            unions = gather(opt.last_union.view(torch.int32))
            agree = agree and all(torch.equal(x, unions[0]) for x in unions)
            if step == 0:
                k, local = local_sets()
                want = rank_order_union(local, k, n, codec)
                ref_ok = torch.equal(want.view(torch.int32), unions[rank])
            if compression == "topk":  # every pick ships as it is
                vals, idx = opt.last_local
                kept = opt.state["residual"] + scatter_add_dense(n, idx,
                                                                 vals)
                ok = torch.equal(kept, opt.flat_grad + res_old)
                mass_ok = ok if mass_ok is None else mass_ok and ok
    launches = dict(cuda_topk.launches)
    wire = dict(collectives.wire)
    flat = trainer.layout.ravel([p.detach() for p in trainer.layout.params])
    params = gather(flat)
    carry_distinct = None
    if trainer.carry is not None:  # each rank carries its own rows
        hs = gather(trainer.carry[-1][1])
        carry_distinct = all(not torch.equal(a, b) for i, a in enumerate(hs)
                             for b in hs[i + 1:])
    return dict(rank=rank, device=str(device), n=trainer.num_params,
                launches=launches, wire=wire, step_times=times,
                losses=losses, carry_distinct=carry_distinct,
                sets_agree=agree, ref_ok=ref_ok, mass_ok=mass_ok,
                params_agree=all(torch.equal(x, params[0]) for x in params))


def dist_phase(runs, dnn: str = "resnet20", steps: int = DIST_STEPS) -> dict:
    """The P > 1 `runs` of `steps` steps of `dnn` (see the module
    docstring, phases 5, 6c and 7d); returns the launches per kernel,
    summed over every rank of every run."""
    import torch

    from gtopkssgd_tpu_torch.modes import ALLGATHER_MODES
    from gtopkssgd_tpu_torch.ops.topk import k_for_density
    from gtopkssgd_tpu_torch.parallel import comm_bytes_per_step, tree_rounds
    from gtopkssgd_tpu_torch.parallel.codec import get_codec
    from gtopkssgd_tpu_torch.parallel.collectives import _tree_plan
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    cards = torch.cuda.device_count()
    total = {name: 0 for name in REPLACES}
    for method, compression, p, codec in runs:
        backend = "nccl" if cards >= p else "gloo"
        used = min(cards, p)
        t0 = time.perf_counter()
        ranks = spawn(dist_rank, p, method, compression, p, steps,
                      codec, dnn, backend=backend, device="cuda",
                      timeout=300)
        wall = time.perf_counter() - t0
        run = f"{dnn} P={p} {compression}/{method}/{codec}"
        n = ranks[0]["n"]
        k = k_for_density(n, 0.001)
        sparse = compression != "dense"
        want_launches = {
            "twostage": {"fused_stage1_candidates": steps},
            "pallas": {"multisection_tau_lo[abs]": steps},
        }.get(method, {}) if sparse else {}
        for r in ranks:
            check_launches(r["launches"], want_launches,
                           f"{run} rank {r['rank']}")
            check(all(math.isfinite(v) for v in r["losses"]),
                  f"{run} rank {r['rank']}: non-finite loss {r['losses']}")
            check(r["params_agree"], f"{run}: final parameters differ "
                                     "across ranks")
            check(r["carry_distinct"] is not False,
                  f"{run}: two ranks hold the same carry")
            for name in REPLACES:
                total[name] += r["launches"][name]
        per_step = [r["wire"]["bytes"] / steps for r in ranks]
        rounds = [r["wire"]["rounds"] / steps for r in ranks]
        model = comm_bytes_per_step(compression, n, k, p, codec=codec)
        if sparse:
            what = ("dense unions" if compression in ALLGATHER_MODES
                    else "global sets")
            check(all(r["sets_agree"] for r in ranks),
                  f"{run}: {what} differ across ranks")
            check(all(r["ref_ok"] for r in ranks),
                  f"{run}: step 1 differs from the CPU reference")
        if compression == "gtopk":
            check(rounds == [tree_rounds(p)] * p,
                  f"{run}: {rounds} tree rounds a step, model "
                  f"{tree_rounds(p)}")
            set_bytes = get_codec(codec).wire_set_bytes(k, n)
            sends = sum(len(pairs) for pairs in _tree_plan(p))
            check(sum(per_step) == sends * set_bytes,
                  f"{run}: {per_step} bytes a step, {sends} sets of "
                  f"{set_bytes} bytes expected in all")
        elif compression in ALLGATHER_MODES:
            check(rounds == [1] * p, f"{run}: {rounds} rounds a step")
        if compression == "topk":
            check(all(r["mass_ok"] for r in ranks),
                  f"{run}: residual + shipped picks != accumulator")
        if p & (p - 1) == 0:
            check(per_step == [model] * p,
                  f"{run}: {per_step} bytes a step, model {model}")
        med = statistics.median(
            t for r in ranks for t in r["step_times"][1:])
        print(f"dist {run}: backend {backend}, {used} card(s) for {p} "
              f"ranks, {steps} steps, loss "
              f"{ranks[0]['losses'][0]:.4f} -> {ranks[0]['losses'][-1]:.4f}, "
              f"median step {med * 1e3:.3f} ms (steps 2-{steps}, all "
              f"ranks), {32 * p / med:.1f} samples/s in all, "
              f"bytes sent a step per rank {per_step} "
              f"(comm_bytes_per_step {model}), launches "
              f"per rank {ranks[0]['launches']}, final params bitwise "
              f"equal across ranks"
              + (f", {what} bitwise equal across ranks and at step 1 to "
                 "the CPU reference" if sparse else "")
              + (", nothing folded" if compression == "topk" else "")
              + (", each rank's carry distinct"
                 if ranks[0]["carry_distinct"] else "")
              + f"; spawn to join {wall:.1f} s")
    return total


def correction_phase() -> dict:
    """Phase 6a (see the module docstring); returns the launches."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.optimizer import (
        clip_by_global_norm,
        velocity_update,
    )
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    total = {name: 0 for name in REPLACES}
    clip, warmup, steps = 5.0, 3, 10
    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=32, compression="gtopk", density=0.001,
        topk_method="twostage", momentum_correction=True,
        clip_grad_norm=clip, device="cuda"))
    opt = trainer.optimizer = trainer.make_optimizer(warmup_dense_steps=warmup)
    lay = trainer.layout
    run = "P=1 gtopk/twostage correction clip warm-up 3"
    cuda_topk.reset_launches()
    losses = []
    for step in range(steps):
        v_old = opt.state["residual"]["v"].clone()
        u_old = opt.state["residual"]["u"].clone()
        losses.append(trainer.train(1)["loss"])
        v_new, u_new = opt.state["residual"]["v"], opt.state["residual"]["u"]
        update = lay.ravel([p.grad for p in lay.params])
        u = velocity_update(trainer.cfg.momentum, u_old,
                            clip_by_global_norm(opt.flat_grad, clip))
        if step < warmup:
            check(opt.last_keep is None and torch.equal(update, u)
                  and torch.equal(v_new, v_old) and torch.equal(u_new, u),
                  f"{run}: warm-up step {step + 1} is not the dense "
                  "velocity with v and u passed through")
            continue
        keep = opt.last_keep
        check(keep is not None, f"{run}: step {step + 1} kept nothing")
        check(torch.equal(v_new + update, v_old + u),
              f"{run}: step {step + 1}: v_new + update != v_old + u")
        check(bool((u_new[keep] == 0).all())
              and torch.equal(u_new[~keep], u[~keep]),
              f"{run}: step {step + 1}: u not masked exactly where kept")
    launches = dict(cuda_topk.launches)
    check(all(math.isfinite(v) for v in losses),
          f"{run}: non-finite loss {losses}")
    check_launches(launches, {"fused_stage1_candidates": steps - warmup},
                   f"{run}, {steps} steps")
    print(f"options {run}: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, launches {launches}; warm-up steps dense "
          "with v and u passed through, sparse steps v_new + update == "
          "v_old + u and u_new == 0 where kept, bitwise")
    for name in REPLACES:
        total[name] += launches[name]

    trainer = Trainer(TrainConfig(
        dnn="resnet20", batch_size=32, compression="gtopk", density=0.001,
        topk_method="pallas", momentum_correction=True, nesterov=False,
        device="cuda"))
    cuda_topk.reset_launches()
    losses = trainer.train(5)["losses"]
    launches = dict(cuda_topk.launches)
    run = "P=1 gtopk/pallas correction"
    check(all(math.isfinite(v) for v in losses),
          f"{run}: non-finite loss {losses}")
    check_launches(launches, {"multisection_tau_lo[residual]": 5},
                   f"{run}, 5 steps")
    print(f"options {run}: 5 steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, launches {launches}")
    for name in REPLACES:
        total[name] += launches[name]
    return total


CODEC_SPECS = ("int8", "fp8", "fp8:32")
CODEC_SIZES = ((273, 272_474), (25_557, 25_557_032))


def midpoint_set(spec: str):
    """(vals, idx) on the CPU whose values sit on the quantizer's rounding
    midpoints and one float32 ulp either side (int8's j + 0.5, fp8's
    midpoints between consecutive e4m3fn values, both signs) times 2^-4;
    every 4th value (index order) is qmax * 2^-4, so every block's bf16
    scale is exactly 2^-4."""
    import torch

    s = 2.0 ** -4
    if spec.startswith("int8"):
        mids, qmax = torch.arange(-127, 127, dtype=torch.float32) + 0.5, 127.0
    else:
        grid = torch.arange(0x7F, dtype=torch.uint8).view(
            torch.float8_e4m3fn).to(torch.float32)
        pos = (grid[:-1] + grid[1:]) / 2
        mids, qmax = torch.cat([pos, -pos]), 448.0
    v = mids * s
    inf = torch.full_like(v, math.inf)
    vals = torch.stack([torch.full_like(v, qmax * s), v,
                        torch.nextafter(v, inf), torch.nextafter(v, -inf)],
                       dim=1).reshape(-1)
    return vals, torch.arange(vals.numel(), dtype=torch.int32)


def scale_midpoint_set(spec: str, nblocks: int = 64):
    """(vals, idx) on the CPU whose block maxima are qmax times a bf16
    rounding midpoint, so amax / qmax is a tie of the bf16 rounding when
    the quotient is IEEE (and off it, by an ulp, when it is not); the
    other values of a block are the maximum times (-1, 1)."""
    import torch

    from gtopkssgd_tpu_torch.parallel.codec import get_codec

    c = get_codec(spec)
    gen = torch.Generator().manual_seed(9)
    b = (torch.rand(nblocks, generator=gen) * 8 - 10).exp2()
    b = b.to(torch.bfloat16)
    nxt = (b.view(torch.int16) + 1).view(torch.bfloat16)
    mid = (b.to(torch.float32) + nxt.to(torch.float32)) / 2
    amax = mid * c.qmax
    rest = torch.rand(nblocks, c.block - 1, generator=gen) * 2 - 1
    vals = torch.cat([amax[:, None], amax[:, None] * rest], dim=1)
    vals = vals.reshape(-1)
    return vals, torch.arange(vals.numel(), dtype=torch.int32)


def codec_phase() -> None:
    """Phase 6b (see the module docstring); prints the median device ms
    of encode and decode by codec and size."""
    import torch

    from gtopkssgd_tpu_torch.parallel.codec import get_codec

    gen = torch.Generator().manual_seed(5)

    def random_set(k, n, pad):
        idx = torch.randperm(n, generator=gen)[:k - pad].to(torch.int32)
        vals = 3 * torch.randn(k - pad, generator=gen)
        return (torch.cat([vals, torch.zeros(pad)]),
                torch.cat([idx, torch.full((pad,), n, dtype=torch.int32)]))

    cases = [(f"k={k} n={n}", *random_set(k, n, 2), n)
             for k, n in CODEC_SIZES]
    cases.append(("all-sentinel", torch.zeros(273),
                  torch.full((273,), 272_474, dtype=torch.int32), 272_474))
    cases.append(("k=n", torch.randn(4096, generator=gen),
                  torch.randperm(4096, generator=gen).to(torch.int32), 4096))
    timings = {}
    for spec in CODEC_SPECS:
        c = get_codec(spec)
        mids, smids = midpoint_set(spec), scale_midpoint_set(spec)
        for label, vals, idx, n in cases + [
                ("midpoints", *mids, 2 * mids[0].numel()),
                ("scale midpoints", *smids, 2 * smids[0].numel())]:
            k = vals.numel()
            w_cpu = c.encode(vals, idx, n=n)
            w_dev = c.encode(vals.cuda(), idx.cuda(), n=n)
            check(w_dev.is_cuda and torch.equal(w_dev.cpu(), w_cpu),
                  f"codec {spec} {label}: card words != cpu words")
            v_cpu, i_cpu = c.decode(w_cpu, k=k, n=n)
            v_dev, i_dev = c.decode(w_dev, k=k, n=n)
            check(torch.equal(i_dev.cpu(), i_cpu)
                  and torch.equal(v_dev.cpu().view(torch.int32),
                                  v_cpu.view(torch.int32)),
                  f"codec {spec} {label}: card decode != cpu decode")
        for (k, n), (_, vals, idx, _) in zip(CODEC_SIZES, cases):
            vals, idx = vals.cuda(), idx.cuda()
            wire = c.encode(vals, idx, n=n)
            timings[f"{spec} k={k}"] = {
                "encode_ms": device_ms(lambda: c.encode(vals, idx, n=n)),
                "decode_ms": device_ms(lambda: c.decode(wire, k=k, n=n)),
                "wire_bytes": 4 * wire.numel()}
        print(f"codec {spec}: card == cpu bitwise (words, vals, idx) on "
              f"{len(cases) + 2} sets: " + ", ".join(label for label, *_ in
                                                    cases)
              + ", midpoints, scale midpoints")
    print("codec_ms " + json.dumps(timings))


def evaluate(trainer, run: str) -> None:
    """``test()`` of `trainer`: a finite loss, and top-1 and top-5 in
    [0, 1] (vision), perplexity exp(loss) (PTB), or CER and WER >= 0
    (AN4)."""
    t0 = time.perf_counter()
    metrics = trainer.test()
    wall = time.perf_counter() - t0
    loss = metrics["val_loss"]
    if trainer.kind == "ptb":
        ok = math.isclose(metrics["val_ppl"], math.exp(min(loss, 20.0)),
                          rel_tol=1e-12)
    elif trainer.kind == "an4":
        ok = metrics["val_cer"] >= 0.0 and metrics["val_wer"] >= 0.0
    else:
        ok = 0.0 <= metrics["val_top1"] <= metrics["val_top5"] <= 1.0
    check(math.isfinite(loss) and ok, f"{run}: test() gave {metrics}")
    print(f"test {run}: {trainer.cfg.eval_batches} batches of "
          f"{trainer.cfg.batch_size}, {metrics}, {wall:.2f} s")


# (dnn, [(method, compression, steps)]) of phase 7, P = 1
ZOO_RUNS = (("resnet50", (("twostage", "gtopk", 10), ("pallas", "gtopk", 10),
                          ("exact", "dense", 5))),
            ("vgg16", (("twostage", "gtopk", 10),)),
            ("alexnet", (("pallas", "gtopk", 10),)))
# (dnn, P > 1 runs, their steps) of phase 7d
ZOO_DIST = ("resnet50", (("pallas", "gtopk", 4, "fp32"),), 5)
# (dnn, method) of phase 7e
ZOO_REFERENCE = (("resnet50", "twostage"), ("vgg16", "twostage"),
                 ("alexnet", "pallas"))
# The same for phase 8
RECURRENT_RUNS = (("lstm", (("twostage", "gtopk", 10), ("pallas", "gtopk", 10),
                            ("exact", "dense", 5))),
                  ("lstman4", (("twostage", "gtopk", 10),)))
RECURRENT_DIST = ("lstm", (("pallas", "gtopk", 4, "fp32"),), 5)
RECURRENT_REFERENCE = (("lstm", "twostage"), ("lstm", "pallas"),
                       ("lstman4", "pallas"))


def model_phase(runs, dist) -> dict:
    """Phases 7 (a)-(d) and 8 (a)-(c) (see the module docstring): the P =
    1 `runs`, each model's last trainer then ``test()``, and the P > 1
    runs of `dist`; returns the launches per kernel."""
    import numpy as np

    total = {name: 0 for name in REPLACES}
    want = {"twostage": "fused_stage1_candidates",
            "pallas": "multisection_tau_lo[residual]"}
    for dnn, dnn_runs in runs:
        for method, compression, steps in dnn_runs:
            launches, trainer = train_run(method, compression, steps, dnn)
            check_launches(launches, {want[method]: steps}
                           if compression == "gtopk" else {},
                           f"{dnn} P=1 {compression}/{method}, {steps} "
                           "steps")
            for name in REPLACES:
                total[name] += launches[name]
        if trainer.kind == "an4":
            # The last step's lr is the schedule's at count steps - 1,
            # past the first epoch: base * (1/1.01).
            spe, base = trainer.steps_per_epoch, trainer.cfg.lr
            lr = trainer.optimizer.param_groups[0]["lr"]
            annealed = float(np.float32(base) * np.float32(1 / 1.01))
            check(steps > spe and lr == annealed,
                  f"{dnn}: lr {lr} after {steps} steps of {spe} an epoch, "
                  f"expected {annealed}")
            print(f"train {dnn}: {spe} steps an epoch, lr {base} -> {lr} "
                  "(the 1/1.01 anneal)")
        evaluate(trainer, f"{dnn} after {compression}/{method}")
        del trainer
    dnn, dist_runs, steps = dist
    for name, count in dist_phase(dist_runs, dnn, steps).items():
        total[name] += count
    return total


def reference_steps(cases) -> None:
    """Phases 7e and 8d: for each (dnn, method) of `cases`, one step on
    the card and on the CPU from the same seed (the same weights and
    batches), dropout off; then a second step on the card, its selection
    held bitwise to the CPU twins' on the card's own (clipped) gradient
    and residual."""
    import torch

    from gtopkssgd_tpu_torch.compression import TopKCompressor
    from gtopkssgd_tpu_torch.models import Dropout
    from gtopkssgd_tpu_torch.optimizer import clip_by_global_norm
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    for dnn, method in cases:
        cfg = dict(dnn=dnn, batch_size=2, compression="gtopk",
                   density=0.001, topk_method=method)
        pair = [Trainer(TrainConfig(device=d, **cfg))
                for d in ("cuda", "cpu")]
        for trainer in pair:
            for mod in trainer.model.modules():
                if isinstance(mod, Dropout):
                    mod.rate = 0.0
        lg, lc = (t.train(1)["loss"] for t in pair)
        # Step 1 starts from a zero residual: acc != 0 where grad != 0.
        kg, kc = ((t.optimizer.last_keep & (t.optimizer.flat_grad != 0)
                   ).cpu() for t in pair)
        nonzero = int((pair[1].optimizer.flat_grad != 0).sum())
        jac = float((kg & kc).sum()) / float((kg | kc).sum())
        run = f"reference {dnn} {method}"
        check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
              f"{run}: step-1 loss {lg} vs cpu {lc}")
        check(jac >= REFERENCE_JACCARD, f"{run}: step-1 jaccard {jac}")

        card = pair[0]
        del pair
        opt = card.optimizer
        res_in = opt.state["residual"].cpu()
        card.train(1)
        grad = opt.flat_grad
        if card.cfg.clip_grad_norm is not None:
            grad = clip_by_global_norm(grad, card.cfg.clip_grad_norm)
        grad = grad.cpu()
        keep, res, _ = TopKCompressor(0.001, method).compress_by_threshold(
            grad + res_in, grad=grad, residual=res_in)
        same = (torch.equal(keep, opt.last_keep.cpu())
                and torch.equal(res, opt.state["residual"].cpu()))
        print(f"{run}: step-1 loss card {lg:.6f} cpu {lc:.6f}, "
              f"keep {int(kg.sum())} vs {int(kc.sum())} of {nonzero:,} "
              f"nonzero, jaccard {jac:.5f}; step-2 selection on the card's "
              f"gradient (N = {card.num_params}): "
              f"{'bitwise' if same else 'DIFFERENT'} "
              f"({int(keep.sum())} kept)")
        check(same, f"{run}: card selection != cpu twins")


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

    from gtopkssgd_tpu_torch.ops import cuda_topk

    floor = device_ms(lambda: cuda_topk.launch_floor(torch.device("cuda")))
    print(f"launch_floor_ms={floor:.5f} (an empty kernel, same route)")
    kernels = {n: kernel_phase(n) for n in SIZES}
    print(f"stage-1 edge cases: {stage1_edge_phase()} bitwise")

    runs = [train_run("twostage", "gtopk", 20)[0],
            train_run("pallas", "gtopk", 10)[0],
            train_run("exact", "dense", 10)[0]]
    check_launches(runs[0], {"fused_stage1_candidates": 20},
                   "P=1 twostage, 20 steps")
    check_launches(runs[1], {"multisection_tau_lo[residual]": 10},
                   "P=1 pallas, 10 steps")
    check_launches(runs[2], {}, "P=1 dense, 10 steps")
    total = {name: sum(r[name] for r in runs) for name in REPLACES}

    reference_phase()

    for name, count in dist_phase(DIST_RUNS).items():
        total[name] += count
    for name, count in correction_phase().items():
        total[name] += count
    codec_phase()
    for name, count in dist_phase(CODEC_RUNS).items():
        total[name] += count
    for name, count in model_phase(ZOO_RUNS, ZOO_DIST).items():
        total[name] += count
    reference_steps(ZOO_REFERENCE)
    for name, count in model_phase(RECURRENT_RUNS, RECURRENT_DIST).items():
        total[name] += count
    reference_steps(RECURRENT_REFERENCE)

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
            "n": n0, "match": "bitwise", "launch_floor_ms": floor,
            "on_path": total[name] > 0,
        }
        for n in SIZES[1:]:
            entry[f"at_n_{n}"] = {
                key: kernels[n][name][key] for key in
                ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                 "replaced_ms") if key in rec}
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
