#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Fails (exit != 0) at the first fault; there is no CPU fallback. Phases:

1. Card identity (nvidia-smi name and power limit); build the CUDA kernels
   from ``gtopkssgd_tpu_torch/ops/csrc/topk_kernels.cu`` (one nvcc call).
2. Each kernel against its plain PyTorch twin on the card, BITWISE, at
   N = 272,474 (ResNet-20), N = 14,986,698 (VGG-16), N = 19,775,200 (the
   PTB LSTM), N = 20,340,477 (the AN4 DeepSpeech model), N = 25,557,032
   (ResNet-50), N = 61,100,840 (AlexNet, the largest flat gradient of
   the zoo), and the largest leaves of ResNet-20 (36,864) and ResNet-50
   (2,359,296), which ``gtopk_layerwise`` selects over; per
   kernel the median device time of 20 calls (CUDA events, the card kept
   busy ahead of each call so host overhead is not timed), beside the
   twin's, a library yardstick the port never uses (one call, or for the
   stage-1 kernel three: add, abs and the bucket maxima over g and r
   padded beforehand), and the bound
   max(bytes / 3.35 TB/s, operations / 67 TFLOP/s); first, an empty
   kernel's time, ``launch_floor_ms``. Untimed, the stage-1 kernel and
   the multisection kernel in both modes at every distinct leaf size of
   ResNet-20 and ResNet-50 (31 sizes, 10 to 2,359,296), on leaves at an
   odd offset into their buffers, with the k and groups the per-leaf
   selection gives them. The multisection
   kernel (lo, the 4x8 thresholds and the 4x8 counts, in abs and in
   residual mode) is also held to the four-launch path it replaced (the
   round loop counting with the single-pass count kernel), whose lo must
   be bitwise equal and whose time is reported as ``replaced_ms``. The
   stage-1 kernel is also held to its twin, not timed, without the
   residual at both sizes, and on ``stage1_design.edge_cases``: n in {1,
   127, 1000, 262,143, 262,145} x groups in {1, 8, 64, 2048}, views one
   float into their buffers (4-byte loads), equal maxima of opposite
   signs in rows that different warps read, and NaNs (``nan_cases``: two
   NaNs in a bucket, NaN beside +inf, a NaN in the residual only, a NaN
   with its sign bit set, 1% NaNs, an all-NaN gradient); residual on and
   off, counts off and on, each, NaNs compared as bits. The multisection
   kernel in both modes is held to its twin bitwise on the NaN cases
   without infinities (``multisection_nan_phase``): the NaN rules of
   ``ops.cuda_topk``.
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
   rounds against ``tree_rounds`` at P = 3. See ``dist_phase``. The
   ResNet-20 runs of 5, 6c, 9c and 9d (10 steps each, ``RESNET20_DIST``)
   run here together, the runs of one P in one spawn: three spawns (P =
   4, 3 and 6), where one spawn a P a phase would start eight.
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
9. The rest of the JAX optimizer's modes, batch 32 a rank, density 0.001,
   TF32 off (see ``layerwise_phase``, ``dist_phase``, ``planner_phase``):
   (a) ResNet-50 ``gtopk_layerwise`` (``--buckets concat``, 161 leaves) at
       P = 1: 10 steps ``twostage`` (one stage-1 launch a leaf a step:
       1,610) and 10 ``pallas`` (one residual-mode multisection launch a
       leaf a step: 1,610); then, for each method, one step card against
       CPU as in 7e, the step-2 selection held leaf by leaf (all 161
       leaves, so every per-leaf call of either kernel on this path is
       held to its twin at its own size).
   (b) ResNet-50 ``gtopk_layerwise`` at P = 4, 5 steps ``twostage`` with
       ``--buckets concat`` (161 launches a rank a step) and 5 with
       ``--buckets 4`` (4), in one spawn: phase 5's checks, the reference
       per bucket, bytes equal to the model summed over the buckets.
   (c) ResNet-20 ``gtopk_hier`` ``twostage``, 10 steps: P = 4 with slices
       of 2 at fp32 and int8, P = 6 with slices of 3 (a ragged slice):
       the slice members hold bitwise the same slice sum (and a plain
       recursive-doubling sum's) and residual, the tree over one member
       of each slice as reference; bytes: the tree's sets as the model
       counts them, plus the 4N buffers the rank ships in the in-slice
       sum (``ici_psum_sends``: 4N at slices of 2, the model's term; at
       slices of 3, 8N, 4N and 4N by offset).
   (d) ResNet-20 ``gtopk --comm-plan balanced`` ``pallas``, 10 steps, at P
       = 4 and P = 3 (n < chunk * p) at fp32 and fp8:32: ``balanced_ref``
       at step 1, bytes (2p - 1) cap-sets at every P.
   (e) Every P > 1 run prints its plan decision; at P = 4 'auto' must keep
       the tree (the (b) runs), and the planner's choices and scores with
       each committed fit (gloo, NCCL) at P = 2..8 for ResNet-20's and
       ResNet-50's N.
   The runs of one P share one spawn.
10. The ``overlap`` and ``auto`` pipelines of the bucketed layer-wise
   wire, the selection cost measured on the card and the benchmark
   harness, batch 32 a rank, density 0.001, TF32 off (see
   ``select_phase``, ``pipeline_phase``, ``auto_phase``,
   ``harness_phase``):
   (a) The selection stage (``select_probe``) of each method at
       ResNet-50's ``--buckets 4`` sizes, once with host syncs made
       errors, each time beside the committed fit's prediction for this
       card (``parallel/select_fit.json``; a card it does not name
       fails).
   (b) ResNet-50 ``gtopk_layerwise --buckets 4`` at P = 4 (one card over
       gloo, NCCL where there are 4 cards), ``twostage`` and ``pallas``,
       5 steps each, in one spawn: two optimizers over one model,
       ``serial`` and ``overlap`` on the serial DP's cuts, stepped from
       the same parameters and gradients each step; updates, parameters,
       velocities, residuals and per-bucket global sets bitwise equal
       between the orders on every rank; bytes a rank a step 408,928
       (the model) in each order; launches 2 x 5 x 4 a rank; the median
       optimizer step of each order (the harness in (d) times each
       order's whole step, on per-rank batches); a profiled step of each
       order with its overlap share (``profile_step.overlap_share``),
       which must be above 0 under ``overlap`` on rank 0.
   (c) ``--buckets auto --pipeline auto`` for ResNet-20 and ResNet-50 at
       P = 2..8 under each committed comm fit and the card's
       ``twostage`` selection fit: the order, B and both spans.
   (d) ``benchmark.measure_throughput`` and ``measure_breakdown`` of
       ResNet-50 gTop-k ``twostage`` and dense at P = 1, and (inside
       (b)'s spawn) of the ``--buckets 4`` arm under each order at P =
       4, with ``attr_from_breakdown``.
11. The trainer's lifecycle and host path, batch 32, density 0.001, TF32
   off (see ``native_phase``, ``resume_phase``, ``bf16_phase``,
   ``dispatch_phase``):
   (a) The native data prep built from ``gtopkssgd_tpu_torch/native/src``
       with g++; a drawn CIFAR batch's augmentation bitwise the numpy
       path's; an AN4 greedy decode's counts with the library's edit
       distance equal to the Python one's.
   (b) ResNet-20 gTop-k ``twostage``: 3 steps, ``save()``, a new trainer
       with ``resume=True``, 3 more, against 6 straight: the whole state
       (parameters, BatchNorm statistics, momentum, residual, count)
       bitwise, at P = 1 and on both ranks at P = 2 over gloo on one
       card, under deterministic algorithms; each rank's metrics file
       led by a manifest, one config hash on both ranks.
   (c) ResNet-50 and the PTB LSTM ``twostage`` in bfloat16 and float32,
       10 steps each: step ms and losses; every stage-1 launch takes
       float32 inputs; the bfloat16 LSTM's cuDNN kernels named; the
       harness's throughput, MFU (bfloat16 against the card's dense
       bfloat16 peak) and breakdown for ResNet-50 at P = 1 in both
       dtypes.
   (d) ``--steps-per-dispatch 8`` against 1 at P = 1 (``dispatch_phase``):
       ResNet-20 ``twostage`` and ``pallas``, VGG-16 (dropout) and
       ResNet-50 ``twostage``; the graph's steps bitwise the eager ones,
       the kernels' launches counted through the replays.
12. The JPEG path, the remaining top-k methods and resilience, batch 32,
   density 0.001 (see ``jpeg_phase``, ``topk_phase``,
   ``resilience_phase``); each run of (a), (c) and (d) a process of its
   own, started from the command line or a ``python -c``:
   (a) A seeded ImageFolder written with PIL (4 classes x 48 train and
       16 val JPEGs, 500x375 at quality 90); ResNet-50 ``twostage``, 4
       steps with prefetch off, at ``--decode-workers`` 0 and 8: decode
       images/s, host "data" ms and step ms, the batches bitwise equal.
       Without PIL on the machine, one line says so and (a) is skipped.
   (b) ``exact | blockwise | approx | simrecall | twostage | pallas`` at
       ResNet-20's and the five zoo flat sizes: the whole selection stage's
       median ms of 20 calls and recall against ``exact``; ``blockwise``
       bitwise ``exact`` on distinct magnitudes; ``simrecall`` on the card
       bitwise the CPU on inputs whose sums are exact in any order;
       ``approx`` one stage-1 launch; ``auto``'s choice.
   (c) Through ``dist_trainer``: ResNet-20 ``twostage`` ``--inject
       preempt@3`` exits 45, ``--resume`` to step 6 bitwise 6 straight
       steps (deterministic algorithms); P = 2 ``pallas`` ``--elastic
       --inject resize@3:1`` exits 46 and writes ``elastic.json``, the P =
       1 restore's residual within one float32 ulp of the saved column
       sums, and the relaunch trains on; P = 1 ``resize@2:2`` exits 46 and
       two ranks restoring it hold the saved residual and zeros.
   (d) ``--multihost``: two processes told their ranks by the environment,
       their final state's parameters bitwise the spawned P = 2 run's.
13. The observability and the recovery policy (``obs_phase``), batch 32,
   density 0.001:
   (a) ResNet-50 ``twostage`` with ``--obs-layers`` and
       ``--obs-audit-interval 2``, 6 steps eager under deterministic
       algorithms: one "obs" record a step and one "layers" record a layer
       a step, each held to the counters recomputed in float64 from the
       step's own flat gradient, residual and keep mask (``obs_check``:
       sent and tau exact, the layers' densities and mean ages within two
       float32 roundings, norms and mass ratios within OBS_RTOL = 1e-5),
       the audit's recall in [0.95, 1] at counts 0, 2, 4 and carried at
       the others; then 6 steps at ``--steps-per-dispatch 2`` in CUDA
       graphs (two captures: the audit step and the plain one), whose
       records at steps 2, 4, 6 equal the eager run's, stage-1 launches 6
       counted through the replays. ResNet-20 ``pallas``, 6 steps eager,
       held likewise: one residual-mode multisection launch a step.
   (b) ResNet-20 ``twostage`` with ``nan_grad@3`` and ``nan_loss=skip``:
       the state after the skip bitwise the state after step 2, one "skip"
       record and the summary; the same through the command line: rc 0.
   (c) Through the command line: ``--obs-halt-on error`` with
       ``nan_grad@3`` exits 44 with step 3's "obs" record the last;
       ``--obs-watchdog 1`` with ``slow_rank:0:3s@3`` exits 43 with one
       "stall" record and a "stalled" summary.
14. The trace planes (``trace_phase``), batch 32, density 0.001:
   (a) ResNet-50 ``twostage`` eager, 6 steps, with ``--obs-critpath
       --obs-calib-interval 2 --obs-mem --obs-mem-interval 2
       --obs-goodput-interval 2``: "critpath" records at steps 2, 4, 6;
       each profiled dispatch's attributed select at least 0.8 x phase 2's
       K2 time at 25,557,032 a K2 launch, ``stage1_kernel`` among its
       select events; every "goodput" record conserved to 1e-6; one
       "compile" record, its FLOPs ``benchmark.py``'s count of the same
       step; "mem" records at steps 1, 3, 5 whose ``bytes_limit`` is the
       card's memory; ResNet-20 ``pallas``, 4 steps, a capture at step 4
       with the multisection kernel in select, the goodput record at step
       3 with other_frac <= 0.05.
   (b) ResNet-50 at ``--steps-per-dispatch 2`` in CUDA graphs, a capture
       at steps 3-4: source "ops", its stage-1 events in select as many as
       the replays ran (2); launches 6 through the replays.
   (c) P = 2 over gloo on the card, ResNet-20 ``twostage``, 8 steps,
       ``--obs-calib --obs-linkmap --obs-critpath --obs-calib-interval 2``:
       "attr" comm from the host's gloo events (> 0), "calib" records with
       finite constants fed the "obs" records' wire bytes, "linkmap"
       records keyed by ``round_peers``, ``calib_fit_2proc.json`` naming
       the card.
   (d) Through the command line: ``--profile-dir D --profile-steps 2``
       exits 0 and D's trace attributes compute and select; ``--inject
       nan_grad@3 --recover-policy nan_loss=skip`` ends in a "goodput"
       record with one wasted step.
   One line an arm: the attributed ms of each class, the overlap share,
   the critical path, the goodput fractions. No event of the rules these
   planes feed.
15. The planes that read beyond one run (``planes_phase``), batch 32 a
   rank, density 0.001, P = 2 (gloo on the one card, NCCL with two):
   (a) ResNet-50 ``twostage``, 8 steps, ``--obs-calib --obs-critpath
       --obs-linkmap --obs-calib-interval 2 --obs-forecast --registry R``,
       run twice, into A and into B: both exit 0; one durable "forecast"
       record a capture on each rank, with a finite ``hindcast_err_x``,
       a recommendation at 32, 256 and 1024 and the fit it priced with
       (a committed fit, a calib_fit file or the run's own refit, never
       a default); R/runs.jsonl two lines of one ``config_hash``;
       ``report history R`` prints both; ``report regress B --registry
       R`` (and against R as A left it) exits 0 or 1, never 2, printing
       every ``REGRESS_CHECKS`` field both lines hold; 8 stage-1 launches
       a rank.
   (b) ResNet-20 ``pallas``, 12 steps, ``--elastic --evict-after-windows
       1 --obs-goodput-interval 2 --inject slow_rank:1:2@1-12`` into C
       (in a process of its own, beside (a)): both ranks exit 46 at the
       same step with one durable "resize" record (reason "evict",
       ``evicted_ranks`` [1]) and ``elastic.json`` at P = 1; ``report
       goodput C --advise`` names rank 1 and ``report fleet C`` prints
       the straggler rows; a relaunch at ``--nworkers 1 --elastic
       --resume`` in a fresh dir seeded with C's ``ckpt/`` and
       ``elastic.json`` exits 0 and keeps the ``lineage_id``; one
       abs-mode multisection launch a step a rank.
   (c) Every ``report`` subcommand over A and C: the summary, ``gate``
       (against a baseline it writes from A with ``--write``), ``attr``,
       ``events``, ``recovery``, ``timeline``, ``critpath``, ``ledger``,
       ``linkmap``, ``forecast``, ``compile``, ``mem`` and ``plan`` exit
       0, but for the cases ``NOTHING_TO_SHOW`` names (exit 1: C has no
       captures).
   One line an arm: the hindcast error, the P = 256 recommendation, the
   crossover P, the registry line's steps/s and goodput, the eviction's
   step and goodput fractions; the card's name and power limit.
16. The experiment grid and graftlint (``experiments_phase``), each in a
   process of its own, started together:
   (a) ``python -m gtopkssgd_tpu_torch.experiments.run
       imagenet_resnet50_gtopk --nworkers 1 --batch-size 32 --num-iters
       3 --eval-batches 1`` (the north-star entry: ResNet-50, bfloat16,
       gtopk at density 0.001, ``auto`` top-k, which is ``twostage`` at
       25,557,032 elements): exit 0; its ``done:`` line with finite
       losses and val_loss, 3 steps, bfloat16, gtopk and density 0.001
       (the registry's config reached the trainer); 3 stage-1 launches
       and no other (the process's launch counters).
   (b) ``cifar10_resnet20_gtopk_recommended --nworkers 2 --batch-size 32
       --num-iters 2``: two ranks over gloo sharing the card, momentum
       correction on; exit 0, finite losses.
   (c) ``python -m gtopkssgd_tpu_torch.analysis gtopkssgd_tpu_torch
       chip_smoke.py`` from the checkout's root: exit 0 against the
       port's baseline, without importing torch.
   One line: 16a's median step and throughput, the card's name and
   power limit; then the phase's seconds.
17. The reference's convergence gate and the real CIFAR-10 pickles on
   the card (``gate_phase``, ``real_cifar_phase``):
   (a) The problem of ``tests/test_convergence.py`` (and its port,
       ``tests/test_torch_convergence.py``) free on the card from the
       port's seeded init: ResNet-20, batch 8 a rank on row `rank` of the
       fixed draw of ``np.random.default_rng(1)`` (X f32[4, 8, 32, 32,
       3], Y i32[4, 8]), 40 steps, lr 0.05, momentum 0.9, BatchNorm
       statistics and the loss averaged over the ranks. In this process
       at P = 1: dense, gTop-k ``twostage`` (the stage-1 kernel once a
       step) and ``pallas`` (the residual-mode multisection kernel once a
       step). At P = 4, inside phase 5's spawn of four ranks: dense,
       gTop-k ``auto``, ``allgather``, ``gtopk_hier`` with slices of 2,
       ``approx`` (stage-1, once a step) and ``pallas`` (abs mode, once a
       step). The reference's thresholds: dense's last loss below 0.35 x
       its first, every sparse arm's below 0.5 x its first and the gTop-k
       family's below dense's first; the launch counts exactly. One
       ``convergence`` JSON line an arm: the first, step-20 and last
       loss, last/first, the launches, the arm's seconds.
   (b) Two ResNet-20 ``twostage`` steps at batch 8 through the trainer on
       ``tests/fixtures/cifar`` (``--data-dir``): the first batch to reach
       the card bitwise the CPU loader's, finite losses, two stage-1
       launches.
   The phase's seconds (17a at P = 4 within phase 5's lap).
18. A ``kernels`` JSON line, then the last line
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
         61_100_840, 36_864, 2_359_296)
# The kernels run once a leaf under gtopk_layerwise: phase 2 holds them
# bitwise, untimed, at every distinct leaf size of these models.
LEAF_MODELS = ("resnet20", "resnet50")
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
    tile = (nb, groups, cuda_topk.BLOCK_ROWS // groups, cuda_topk.LANES)
    pad = (0, nb * cuda_topk.BLOCK - n)
    g_pad = torch.nn.functional.pad(g, pad)
    r_pad = torch.nn.functional.pad(r, pad)
    cases = {
        "multi_threshold_count": dict(
            run=lambda: cuda_topk.multi_threshold_count(mag, thr),
            ref=lambda: cuda_topk.multi_threshold_count_ref(mag, thr),
            lib=lambda: (mag[:, None] >= thr).sum(0),
            bytes=4 * n + 64, ops=8 * n),
        # Library: three calls that read g and r as K2 does -- add, abs,
        # then the bucket maxima and their rows (CUDA's own tie rule) --
        # over g and r padded to the tile beforehand; torch.topk is the
        # whole selection's yardstick, not this kernel's.
        "fused_stage1_candidates": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, None, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, None, r, groups=groups),
            lib=lambda: torch.max((g_pad + r_pad).abs().view(tile), dim=2),
            bytes=8 * n + 8 * L, ops=3 * n),
        "fused_stage1_candidates+counts": dict(
            run=lambda: cuda_topk.fused_stage1_candidates(
                g, thr, r, groups=groups),
            ref=lambda: cuda_topk.fused_stage1_candidates_ref(
                g, thr, r, groups=groups),
            lib=lambda: torch.max((g_pad + r_pad).abs().view(tile), dim=2),
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


def leaf_sizes() -> list:
    """Every distinct leaf size of the `LEAF_MODELS`, ascending."""
    from gtopkssgd_tpu_torch.select_probe import leaf_sizes as sizes

    return sizes(LEAF_MODELS)


def leaf_phase() -> None:
    """K2 and the multisection kernel (abs and residual mode) against
    their twins, bitwise and untimed, at every size of ``leaf_sizes``,
    with the k and groups the per-leaf selection gives them, on a leaf at
    an odd offset into its buffer (as a layout's leaf views are)."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk, topk

    for n in leaf_sizes():
        gen = torch.Generator(device="cuda").manual_seed(n)
        buf = torch.randn(2 * n + 1, device="cuda", generator=gen)
        g, r = buf[1:n + 1], 0.3 * buf[n + 1:]
        k = topk.k_for_density(n, 0.001)
        groups = topk._twostage_pallas_groups(n, k)
        pairs = (
            (cuda_topk.fused_stage1_candidates(g, None, r, groups=groups),
             cuda_topk.fused_stage1_candidates_ref(g, None, r,
                                                   groups=groups)),
            (cuda_topk.multisection_tau_lo(g, k, r),
             cuda_topk.multisection_tau_lo_ref(g, k, r)),
            (cuda_topk.multisection_tau_lo(g + r, k),
             cuda_topk.multisection_tau_lo_ref(g + r, k)))
        for name, (got, want) in zip(
                ("fused_stage1_candidates", "multisection_tau_lo[residual]",
                 "multisection_tau_lo[abs]"), pairs):
            for a, b in zip(got, want):
                if a is None or b is None:
                    check(a is None and b is None, f"{name} n={n}: outputs")
                    continue
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"{name} leaf n={n} k={k}: kernel != twin")
        print(f"kernel leaf n={n:>9,d} k={k} groups={groups}: stage-1, "
              "multisection abs and residual match=bitwise (not timed)")


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
    cases += multisection_nan_phase()
    return cases


def multisection_nan_phase() -> int:
    """The multisection kernel in both modes against its twin, bitwise
    (NaNs compared as bits), on ``stage1_design.nan_cases`` without
    infinities: the NaN rule (a NaN is never counted nor the maximum) on
    the card. Returns the number of cases."""
    from gtopkssgd_tpu_torch.ops import cuda_topk, topk
    from gtopkssgd_tpu_torch.stage1_design import nan_cases, same_bits

    cases = 0
    for label, g, r, _ in nan_cases("cuda", inf=False):
        k = topk.k_for_density(g.shape[0], 0.001)
        acc = g + r
        for mode, got, want in (
                ("residual", cuda_topk.multisection_tau_lo(g, k, r),
                 cuda_topk.multisection_tau_lo_ref(g, k, r)),
                ("abs", cuda_topk.multisection_tau_lo(acc, k),
                 cuda_topk.multisection_tau_lo_ref(acc, k))):
            for part, a, b in zip(("lo", "thresholds", "counts"), got, want):
                check(same_bits(a, b),
                      f"multisection_tau_lo[{mode}] {label}: {part} "
                      f"{a.flatten()[:8].tolist()} vs twin "
                      f"{b.flatten()[:8].tolist()}")
        print(f"kernel multisection_tau_lo edge {label}: match=bitwise, "
              f"abs and residual (lo {float(got[0]):.6g})")
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


def slice_sum_ref(xs):
    """The in-slice sum each of the len(xs) members ends with, by the
    association ``ici_dense_psum`` uses: extras folded into the largest
    power-of-two block, recursive doubling there, the sum sent back."""
    s = len(xs)
    m = 1 << (s.bit_length() - 1)
    x = [xs[j] + xs[j + m] if j < s - m else xs[j] for j in range(m)]
    r = 1
    while r < m:
        x = [x[j] + x[j ^ r] for j in range(m)]
        r <<= 1
    return x + [x[j - m] for j in range(m, s)]


def _set_list(sets):
    """A step's sets as a list, one a merge (a bucket)."""
    return sets if isinstance(sets, list) else [sets]


def dist_rank(device, method: str, compression: str, nworkers: int,
              steps: int, codec: str, dnn: str = "resnet20",
              extra: dict = None) -> dict:
    """One rank of a P > 1 run (spawned by ``dist_phase``): trains `steps`
    steps and checks, after each, that every rank holds the same global
    sets (the gtopk family; one a bucket) or dense union (the allgather
    modes), at step 1 that they equal the plain reference over the
    gathered local sets, and under gtopk_hier that the members of a slice
    hold the same slice sum (and the reference's) and residual; returns
    this rank's launch and wire counters, its checks and (rank 0) the
    plan's record."""
    import torch
    import torch.distributed as dist

    from gtopkssgd_tpu_torch.ops import cuda_topk, scatter_add_dense
    from gtopkssgd_tpu_torch.parallel import collectives
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    extra = extra or {}
    trainer = Trainer(TrainConfig(
        dnn=dnn, batch_size=32, compression=compression,
        density=0.001, topk_method=method, device=str(device),
        nworkers=nworkers, wire_codec=codec, **extra))
    opt, rank = trainer.optimizer, dist.get_rank()
    ici = opt.ici
    n = trainer.num_params
    sizes = opt.bucket_plan.sizes if opt.bucket_plan else [n]

    def gather(t):
        """Every rank's copy of t, on the CPU, in rank order."""
        out = [None] * nworkers
        dist.all_gather_object(out, t.detach().cpu())
        return out

    def wire_set(vals, idx):
        return torch.cat([vals.view(torch.int32), idx])

    def local_sets(local):
        k = local[0].shape[0]
        return k, [(x[:k].view(torch.float32), x[k:])
                   for x in gather(wire_set(*local))]

    def reference(local, n_b):
        """This rank's set by the plain reference of the run's schedule."""
        k, sets = local_sets(local)
        if opt.plan.schedule == "balanced":
            return collectives.balanced_ref(sets, k, n_b, codec=codec)[rank]
        if ici > 1:  # the tree runs over one member of each slice
            return collectives.merge_tree_ref(sets[::ici], k, n_b,
                                              codec=codec)[rank // ici]
        return collectives.merge_tree_ref(sets, k, n_b, codec=codec)[rank]

    cuda_topk.reset_launches()
    collectives.reset_wire()
    times, losses, agree, ref_ok, mass_ok = [], [], True, None, None
    slice_ok = None
    for step in range(steps):
        res_old = opt.state["residual"].clone()
        stats = trainer.train(1)
        times.append(stats["step_times"][0])
        losses.append(stats["loss"])
        if opt.last_global is not None:
            mine = _set_list(opt.last_global)
            for b, gset in enumerate(mine):
                sets = gather(wire_set(*gset))
                agree = agree and all(torch.equal(x, sets[0]) for x in sets)
            if step == 0:
                ref_ok = all(
                    torch.equal(wire_set(*reference(local, n_b)),
                                wire_set(*gset).cpu())
                    for local, gset, n_b in zip(
                        _set_list(opt.last_local), mine, sizes))
        elif opt.last_union is not None:
            unions = gather(opt.last_union.view(torch.int32))
            agree = agree and all(torch.equal(x, unions[0]) for x in unions)
            if step == 0:
                k, local = local_sets(opt.last_local)
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
    if ici > 1:  # after the counters: this exchange is the check's own
        summed = collectives.ici_dense_psum(opt.flat_grad, ici_size=ici)
        grads = gather(opt.flat_grad)
        want = slice_sum_ref(grads[rank - rank % ici:][:ici])[rank % ici]
        residuals = gather(opt.state["residual"])
        slice_ok = (torch.equal(summed.cpu(), want) and torch.equal(
            residuals[rank], residuals[rank - rank % ici]))
    flat = trainer.layout.ravel([p.detach() for p in trainer.layout.params])
    params = gather(flat)
    carry_distinct = None
    if trainer.carry is not None:  # each rank carries its own rows
        hs = gather(trainer.carry[-1][1])
        carry_distinct = all(not torch.equal(a, b) for i, a in enumerate(hs)
                             for b in hs[i + 1:])
    decision = trainer.plan_decision
    return dict(rank=rank, device=str(device), n=n,
                launches=launches, wire=wire, step_times=times,
                losses=losses, carry_distinct=carry_distinct,
                sets_agree=agree, ref_ok=ref_ok, mass_ok=mass_ok,
                slice_ok=slice_ok, units=len(opt._units()),
                merges=len(sizes),
                schedule=None if decision is None else decision.plan.schedule,
                record=(decision.record() if decision is not None
                        and rank == 0 else None),
                model_bytes=(None if decision is None else next(
                    c["wire_bytes"] for c in decision.candidates
                    if c["name"] == decision.plan.name)),
                params_agree=all(torch.equal(x, params[0]) for x in params))


def dist_ranks(device, runs, steps: int, dnn: str, gates=()) -> list:
    """``dist_rank`` for each (method, compression, P, codec, extras) of
    `runs`, then ``gate_arm`` for each arm of `gates`, one after the other
    in this rank's process."""
    return ([dist_rank(device, method, compression, p, steps, codec, dnn,
                       extra) for method, compression, p, codec, extra in runs]
            + [gate_arm(device, compression, method, extra, GATE_P)
               for _, compression, method, extra in gates])


def dist_phase(runs, dnn: str = "resnet20", steps: int = DIST_STEPS,
               gates=()) -> dict:
    """The P > 1 `runs` of `steps` steps of `dnn` (see the module
    docstring, phases 5, 6c, 7d and 9b-9d), each (method, compression, P,
    codec[, TrainConfig extras]); the runs of one P share one spawn of P
    ranks, and the convergence gate's arms `gates` (phase 17a) ride the
    spawn of ``GATE_P`` ranks. Returns the launches per kernel, summed
    over every rank of every run."""
    import torch

    from gtopkssgd_tpu_torch.parallel.dist import spawn

    cards = torch.cuda.device_count()
    total = {name: 0 for name in REPLACES}
    by_p = {}
    for method, compression, p, codec, *more in runs:
        by_p.setdefault(p, []).append(
            (method, compression, p, codec, more[0] if more else {}))
    check(not gates or GATE_P in by_p,
          f"the gate's arms need a spawn of {GATE_P} ranks")
    for p, group in by_p.items():
        backend = "nccl" if cards >= p else "gloo"
        arms = gates if p == GATE_P else ()
        t0 = time.perf_counter()
        results = spawn(dist_ranks, p, group, steps, dnn, arms,
                        backend=backend, device="cuda", timeout=600)
        print(f"dist {dnn} P={p}: {len(group) + len(arms)} run(s) in one "
              f"spawn of {p} ranks, spawn to join "
              f"{time.perf_counter() - t0:.1f} s")
        for i, run in enumerate(group):
            _dist_checks(run, [results[r][i] for r in range(p)], dnn,
                         steps, backend, min(cards, p), total)
        if arms:
            gate_checks(p, arms, [results[r][len(group):]
                                  for r in range(p)], total)
    return total


def _dist_checks(run_spec, ranks, dnn: str, steps: int, backend: str,
                 used: int, total: dict) -> None:
    """``dist_phase``'s checks and line for one run; adds its launches to
    `total`."""
    from gtopkssgd_tpu_torch.modes import ALLGATHER_MODES
    from gtopkssgd_tpu_torch.ops.topk import k_for_density
    from gtopkssgd_tpu_torch.parallel import comm_bytes_per_step, tree_rounds
    from gtopkssgd_tpu_torch.parallel.codec import get_codec
    from gtopkssgd_tpu_torch.parallel.collectives import (
        _tree_plan,
        ici_psum_sends,
    )

    method, compression, p, codec, extra = run_spec
    run = (f"{dnn} P={p} {compression}/{method}/{codec}"
           + "".join(f" {key}={v}" for key, v in extra.items()))
    n = ranks[0]["n"]
    k = k_for_density(n, 0.001)
    sparse = compression != "dense"
    units = ranks[0]["units"]
    want_launches = {
        "twostage": {"fused_stage1_candidates": steps * units},
        "pallas": {"multisection_tau_lo[abs]": steps * units},
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
        check(r["slice_ok"] is not False,
              f"{run}: the members of a slice differ in their slice "
              "sum or residual, or it is not the reference's")
        for name in REPLACES:
            total[name] += r["launches"][name]
    per_step = [r["wire"]["bytes"] / steps for r in ranks]
    rounds = [r["wire"]["rounds"] / steps for r in ranks]
    model = ranks[0]["model_bytes"]
    if model is None:
        model = comm_bytes_per_step(compression, n, k, p, codec=codec)
    # The in-slice sum counts what each rank ships; the model counts 4N.
    ici = extra.get("hier_ici", 1)
    want_bytes = [model + (ici_psum_sends(r % ici, ici) - 1) * 4 * n
                  if ici > 1 else model for r in range(p)]
    schedule = ranks[0]["schedule"]
    if sparse:
        what = ("dense unions" if compression in ALLGATHER_MODES
                else "global sets")
        check(all(r["sets_agree"] for r in ranks),
              f"{run}: {what} differ across ranks")
        check(all(r["ref_ok"] for r in ranks),
              f"{run}: step 1 differs from the CPU reference")
    if (p == 4 and compression in ("gtopk", "gtopk_layerwise")
            and "comm_plan" not in extra):
        check(schedule == "tree", f"{run}: 'auto' chose {schedule} at "
                                  "P = 4")
    if schedule == "balanced":
        want_rounds = p * ranks[0]["merges"]
        check(per_step == [model] * p,
              f"{run}: {per_step} bytes a step, model {model}")
    elif compression in ALLGATHER_MODES:
        want_rounds = 1
    elif sparse:
        want_rounds = tree_rounds(p // ici) * ranks[0]["merges"]
    else:
        want_rounds = 0
    check(rounds == [want_rounds] * p,
          f"{run}: {rounds} rounds a step, model {want_rounds}")
    if compression == "gtopk" and schedule == "tree":
        set_bytes = get_codec(codec).wire_set_bytes(k, n)
        sends = sum(len(pairs) for pairs in _tree_plan(p))
        check(sum(per_step) == sends * set_bytes,
              f"{run}: {per_step} bytes a step, {sends} sets of "
              f"{set_bytes} bytes expected in all")
    if compression == "topk":
        check(all(r["mass_ok"] for r in ranks),
              f"{run}: residual + shipped picks != accumulator")
    if (p // ici) & (p // ici - 1) == 0:
        check(per_step == want_bytes,
              f"{run}: {per_step} bytes a step, want {want_bytes} "
              f"(model {model})")
    med = statistics.median(
        t for r in ranks for t in r["step_times"][1:])
    if ranks[0]["record"] is not None:
        print(f"plan {run}: " + json.dumps(ranks[0]["record"]))
    print(f"dist {run}: backend {backend}, {used} card(s) for {p} "
          f"ranks, {steps} steps, loss "
          f"{ranks[0]['losses'][0]:.4f} -> {ranks[0]['losses'][-1]:.4f}, "
          f"median step {med * 1e3:.3f} ms (steps 2-{steps}, all "
          f"ranks), {32 * p / med:.1f} samples/s in all, "
          f"bytes sent a step per rank {per_step} (model {model}"
          + (f"; with the in-slice sends {want_bytes}" if ici > 1 else "")
          + "), "
          f"rounds {rounds[0]}, schedule {schedule}, launches "
          f"per rank {ranks[0]['launches']}, final params bitwise "
          f"equal across ranks"
          + (f", {what} bitwise equal across ranks and at step 1 to "
             "the CPU reference" if sparse else "")
          + (", slice sums and residuals bitwise equal in each slice "
             "and to the reference sum" if ici > 1 else "")
          + (", nothing folded" if compression == "topk" else "")
          + (", each rank's carry distinct"
             if ranks[0]["carry_distinct"] else ""))


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
    """Phases 7e, 8d and 9a: for each (dnn, method[, compression]) of
    `cases`, one step on the card and on the CPU from the same seed (the
    same weights and batches), dropout off; then a second step on the
    card, its selection held bitwise to the CPU twins' on the card's own
    (clipped) gradient and residual, unit by unit (the whole vector, or
    each leaf under gtopk_layerwise)."""
    import torch

    from gtopkssgd_tpu_torch.compression import TopKCompressor
    from gtopkssgd_tpu_torch.models import Dropout
    from gtopkssgd_tpu_torch.optimizer import clip_by_global_norm
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    for dnn, method, *mode in cases:
        compression = mode[0] if mode else "gtopk"
        cfg = dict(dnn=dnn, batch_size=2, compression=compression,
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
        run = f"reference {dnn} {compression} {method}"
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
        comp = TopKCompressor(0.001, method)
        picks = [comp.compress_by_threshold(
            grad[o:o + size] + res_in[o:o + size], grad=grad[o:o + size],
            residual=res_in[o:o + size]) for o, size in opt._units()]
        keep = torch.cat([kept for kept, _, _ in picks])
        res = torch.cat([r for _, r, _ in picks])
        same = (torch.equal(keep, opt.last_keep.cpu())
                and torch.equal(res, opt.state["residual"].cpu()))
        print(f"{run}: step-1 loss card {lg:.6f} cpu {lc:.6f}, "
              f"keep {int(kg.sum())} vs {int(kc.sum())} of {nonzero:,} "
              f"nonzero, jaccard {jac:.5f}; step-2 selection on the card's "
              f"gradient (N = {card.num_params}): "
              f"{'bitwise' if same else 'DIFFERENT'} "
              f"({int(keep.sum())} kept)")
        check(same, f"{run}: card selection != cpu twins")


# Phase 9 (gtopk_layerwise, gtopk_hier, the balanced schedule).
LAYERWISE_RUNS = (("twostage", 10), ("pallas", 10))
LAYERWISE_REFERENCE = (("resnet50", "twostage", "gtopk_layerwise"),
                       ("resnet50", "pallas", "gtopk_layerwise"))
LAYERWISE_DIST = ("resnet50",
                  (("twostage", "gtopk_layerwise", 4, "fp32"),
                   ("twostage", "gtopk_layerwise", 4, "fp32",
                    {"buckets": "4"})), 5)
HIER_DIST = ("resnet20",
             (("twostage", "gtopk_hier", 4, "fp32", {"hier_ici": 2}),
              ("twostage", "gtopk_hier", 4, "int8", {"hier_ici": 2}),
              ("twostage", "gtopk_hier", 6, "fp32", {"hier_ici": 3})), 10)
BALANCED_DIST = ("resnet20",
                 tuple(("pallas", "gtopk", p, codec,
                        {"comm_plan": "balanced"})
                       for p in (4, 3) for codec in ("fp32", "fp8:32")), 10)
# Every ResNet-20 P > 1 run of DIST_STEPS steps (phases 5, 6c, 9c, 9d):
# one dist_phase call, so the runs of one P share one spawn.
RESNET20_DIST = DIST_RUNS + CODEC_RUNS + HIER_DIST[1] + BALANCED_DIST[1]
assert HIER_DIST[2] == BALANCED_DIST[2] == DIST_STEPS


def layerwise_phase() -> dict:
    """Phase 9a: ResNet-50 ``gtopk_layerwise`` (concat) at P = 1, 10 steps
    ``twostage`` and 10 ``pallas``: one stage-1 launch, or one
    residual-mode multisection launch, a leaf a step; returns the
    launches."""
    total = {name: 0 for name in REPLACES}
    want = {"twostage": "fused_stage1_candidates",
            "pallas": "multisection_tau_lo[residual]"}
    for method, steps in LAYERWISE_RUNS:
        launches, trainer = train_run(method, "gtopk_layerwise", steps,
                                      "resnet50")
        leaves = len(trainer.layout.sizes)
        check(leaves == 161, f"resnet50 has {leaves} leaves, not 161")
        check_launches(launches, {want[method]: steps * leaves},
                       f"resnet50 P=1 gtopk_layerwise/{method}, {steps} "
                       "steps")
        for name in REPLACES:
            total[name] += launches[name]
        del trainer
    return total


def planner_phase() -> None:
    """Phase 9e: the planner's decisions with each committed fit (gloo on
    one card; NCCL across two cards), the one a run over that backend
    reads, at the zoo's N for P in 2..8; at P = 4 'auto' must keep the
    tree for gtopk and gtopk_layerwise. Prints each decision's scores."""
    from gtopkssgd_tpu_torch.ops.topk import k_for_density
    from gtopkssgd_tpu_torch.parallel import comm_model
    from gtopkssgd_tpu_torch.parallel.planner import build_decision

    for fit, n in ((f, n) for f in comm_model.COMMITTED_FITS.values()
                   for n in (272_474, 25_557_032)):
        k = k_for_density(n, 0.001)
        for mode in ("gtopk", "gtopk_layerwise"):
            for p in (2, 3, 4, 5, 6, 8):
                d = build_decision(mode, p=p, n=n, k=k, fit_path=fit)
                scores = {c["name"]: c["comm_ms"] for c in d.candidates}
                print(f"plan auto {mode} P={p} N={n}: {d.plan.name} "
                      f"(comm_ms {scores}, fit {d.inputs['fit_source']} "
                      f"alpha_ms {d.inputs['alpha_ms']} beta_gbps "
                      f"{d.inputs['beta_gbps']})")
                if p == 4:
                    check(d.plan.name == "tree",
                          f"{mode} P=4 N={n}: 'auto' chose {d.plan.name}")


# Phase 10 (the pipelines, the selection cost, the harness).
PIPELINE_DIST = ("resnet50", ("twostage", "pallas"), 4, 5)  # dnn, methods,
# P, steps of the lockstep run (``--buckets 4``, one card over gloo)
PIPELINE_MODEL_BYTES = 408_928  # a rank a step at P = 4 (phase 9b)
HARNESS_P1 = (("gtopk", "twostage"), (None, "exact"))  # ResNet-50, P = 1


def select_phase() -> None:
    """Phase 10a: the selection stage at ResNet-50's ``--buckets 4``
    sizes, each method once with host syncs made errors, each time beside
    the committed fit's prediction for this card."""
    import torch

    from gtopkssgd_tpu_torch import select_probe
    from gtopkssgd_tpu_torch.parallel.bucketing import load_select_gamma

    name = torch.cuda.get_device_name(0)
    sizes = select_probe.bucket_sizes()
    for method in select_probe.METHODS:
        gamma = load_select_gamma(name, method)
        select_probe.check_no_host_sync(method, max(sizes))
        for n in sizes:
            ms = select_probe.stage_ms(method, n)
            print(f"select {method} n={n:,d}: {ms:.4f} ms, the committed "
                  f"fit predicts {gamma * n / 1e6:.4f} ms (gamma "
                  f"{gamma:.5f}); no host sync")


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1) for t in tensors])


def pipeline_rank(device, dnn: str, methods, p: int, steps: int) -> dict:
    """One rank of phase 10b and the P > 1 arm of 10d: per method, two
    optimizers over one model, 'serial' and 'overlap', stepped from the
    same state each step (parameters and gradients restored between
    them); their updates, parameters, velocities, residuals and
    per-bucket global sets compared bitwise, bytes a step per order, the
    launch counts, both orders' optimizer-step times, and the overlap
    share of a profiled step of each. Then the harness under both orders
    (rank 0's records; its ``sec_per_step`` is each order's measured
    whole step)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gtopkssgd_tpu_torch import benchmark, profile_step
    from gtopkssgd_tpu_torch.obs import trace_attr
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.parallel import collectives
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    rank = dist.get_rank()
    out = {"rank": rank, "methods": {}}
    for method in methods:
        cfg = TrainConfig(dnn=dnn, batch_size=32, density=0.001,
                          compression="gtopk_layerwise", buckets="4",
                          pipeline="serial", topk_method=method,
                          nworkers=p, device=str(device))
        trainer = Trainer(cfg)
        trainer.cfg = dataclasses.replace(trainer.cfg, pipeline="overlap")
        opts = {"serial": trainer.optimizer,
                "overlap": trainer.make_optimizer()}
        # The orders are compared on one partition: the serial DP's (the
        # DP priced under 'overlap' may cut elsewhere).
        splan, oplan = (opts[o].bucket_plan for o in ("serial", "overlap"))
        check(oplan.pipeline == "overlap", f"{method}: {oplan}")
        opts["overlap"].bucket_plan = dataclasses.replace(
            splan, pipeline="overlap")
        out.setdefault("cuts", {})[method] = (splan.boundaries,
                                              oplan.boundaries)
        params = trainer.layout.params
        res = {"equal": True, "bytes": {"serial": [], "overlap": []},
               "opt_ms": {"serial": [], "overlap": []}}

        def step(order: str, before, grads):
            for q, b, g in zip(params, before, grads):
                q.data.copy_(b)
                q.grad = g.clone()
            collectives.reset_wire()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opts[order].step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res["opt_ms"][order].append(ms)
            res["bytes"][order].append(collectives.wire["bytes"])
            o = opts[order]
            return {"update": _flat(q.grad for q in params),
                    "params": _flat(params),
                    "velocity": _flat(o.state[q]["momentum_buffer"]
                                      for q in params),
                    "residual": o.state["residual"].clone(),
                    "sets": [torch.cat([v.view(torch.int32), i])
                             for v, i in o.last_global]}

        cuda_topk.reset_launches()
        for _ in range(steps):
            trainer.optimizer.zero_grad(set_to_none=True)
            batch = trainer._device_batch(trainer._next_host())
            loss, _, _ = trainer._forward(batch)
            loss.backward()
            before = [q.detach().clone() for q in params]
            grads = [q.grad.detach().clone() for q in params]
            a = step("serial", before, grads)
            b = step("overlap", before, grads)
            same = all(torch.equal(a[key], b[key]) for key in
                       ("update", "params", "velocity", "residual"))
            same = same and len(a["sets"]) == len(b["sets"]) and all(
                torch.equal(x, y) for x, y in zip(a["sets"], b["sets"]))
            res["equal"] = res["equal"] and same
        res["launches"] = dict(cuda_topk.launches)
        res["buckets"] = opts["serial"].bucket_plan.n_buckets
        res["share"] = {}
        for order in ("serial", "overlap"):
            trainer.optimizer = opts[order]
            with trace_attr.profiler() as prof:
                stats = trainer.train(1)
            res["share"][order] = profile_step.summarize(
                prof, stats, 1)["overlap_share"]
        for o in opts.values():
            o.close()
        out["methods"][method] = res
        del trainer, opts
        torch.cuda.empty_cache()
    records = {}
    for order in ("serial", "overlap"):
        bcfg = benchmark.BenchConfig(
            dnn=dnn, batch_size=32, steps=5, min_seconds=1.0,
            topk_method="twostage", nworkers=p, buckets="4",
            pipeline=order, dtype="float32")
        records[order] = {
            "throughput": benchmark._throughput(device, bcfg,
                                                "gtopk_layerwise", 0.001),
            "breakdown": benchmark._breakdown(device, bcfg,
                                              "gtopk_layerwise", 0.001)}
        torch.cuda.empty_cache()
    out["harness"] = records if rank == 0 else None
    return out


def pipeline_phase() -> dict:
    """Phase 10b (and 10d's P = 4 arm): ``pipeline_rank`` on P ranks in
    one spawn; checks and prints; returns the launches."""
    import torch

    from gtopkssgd_tpu_torch.benchmark import attr_from_breakdown
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    dnn, methods, p, steps = PIPELINE_DIST
    backend = "nccl" if torch.cuda.device_count() >= p else "gloo"
    t0 = time.perf_counter()
    ranks = spawn(pipeline_rank, p, dnn, methods, p, steps, backend=backend,
                  device="cuda", timeout=900)
    print(f"pipeline {dnn} P={p}: one spawn, backend {backend}, spawn to "
          f"join {time.perf_counter() - t0:.1f} s")
    total = {name: 0 for name in REPLACES}
    want = {"twostage": "fused_stage1_candidates",
            "pallas": "multisection_tau_lo[abs]"}
    for method in methods:
        run = f"{dnn} P={p} gtopk_layerwise/{method} --buckets 4"
        rs = [r["methods"][method] for r in ranks]
        for r, res in zip(ranks, rs):
            check(res["equal"], f"{run} rank {r['rank']}: 'overlap' differs "
                                "from 'serial' (updates, parameters, "
                                "velocities, residuals or global sets)")
            check_launches(res["launches"],
                           {want[method]: 2 * steps * res["buckets"]},
                           f"{run} rank {r['rank']}, both orders")
            for order in ("serial", "overlap"):
                check(res["bytes"][order] == [PIPELINE_MODEL_BYTES] * steps,
                      f"{run} rank {r['rank']} {order}: bytes a step "
                      f"{res['bytes'][order]}, model "
                      f"{PIPELINE_MODEL_BYTES}")
            for name in REPLACES:
                total[name] += res["launches"][name]
        shares = [res["share"] for res in rs]
        check(shares[0]["overlap"] is not None and shares[0]["overlap"] > 0,
              f"{run}: overlap share {shares[0]['overlap']} on rank 0, "
              "expected above 0")
        med = {order: statistics.median(
            t for res in rs for t in res["opt_ms"][order][1:])
            for order in ("serial", "overlap")}
        cuts = ranks[0]["cuts"][method]
        print(f"pipeline {run}: cuts {cuts[0]} (the DP priced under "
              f"'overlap' cuts at {cuts[1]})")
        print(f"pipeline {run}: {steps} steps of each order from the same "
              "state, updates, parameters, velocities, residuals and "
              "per-bucket global sets bitwise equal between the orders on "
              f"every rank; bytes a rank a step {PIPELINE_MODEL_BYTES} "
              f"(= model) in both; launches per rank {rs[0]['launches']}; "
              + "; ".join(
                  f"{order}: median optimizer step {med[order]:.3f} ms "
                  f"(steps 2-{steps}, all ranks), overlap share by rank "
                  + ", ".join(f"{s[order]:.4f}" if s[order] is not None
                              else "none" for s in shares)
                  for order in ("serial", "overlap")))
    for order, rec in ranks[0]["harness"].items():
        print(f"harness {dnn} P={p} gtopk_layerwise --buckets 4 "
              f"--pipeline {order}: " + json.dumps({
                  **rec, "attr": attr_from_breakdown(rec["breakdown"])}))
    return total


def auto_phase() -> None:
    """Phase 10c: ``--buckets auto --pipeline auto`` for ResNet-20 and
    ResNet-50 at P = 2..8 under each committed comm fit and this card's
    selection fit (``twostage``): the order, B, and both spans."""
    import torch

    from gtopkssgd_tpu_torch.parallel import bucketing, comm_model
    from gtopkssgd_tpu_torch.select_probe import layout_sizes

    gamma = bucketing.load_select_gamma(torch.cuda.get_device_name(0),
                                        "twostage")
    for dnn in ("resnet20", "resnet50"):
        sizes = layout_sizes(dnn)
        for backend, fit in comm_model.COMMITTED_FITS.items():
            for p in (2, 3, 4, 5, 6, 8):
                plan = bucketing.plan_buckets(
                    sizes, 0.001, buckets="auto", p=p, fit_path=fit,
                    pipeline="auto", select_gamma=gamma)
                inputs = comm_model.load_fit(fit)
                spans = {o: bucketing.pipeline_span_ms(
                    plan, p=p, alpha_ms=inputs["alpha_ms"],
                    beta_gbps=inputs["beta_gbps"], select_gamma=gamma,
                    pipeline=o) for o in ("serial", "overlap")}
                print(f"auto {dnn} P={p} {backend} fit: --pipeline "
                      f"{plan.pipeline}, B={plan.n_buckets}, span serial "
                      f"{spans['serial']:.4f} ms, overlap "
                      f"{spans['overlap']:.4f} ms (twostage gamma "
                      f"{gamma:.5f})")


def harness_phase() -> None:
    """Phase 10d, P = 1: ``measure_throughput`` and ``measure_breakdown``
    of ResNet-50 gTop-k ``twostage`` and dense, batch 32."""
    from gtopkssgd_tpu_torch import benchmark

    for mode, method in HARNESS_P1:
        cfg = benchmark.BenchConfig(dnn="resnet50", batch_size=32, steps=5,
                                    min_seconds=1.0, topk_method=method,
                                    dtype="float32")
        density = 0.001 if mode else 1.0
        tput = benchmark.measure_throughput(cfg, mode, density)
        bd = benchmark.measure_breakdown(cfg, mode, density)
        for key in ("sec_per_step", "flops_per_step", "mfu"):
            check(tput[key] is not None and tput[key] > 0,
                  f"harness {mode}: {key} {tput[key]}")
        print(f"harness resnet50 P=1 {mode or 'dense'}/{method}: "
              + json.dumps({"throughput": tput, "breakdown": bd,
                            "attr": benchmark.attr_from_breakdown(bd)}))



# Phase 11: the trainer's lifecycle and host path.
LIFECYCLE = dict(dnn="resnet20", batch_size=32, compression="gtopk",
                 density=0.001, topk_method="twostage", eval_batches=1)
RESUME_STEPS, RESUME_SPLIT = 6, 3
BF16_RUNS = (("resnet50", 10), ("lstm", 10))
DISPATCH_K, DISPATCH_STEPS = 8, 16
# (dnn, method): timed on the default algorithms; held bitwise to the
# eager path under deterministic ones (VGG-16 for its dropout masks).
DISPATCH_TIMED = (("resnet20", "twostage"), ("resnet20", "pallas"),
                  ("resnet50", "twostage"))
DISPATCH_BITWISE = DISPATCH_TIMED + (("vgg16", "twostage"),)


def deterministic(on: bool) -> None:
    """``torch.use_deterministic_algorithms`` (warning, not raising, where
    an op has no deterministic form: ``index_add_`` at unique indices,
    the merge's and the repair's, adds one value a slot) and cuDNN's
    deterministic convolutions, for the bitwise checks of phase 11."""
    import torch

    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on


def native_phase() -> None:
    """Phase 11a: the native data prep builds from the checkout's source;
    a drawn CIFAR batch's augmentation is the numpy path's, bitwise, and
    an AN4 greedy decode's counts with the library's edit distance are
    the Python one's."""
    import numpy as np

    from gtopkssgd_tpu_torch import ctc, native
    from gtopkssgd_tpu_torch.data import get_dataset

    t0 = time.perf_counter()
    so = native.build()
    check(native.available(), "native data prep: the library did not load")
    rng = np.random.default_rng(0)
    images = get_dataset("cifar10", split="train", batch_size=32,
                         seed=42).images[:32]
    ys = rng.integers(0, 9, 32).astype(np.int32)
    xs = rng.integers(0, 9, 32).astype(np.int32)
    flips = rng.random(32) < 0.5
    same = np.array_equal(native.cifar_augment_batch(images, ys, xs, flips),
                          native.augment_numpy(images, ys, xs, flips))
    check(same, "native augmentation != numpy")
    batch = next(get_dataset("an4", split="test", batch_size=32,
                             seed=42).epoch(0))
    t_out = 200
    logits = rng.standard_normal((32, t_out, 29)).astype(np.float32)
    lengths = np.minimum(batch["input_lengths"] // 4 + 1, t_out)
    want = []
    real = ctc.edit_distance
    for fn in (real, native.edit_distance_py):
        ctc.edit_distance = fn
        try:
            want.append(ctc.greedy_error_counts(
                logits, lengths, batch["labels"], batch["label_lengths"]))
        finally:
            ctc.edit_distance = real
    check(np.array_equal(*want), f"native edit distance {want}")
    print(f"native: {so.name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s; augmentation bitwise numpy "
          f"(batch 32); AN4 decode counts {want[0].tolist()} equal the "
          "Python edit distance's")


def resume_rank(device, cfg: dict, out_dir: str) -> dict:
    """Phase 11b on one rank: RESUME_STEPS steps straight, then the same
    run split at RESUME_SPLIT (save, a new trainer with ``resume=True``);
    both final states on the CPU and the first metrics record."""
    import torch

    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    deterministic(True)
    try:
        cfg = dict(cfg, device=str(device))
        with Trainer(TrainConfig(**cfg)) as full:
            full.train(RESUME_STEPS)
            want = {k: v.cpu() for k, v in full.checkpoint_state().items()}
        with Trainer(TrainConfig(out_dir=out_dir, **cfg)) as first:
            first.train(RESUME_SPLIT)
            first.save()
        with Trainer(TrainConfig(out_dir=out_dir, resume=True,
                                 **cfg)) as again:
            check(again.step == RESUME_SPLIT, f"restored {again.step}")
            again.train(RESUME_STEPS - RESUME_SPLIT)
            got = {k: v.cpu() for k, v in again.checkpoint_state().items()}
            rank = again.rank
    finally:
        deterministic(False)
    diff = {k: float((got[k].double() - v.double()).abs().max())
            for k, v in want.items() if v.is_floating_point()}
    keep = [x["residual"] == 0 for x in (want, got)]
    jac = float((keep[0] & keep[1]).sum()) / max(1, float(
        (keep[0] | keep[1]).sum()))
    name = ("metrics.jsonl" if cfg.get("nworkers", 1) == 1
            else f"metrics.rank{rank}.jsonl")
    with open(f"{out_dir}/{name}") as fh:
        manifest = json.loads(fh.readline())
    return dict(rank=rank, bitwise=all(torch.equal(v, got[k])
                                       for k, v in want.items()),
                max_diff=max(diff.values()), jaccard=jac,
                manifest=manifest)


def resume_phase() -> None:
    """Phase 11b: resume against an uninterrupted run, ResNet-20 gTop-k
    ``twostage``, at P = 1 and at P = 2 on one card over gloo."""
    import tempfile

    from gtopkssgd_tpu_torch.parallel.dist import spawn

    for p in (1, 2):
        cfg = dict(LIFECYCLE, nworkers=p)
        with tempfile.TemporaryDirectory(dir=".") as tmp:
            t0 = time.perf_counter()
            ranks = ([resume_rank("cuda", cfg, tmp)] if p == 1 else
                     spawn(resume_rank, p, cfg, tmp, backend="gloo",
                           device="cuda", timeout=600))
        hashes = {r["manifest"]["config_hash"] for r in ranks}
        for r in ranks:
            check(r["bitwise"], f"resume P={p} rank {r['rank']}: state != "
                  f"uninterrupted (max diff {r['max_diff']}, jaccard "
                  f"{r['jaccard']})")
            check(r["manifest"]["kind"] == "manifest"
                  and r["manifest"]["world_size"] == p,
                  f"resume P={p}: first record {r['manifest']}")
        check(len(hashes) == 1, f"resume P={p}: config hashes {hashes}")
        m = ranks[0]["manifest"]
        print(f"resume P={p}: {RESUME_SPLIT} + save + resume + "
              f"{RESUME_STEPS - RESUME_SPLIT} steps == {RESUME_STEPS} "
              f"straight, bitwise on every rank (deterministic algorithms); "
              f"manifest config_hash {hashes.pop()} on {len(ranks)} rank(s), "
              f"backend {m['backend']}, card {m['device_name']} "
              f"{m['power_limit']}, native_dataprep {m['native_dataprep']}; "
              f"{time.perf_counter() - t0:.1f} s")


def bf16_phase() -> dict:
    """Phase 11c: ResNet-50 and the PTB LSTM gTop-k ``twostage`` in
    bfloat16 and float32, 10 steps each: step ms and loss; the stage-1
    kernel's input is float32; cuDNN's bfloat16 LSTM kernels; then the
    harness's bfloat16 MFU for ResNet-50 at P = 1. Returns the launches."""
    import torch

    from gtopkssgd_tpu_torch import benchmark
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    total = {name: 0 for name in REPLACES}
    seen = []
    real = cuda_topk.fused_stage1_candidates

    def spy(grad, *args, **kw):
        seen.append((grad.dtype, None if kw.get("residual") is None
                     else kw["residual"].dtype))
        return real(grad, *args, **kw)

    cuda_topk.fused_stage1_candidates = spy
    try:
        for dnn, steps in BF16_RUNS:
            med = {}
            for dtype in ("float32", "bfloat16"):
                with Trainer(TrainConfig(
                        dnn=dnn, batch_size=32, compression="gtopk",
                        density=0.001, topk_method="twostage",
                        eval_batches=1, dtype=dtype, device="cuda")) as t:
                    seen.clear()
                    cuda_topk.reset_launches()
                    stats = t.train(steps)
                    launches = dict(cuda_topk.launches)
                    check_launches(launches,
                                   {"fused_stage1_candidates": steps},
                                   f"{dnn} {dtype}")
                    for name in REPLACES:
                        total[name] += launches[name]
                    check(seen == [(torch.float32, torch.float32)] * steps,
                          f"{dnn} {dtype}: stage-1 inputs {set(seen)}")
                    check(all(math.isfinite(v) for v in stats["losses"]),
                          f"{dnn} {dtype}: losses {stats['losses']}")
                    med[dtype] = statistics.median(stats["step_times"][1:])
                    print(f"bf16 {dnn} {dtype}: {steps} steps, loss "
                          f"{stats['losses'][0]:.4f} -> "
                          f"{stats['losses'][-1]:.4f}, median step "
                          f"{med[dtype] * 1e3:.3f} ms, stage-1 inputs "
                          "float32")
                    if dnn == "lstm" and dtype == "bfloat16":
                        with torch.profiler.profile(activities=[
                                torch.profiler.ProfilerActivity.CUDA]) as pr:
                            t.train(1)
                        rnn = sorted({e.name for e in pr.events()
                                      if "rnn" in e.name.lower()
                                      or "lstm" in e.name.lower()})
                        print(f"bf16 lstm: the step's RNN kernels "
                              f"{rnn[:6]} ({len(rnn)} distinct)")
            print(f"bf16 {dnn}: step {med['bfloat16'] * 1e3:.3f} ms against "
                  f"float32 {med['float32'] * 1e3:.3f} ms "
                  f"({med['float32'] / med['bfloat16']:.2f}x)")
    finally:
        cuda_topk.fused_stage1_candidates = real
    for dtype in ("bfloat16", "float32"):
        cfg = benchmark.BenchConfig(dnn="resnet50", batch_size=32, steps=5,
                                    min_seconds=1.0, topk_method="twostage",
                                    dtype=dtype)
        tput = benchmark.measure_throughput(cfg, "gtopk", 0.001)
        bd = benchmark.measure_breakdown(cfg, "gtopk", 0.001)
        check(tput["mfu"] is not None and tput["mfu"] > 0,
              f"harness {dtype}: mfu {tput['mfu']}")
        print(f"harness resnet50 P=1 gtopk/twostage {dtype}: " + json.dumps(
            {**{key: tput[key] for key in (
                "sec_per_step", "flops_per_step", "achieved_tflops_per_chip",
                "mfu")}, **{key: bd[key] for key in (
                    "forward_backward", "compress", "apply")}}))
    return total


def dispatch_phase() -> dict:
    """Phase 11d: ``steps_per_dispatch`` DISPATCH_K against 1 at P = 1:
    host-clock ms a step for each K (DISPATCH_TIMED, 4 dispatches, the
    first left out); then, under deterministic algorithms, DISPATCH_STEPS
    steps of each of DISPATCH_BITWISE from the same seed: the graph
    replays, and the per-step losses and the whole state are bitwise the
    eager path's; each selection kernel's launches are the captured ones
    times the replays plus the eager ones. Returns the launches (a
    capture counted once for each replay, not for itself)."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    want_kernel = {"twostage": "fused_stage1_candidates",
                   "pallas": "multisection_tau_lo[residual]"}
    total = {name: 0 for name in REPLACES}
    for dnn, method in DISPATCH_TIMED:
        ms = {}
        for k in (1, DISPATCH_K):
            cfg = dict(LIFECYCLE, dnn=dnn, topk_method=method,
                       steps_per_dispatch=k, device="cuda")
            with Trainer(TrainConfig(**cfg)) as t:
                times = t.train(4 * DISPATCH_K)["step_times"]
                ms[k] = statistics.median(times[k:]) * 1e3
        print(f"dispatch {dnn} {method}: host-clock {ms[1]:.3f} ms a step "
              f"at K=1, {ms[DISPATCH_K]:.3f} ms at K={DISPATCH_K} "
              f"({ms[1] / ms[DISPATCH_K]:.2f}x), {4 * DISPATCH_K} steps, "
              "default algorithms")
    deterministic(True)
    try:
        for dnn, method in DISPATCH_BITWISE:
            out = {}
            for k in (1, DISPATCH_K):
                cfg = dict(LIFECYCLE, dnn=dnn, topk_method=method,
                           steps_per_dispatch=k, device="cuda")
                with Trainer(TrainConfig(**cfg)) as t:
                    cuda_topk.reset_launches()
                    stats = t.train(DISPATCH_STEPS)
                    counted = dict(cuda_topk.launches)
                    g = t.graph_stats
                    launches = {name: counted[name]
                                - g["captured"].get(name, 0)
                                + g["replayed"].get(name, 0)
                                for name in counted}
                    times = stats["step_times"]
                    out[k] = dict(
                        losses=stats["losses"], dispatch=stats["dispatch"],
                        state={n: v.cpu() for n, v in
                               t.checkpoint_state().items()},
                        launches=launches, graph=dict(g),
                        ms=statistics.median(times[k:]) * 1e3)
            eager, graph = out[1], out[DISPATCH_K]
            run = f"dispatch {dnn} {method} K={DISPATCH_K}"
            check(graph["dispatch"] == "graph", f"{run}: {graph['dispatch']}")
            same = graph["losses"] == eager["losses"] and all(
                torch.equal(v, graph["state"][n])
                for n, v in eager["state"].items())
            diff = max(float((graph["state"][n].double()
                              - v.double()).abs().max())
                       for n, v in eager["state"].items()
                       if v.is_floating_point())
            kernel = want_kernel[method]
            g = graph["graph"]
            print(f"{run}: {g['captures']} capture(s), {g['replays']} "
                  f"replays, captured launches {g['captured']}; "
                  f"{DISPATCH_STEPS} steps {'bitwise' if same else 'DIFFERENT'}"
                  f" vs eager (max state diff {diff:.3g}); deterministic "
                  f"algorithms: {eager['ms']:.3f} ms a step at K=1, "
                  f"{graph['ms']:.3f} ms at K={DISPATCH_K}")
            check(same, f"{run}: graph != eager (max diff {diff})")
            for res in (eager, graph):
                check_launches(res["launches"], {kernel: DISPATCH_STEPS},
                               f"{run}")
                for name in REPLACES:
                    total[name] += res["launches"][name]
    finally:
        deterministic(False)
    return total


# Phase 12: the JPEG path, the remaining top-k methods, resilience.
JPEG_CLASSES, JPEG_TRAIN, JPEG_VAL = 4, 48, 16
JPEG_SIZE, JPEG_QUALITY, JPEG_STEPS = (500, 375), 90, 4
TOPK_METHODS = ("exact", "blockwise", "approx", "simrecall", "twostage",
                "pallas")
SMOKE_BASE = ["--dnn", "resnet20", "--batch-size", "32", "--compression",
              "gtopk", "--density", "0.001", "--eval-batches", "1",
              "--seed", "42", "--prefetch", "0"]
LAUNCHES_TAG = "SMOKE_LAUNCHES "


def write_jpegs(root: str) -> None:
    """A seeded ImageFolder: JPEG_CLASSES classes of JPEG_TRAIN train and
    JPEG_VAL val images, 500x375 at quality 90 (smooth noise, upsampled,
    so the files have a photograph's size)."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(12)
    for split, count in (("train", JPEG_TRAIN), ("val", JPEG_VAL)):
        for c in range(JPEG_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(count):
                small = rng.integers(0, 256, (47, 63, 3), dtype=np.uint8)
                Image.fromarray(small).resize(JPEG_SIZE).save(
                    os.path.join(d, f"img_{i}.JPEG"), quality=JPEG_QUALITY)


def jpeg_worker(data_dir: str, workers: int) -> int:
    """Phase 12a in a fresh process (the decode pool forks before the
    process touches the card): ResNet-50 ``twostage`` on the JPEGs, batch
    32, ``JPEG_STEPS`` steps at `workers` decode processes, prefetch off so
    the decode is on the step's path. Prints one JSON line: decode
    images/s, host "data" ms and step ms a step, a digest of the batches,
    the launches."""
    import hashlib

    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    cfg = TrainConfig(dnn="resnet50", batch_size=32, compression="gtopk",
                      density=0.001, topk_method="twostage",
                      data_dir=data_dir, decode_workers=workers, prefetch=0,
                      eval_batches=1, device="cuda")
    with Trainer(cfg) as t:
        t0 = time.perf_counter()
        batches = list(t.train_data.epoch(0, range(JPEG_STEPS)))
        decode_s = time.perf_counter() - t0
        h = hashlib.sha256()
        for b in batches:
            h.update(b["image"].tobytes())
            h.update(b["label"].tobytes())
        cuda_topk.reset_launches()
        data_ms, step_ms, losses = [], [], []
        for _ in range(JPEG_STEPS):
            t0 = time.perf_counter()
            staged = t._stage(1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = t._train_step(staged[0])[0]
            t.step += 1
            losses.append(float(loss))
            t2 = time.perf_counter()
            data_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t0) * 1e3)
        launches = dict(cuda_topk.launches)
        val = t.test()
    print(json.dumps({
        "workers": workers, "synthetic": t.train_data.synthetic,
        "images_per_s": JPEG_STEPS * 32 / decode_s,
        "data_ms": data_ms, "step_ms": step_ms, "losses": losses,
        "val_loss": val["val_loss"], "digest": h.hexdigest(),
        "launches": launches}))
    return 0


def _python(code: str, *args: str, env: dict = None):
    """A `python -c code args` subprocess from the checkout's root, its
    output going to temporary files (a pipe nobody reads could fill)."""
    import os
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=root,
                            env={**os.environ, **(env or {})},
                            stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    return proc


def _wait(proc, what: str, timeout: float = 600.0, quiet=()):
    """(rc, stdout) of `proc`, stopped if it outlasts `timeout`; its error
    output is printed when the code is not 0, 45, 46 or one of
    `quiet`."""
    import subprocess

    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    texts = []
    for fh in proc.files:
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    if proc.returncode not in (0, 45, 46, *quiet):
        print(f"{what}: rc {proc.returncode}\n{texts[1][-4000:]}",
              file=sys.stderr)
    proc.texts = texts
    return proc.returncode, texts[0]


def jpeg_phase() -> dict:
    """Phase 12a: seeded JPEGs; ResNet-50 at 0 and 8 decode workers, in a
    process each, one after the other; the batches bitwise equal. Skips, on a line of its
    own, where PIL is not installed. Returns the launches."""
    import tempfile

    total = {name: 0 for name in REPLACES}
    try:
        import PIL
    except ImportError:
        print("jpeg: PIL is not installed on this machine; phase 12a "
              "skipped")
        return total
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_jpegs(root)
        print(f"jpeg: wrote {JPEG_CLASSES} classes x {JPEG_TRAIN} train + "
              f"{JPEG_VAL} val JPEGs, {JPEG_SIZE[0]}x{JPEG_SIZE[1]} at "
              f"quality {JPEG_QUALITY} (PIL {PIL.__version__}) in "
              f"{time.perf_counter() - t0:.1f} s")
        code = ("import sys, chip_smoke as s; "
                "sys.exit(s.jpeg_worker(sys.argv[1], int(sys.argv[2])))")
        runs = {}
        for w in (0, 8):  # one after the other: each is timed alone
            rc, out = _wait(_python(code, root, str(w)), f"jpeg workers={w}")
            check(rc == 0, f"jpeg workers={w}: rc {rc}")
            runs[w] = json.loads(out.strip().splitlines()[-1])
    for w, r in runs.items():
        check(not r["synthetic"], f"jpeg workers={w}: read synthetic data")
        check(all(math.isfinite(v) for v in r["losses"] + [r["val_loss"]]),
              f"jpeg workers={w}: losses {r['losses']}")
        check_launches(r["launches"],
                       {"fused_stage1_candidates": JPEG_STEPS},
                       f"jpeg workers={w}")
        for name in REPLACES:
            total[name] += r["launches"][name]
        print(f"jpeg resnet50 twostage, decode_workers={w}: decode "
              f"{r['images_per_s']:.1f} images/s; host data ms "
              f"{[round(v, 3) for v in r['data_ms']]}; step ms "
              f"{[round(v, 3) for v in r['step_ms']]}; loss "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; launches "
              f"{r['launches']}")
    check(runs[0]["digest"] == runs[8]["digest"],
          "jpeg: batches at 0 and 8 decode workers differ")
    print(f"jpeg: the batches at 0 and 8 decode workers are bitwise equal "
          f"(sha256 {runs[0]['digest'][:16]})")
    return total


def exact_sum_input(n: int, gen):
    """n float32s whose sum and sum of magnitudes are exact in any order:
    4,096 distinct integers 1..4096 (or n) times 2^-10 at random
    positions, random signs, zeros elsewhere (sum |x| < 2^24 units)."""
    import torch

    m = min(n, 4096)
    x = torch.zeros(n)
    pos = torch.randperm(n, generator=gen)[:m]
    sign = torch.randint(0, 2, (m,), generator=gen) * 2 - 1
    x[pos] = ((torch.randperm(m, generator=gen) + 1) * sign).float() \
        * 2.0 ** -10
    return x


def topk_phase() -> None:
    """Phase 12b: each method's whole selection stage at ResNet-20's and
    the zoo's flat sizes, density 0.001: median ms of 20 calls, recall
    against ``exact``; ``blockwise`` bitwise ``exact`` on distinct
    magnitudes; ``simrecall`` on the card bitwise the CPU's on inputs
    whose sums are exact; ``approx`` launches the stage-1 kernel; the
    ``auto`` choice."""
    import torch

    from gtopkssgd_tpu_torch import select_probe
    from gtopkssgd_tpu_torch.ops import cuda_topk, topk

    for n in SIZES[:6]:
        k = topk.k_for_density(n, 0.001)
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn(n, device="cuda", generator=gen)
        want = topk.select_topk(x, k, "exact")[1]
        row = []
        for method in TOPK_METHODS:
            ms = select_probe.stage_ms(method, n)
            idx = topk.select_topk(x, k, method)[1]
            recall = float(torch.isin(idx, want).sum()) / k
            exact = method in ("exact", "blockwise")
            check(recall == 1.0 if exact else recall >= 0.9,
                  f"topk {method} n={n}: recall {recall}")
            row.append(f"{method} {ms:.4f} ms recall {recall:.4f}")
        mags = (torch.randperm(n, device="cuda", generator=gen)
                + 0x3F800000).to(torch.int32).view(torch.float32)
        d = mags * (torch.randint(0, 2, (n,), device="cuda",
                                  generator=gen) * 2 - 1)
        for a, b in zip(topk.select_topk(d, k, "blockwise"),
                        topk.select_topk(d, k, "exact")):
            check(torch.equal(a, b), f"topk blockwise n={n} != exact")
        xs = exact_sum_input(n, torch.Generator().manual_seed(n))
        card = topk.select_topk(xs.cuda(), k, "simrecall")
        host = topk.select_topk(xs, k, "simrecall")
        for a, b in zip(card, host):
            check(torch.equal(a.cpu(), b),
                  f"topk simrecall n={n}: card != CPU")
        cuda_topk.reset_launches()
        topk.select_topk(x, k, "approx")
        torch.cuda.synchronize()
        check(cuda_topk.launches["fused_stage1_candidates"] == 1,
              f"topk approx n={n}: launches {cuda_topk.launches}")
        print(f"topk n={n:,d} k={k}: " + "; ".join(row)
              + f"; blockwise bitwise exact (distinct magnitudes); "
              f"simrecall card bitwise CPU (exact sums); approx launched "
              f"the stage-1 kernel; auto -> {topk._resolve_auto(n)}")


def cli_main(argv) -> int:
    """Phase 12c and 12d in a fresh process: ``dist_trainer.main(argv)``
    (deterministic algorithms when SMOKE_DETERMINISTIC is set); prints
    this process's launches on a tagged line; returns the CLI's code."""
    import os

    from gtopkssgd_tpu_torch import dist_trainer
    from gtopkssgd_tpu_torch.ops import cuda_topk

    if os.environ.get("SMOKE_DETERMINISTIC"):
        deterministic(True)
    cuda_topk.reset_launches()
    rc = dist_trainer.main(list(argv))
    print(LAUNCHES_TAG + json.dumps(dict(cuda_topk.launches)))
    return rc


def _cli(args, *, det: bool = False, env: dict = None):
    code = "import sys, chip_smoke as s; sys.exit(s.cli_main(sys.argv[1:]))"
    env = dict(env or {})
    if det:
        env["SMOKE_DETERMINISTIC"] = "1"
    return _python(code, *args, env=env)


def _cli_wait(proc, what: str, want_rc: int, total: dict) -> str:
    rc, out = _wait(proc, what, quiet=(want_rc,))
    check(rc == want_rc, f"{what}: rc {rc}, expected {want_rc}")
    tagged = [line for line in out.splitlines()
              if line.startswith(LAUNCHES_TAG)]
    for name, n in json.loads(tagged[-1][len(LAUNCHES_TAG):]).items():
        total[name] += n
    return out


def _ckpt(out_dir: str, step: int, rank: int = 0) -> dict:
    import torch

    return torch.load(f"{out_dir}/ckpt/{step}/rank{rank}.pt",
                      weights_only=True)


def multihost_ref_rank(device, cfg, num_iters: int) -> int:
    """Phase 12d's reference: one rank of the spawned P = 2 run, the body
    ``dist_trainer`` spawns, under deterministic algorithms."""
    from gtopkssgd_tpu_torch import dist_trainer

    deterministic(True)
    return dist_trainer._rank_run(device, cfg, num_iters, False)["rc"]


def grow_rank(device, out_dir: str) -> dict:
    """Phase 12c's grow: a P = 2 trainer restoring a P = 1 checkpoint
    under ``elastic``; this rank's residual."""
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    with Trainer(TrainConfig(dnn="resnet20", batch_size=32,
                             compression="gtopk", density=0.001,
                             topk_method="twostage", nworkers=2,
                             eval_batches=1, out_dir=out_dir, resume=True,
                             elastic=True, prefetch=0,
                             device=str(device))) as t:
        return {"rank": t.rank, "step": t.step,
                "residual": t.optimizer.state["residual"].cpu()}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def resilience_phase() -> dict:
    """Phases 12c and 12d, each through the ``dist_trainer`` command line
    in a subprocess: preemption at P = 1 (exit 45, then a resume bitwise
    an uninterrupted run); an elastic shrink 2 -> 1 (exit 46, residual
    column sums kept, trains on) and a grow 1 -> 2 (the new rank's
    residual zero); ``--multihost`` with two env-launched ranks bitwise
    the spawned P = 2 run. Returns the launches of the P = 1 processes
    (a spawned rank's are not read back)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from gtopkssgd_tpu_torch.parallel.dist import spawn
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    total = {name: 0 for name in REPLACES}
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    two = ["--topk-method", "twostage"]
    pal = ["--topk-method", "pallas"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        a, b, c, g, m, r = (os.path.join(tmp, x) for x in "abcgmr")
        port = str(_free_port())
        group1 = {
            "preempt": (_cli(SMOKE_BASE + two + [
                "--num-iters", "6", "--out-dir", a, "--inject",
                "preempt@3"], det=True), 45),
            "straight": (_cli(SMOKE_BASE + two + [
                "--num-iters", "6", "--out-dir", b], det=True), 0),
            "shrink": (_cli(SMOKE_BASE + pal + [
                "--nworkers", "2", "--dist-backend", backend,
                "--num-iters", "6", "--out-dir", c, "--elastic",
                "--inject", "resize@3:1"]), 46),
            "grow": (_cli(SMOKE_BASE + two + [
                "--num-iters", "6", "--out-dir", g, "--elastic",
                "--inject", "resize@2:2"]), 46),
        }
        for rank in range(2):
            group1[f"multihost{rank}"] = (_cli(
                SMOKE_BASE + two + ["--multihost", "--num-iters", "3",
                                    "--out-dir", m, "--dist-backend",
                                    backend], det=True,
                env={"RANK": str(rank), "WORLD_SIZE": "2",
                     "LOCAL_RANK": str(rank % cards),
                     "MASTER_ADDR": "localhost", "MASTER_PORT": port}), 0)
        ref_cfg = TrainConfig(dnn="resnet20", batch_size=32,
                              compression="gtopk", density=0.001,
                              topk_method="twostage", eval_batches=1,
                              seed=42, prefetch=0, nworkers=2, out_dir=r)
        ref = spawn(multihost_ref_rank, 2, ref_cfg, 3, backend=backend,
                    device="cuda", timeout=600)
        check(ref == [0, 0], f"multihost reference: rc {ref}")
        for what, (proc, rc) in group1.items():
            _cli_wait(proc, what, rc, total)
        # 12c, preemption: resume to step 6, against 6 straight.
        resume = _cli(SMOKE_BASE + two + ["--num-iters", "3", "--out-dir",
                                          a, "--resume"], det=True)
        # 12c, shrink: the relaunch's restored residual, in this process.
        check(os.path.exists(os.path.join(c, "elastic.json")),
              "shrink: no elastic.json")
        with open(os.path.join(c, "elastic.json")) as fh:
            lineage = json.load(fh)
        saved = [_ckpt(c, 3, q)["residual"].double() for q in range(2)]
        with Trainer(TrainConfig(dnn="resnet20", batch_size=32,
                                 compression="gtopk", density=0.001,
                                 topk_method="pallas", eval_batches=1,
                                 out_dir=c, resume=True, elastic=True,
                                 prefetch=0, device="cuda")) as t:
            got = t.optimizer.state["residual"].cpu().double()
            check(t.step == 3, f"shrink: restored step {t.step}")
        want = saved[0] + saved[1]
        err = float((got - want).abs().max())
        ulp = float(want.abs().max()) * 2.0 ** -23
        check(err <= ulp, f"shrink: column sums moved by {err} > {ulp}")
        relaunch = _cli(SMOKE_BASE + pal + [
            "--nworkers", "1", "--num-iters", "2", "--out-dir", c,
            "--resume", "--elastic"])
        # 12c, grow: 1 -> 2 ranks, the new rank's residual zero.
        grown = spawn(grow_rank, 2, g, backend="gloo", device="cuda",
                      timeout=600)
        before = _ckpt(g, 2)["residual"].numpy()
        check(np.array_equal(grown[0]["residual"], before)
              and grown[0]["step"] == 2,
              "grow: rank 0's residual is not the saved one")
        check(not np.any(np.asarray(grown[1]["residual"])),
              "grow: the new rank's residual is not zero")
        _cli_wait(resume, "resume", 0, total)
        _cli_wait(relaunch, "shrink relaunch", 0, total)
        full, resumed = _ckpt(b, 6), _ckpt(a, 6)
        same = all(torch.equal(v, resumed[key]) for key, v in full.items())
        check(same, "preempt@3 + resume != 6 straight steps")
        # 12d: the env-launched ranks against the spawned P = 2 run.
        for rank in range(2):
            mine, theirs = _ckpt(m, 3, rank), _ckpt(r, 3, rank)
            check(all(torch.equal(v, theirs[key]) for key, v in mine.items()
                      if key.startswith("model.")),
                  f"multihost rank {rank}: parameters != spawned P = 2")
    print(f"resilience: preempt@3 exit 45, resume to step 6 bitwise 6 "
          f"straight steps (deterministic algorithms); shrink 2 -> 1 "
          f"({backend}) exit 46, lineage {lineage['lineage_id']} epoch "
          f"{lineage['resize_epoch']}, restored residual within {err:.3g} "
          f"of the saved column sums (bound {ulp:.3g}), the relaunch trained "
          f"on; grow 1 -> 2 exit 46, the new rank's residual zero; "
          f"multihost: two env-launched ranks ({backend}) bitwise the "
          f"spawned P = 2 run's parameters; "
          f"{time.perf_counter() - t0:.1f} s")
    return total


# Phase 13: the observability and the recovery policy.
OBS_STEPS = 6
OBS_RTOL = 1e-5  # the norms and mass ratios: float32 sums of up to 25.6M
OBS_RECALL = (0.95, 1.0)
OBS_BASE = dict(batch_size=32, compression="gtopk", density=0.001,
                eval_batches=1, seed=42, log_interval=1, obs_layers=True,
                obs_audit_interval=2)


def obs_reference(opt, res_before, age):
    """The counters of the P = 1 threshold step just taken, recomputed in
    float64 from its own tensors: the flat gradient (``opt.flat_grad``;
    no clip in these runs), the residual before the step, the keep mask;
    `age` (f64[N], on the card) advanced in place. Returns (scalars,
    layer rows)."""
    import torch

    acc = (opt.flat_grad + res_before).double()  # what the card selected
    flat = opt.flat_grad.double()
    keep = opt.last_keep
    upd = torch.where(keep, acc, 0.0)
    resid = torch.where(keep, 0.0, acc)
    age.add_(1.0).masked_fill_(upd != 0, 0.0)
    n = acc.shape[0]

    def stats(o, s):
        a, u, k = acc[o:o + s], upd[o:o + s], keep[o:o + s]
        kept = a.abs()[k]
        return {
            "sent": float(k.sum()),
            "tau": float(kept.min()) if kept.numel() else 0.0,
            "m_k": float((u * u).sum() / max(float((a * a).sum()), 1e-30)),
            "grad_norm_pre": float(flat[o:o + s].norm()),
            "grad_norm_post": float(u.norm()),
            "residual_norm": float(resid[o:o + s].norm()),
            "residual_age": float(age[o:o + s].mean()),
        }

    whole = stats(0, n)
    lay = opt.layout
    rows = [stats(o, s) for o, s in zip(lay.offsets, lay.sizes)]
    for r, s in zip(rows, lay.sizes):
        r["density"] = r.pop("sent") / s
    whole["sent_elems"] = whole.pop("sent")
    whole["achieved_density"] = whole["sent_elems"] / n
    return whole, rows


def _obs_close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * max(abs(got), abs(want), 1e-30)


def obs_check(run: str, recs, wants, layer_names) -> None:
    """Each step's "obs" and "layers" records against `wants` (step ->
    the float64 counters): sent and tau exactly (tau is a float32 of the
    card's own accumulator), the layers' densities and mean ages to two
    float32 roundings (a float32 reciprocal, a product), the norms, mass
    ratios and the whole-model density within OBS_RTOL; the audit's
    recall in OBS_RECALL on the audit steps (count % 2 == 0: steps 1, 3,
    5), the previous value on the others."""
    obs = {r["step"]: r for r in recs if r["kind"] == "obs"}
    layers = [r for r in recs if r["kind"] == "layers"]
    check(sorted(obs) == list(range(1, OBS_STEPS + 1)),
          f"{run}: obs records at steps {sorted(obs)}")
    check(len(layers) == OBS_STEPS * len(layer_names),
          f"{run}: {len(layers)} layers records, expected "
          f"{OBS_STEPS} x {len(layer_names)}")
    worst = 0.0
    for step, (whole, rows) in wants.items():
        r = obs[step]
        check(r["sent_elems"] == whole["sent_elems"] and r["tau"] ==
              np_f32(whole["tau"]) and r["collective_count"] == 0.0,
              f"{run} step {step}: sent/tau {r['sent_elems']}/{r['tau']} "
              f"vs {whole['sent_elems']}/{whole['tau']}")
        for key in ("grad_norm_pre", "grad_norm_post", "residual_norm",
                    "m_k", "achieved_density"):
            worst = max(worst, abs(r[key] - whole[key]) / max(
                abs(whole[key]), 1e-30))
            check(_obs_close(r[key], whole[key], OBS_RTOL),
                  f"{run} step {step}: {key} {r[key]} vs float64 "
                  f"{whole[key]}")
        recall = r["audit_recall"]
        if step % 2:
            check(OBS_RECALL[0] <= recall <= OBS_RECALL[1],
                  f"{run} step {step}: audit recall {recall}")
        else:
            check(recall == obs[step - 1]["audit_recall"],
                  f"{run} step {step}: recall {recall} not carried")
        mine = [x for x in layers if x["step"] == step]
        check([x["layer"] for x in mine] == list(layer_names),
              f"{run} step {step}: layer names")
        for x, want in zip(mine, rows):
            check(x["tau"] == np_f32(want["tau"]),
                  f"{run} step {step} {x['layer']}: tau")
            for key in ("density", "residual_age"):  # two roundings
                check(_obs_close(x[key], want[key], 2.5e-7),
                      f"{run} step {step} {x['layer']}: {key} {x[key]} "
                      f"vs {want[key]}")
            for key in ("grad_norm_pre", "grad_norm_post", "residual_norm",
                        "m_k"):
                check(_obs_close(x[key], want[key], OBS_RTOL),
                      f"{run} step {step} {x['layer']}: {key} {x[key]} "
                      f"vs {want[key]}")
    print(f"obs {run}: {OBS_STEPS} obs records, {len(layers)} layers "
          f"records, float64 agreement (largest relative error of a "
          f"whole-model float field {worst:.3g}), recall "
          f"{[obs[s]['audit_recall'] for s in sorted(obs)]}")


def np_f32(x: float) -> float:
    import numpy as np

    return float(np.float32(x))


def obs_eager(dnn: str, method: str, out_dir: str):
    """OBS_STEPS eager steps, one at a time, each held to
    ``obs_reference``; returns (launches, the records, the trainer's
    median step ms, the layer names)."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    with Trainer(TrainConfig(dnn=dnn, topk_method=method, out_dir=out_dir,
                             device="cuda", **OBS_BASE)) as t:
        age = torch.zeros(t.num_params, dtype=torch.float64, device="cuda")
        wants, times = {}, []
        cuda_topk.reset_launches()
        for step in range(1, OBS_STEPS + 1):
            before = t.optimizer.state["residual"].clone()
            times += t.train(1)["step_times"]
            wants[step] = obs_reference(t.optimizer, before, age)
        launches = dict(cuda_topk.launches)
        names = t.layer_names
    recs = [json.loads(line) for line in
            open(f"{out_dir}/metrics.jsonl")]
    obs_check(f"{dnn} {method} eager", recs, wants, names)
    return launches, recs, 1e3 * statistics.median(times), names


def obs_phase() -> dict:
    """Phase 13, on the card: (a) the default observability at full width
    -- ResNet-50 ``twostage`` with ``--obs-layers`` and
    ``--obs-audit-interval 2``, 6 steps eager (counters against float64,
    ``obs_check``) and 6 in a CUDA graph at ``--steps-per-dispatch 2``
    (the audit's and the plain step's captures replayed by the count), the
    graph's records bitwise the eager run's under deterministic
    algorithms, K2's launches counted through the replays; ResNet-20
    ``pallas`` eager (the multisection kernel's launches); (b) a skip:
    ``nan_grad@3`` claimed by ``nan_loss=skip`` leaves the trainer
    bitwise at its state after step 2, and through the command line
    exits 0 with one "skip" record and the summary; (c) ``--obs-halt-on
    error`` exits 44 at the NaN's step, ``--obs-watchdog 1`` against a 3 s
    straggler exits 43 with a "stall" record. Returns the launches of the
    in-process runs and the command lines that read them back."""
    import os
    import tempfile

    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    total = {name: 0 for name in REPLACES}
    t0 = time.perf_counter()
    two = ["--topk-method", "twostage", "--num-iters", "5"]
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        d = {x: os.path.join(tmp, x) for x in
             ("eager", "graph", "pallas", "skip", "cskip", "halt", "stall")}
        cli = {
            "skip": (_cli(SMOKE_BASE + two + [
                "--out-dir", d["cskip"], "--inject", "nan_grad@3",
                "--recover-policy", "nan_loss=skip"]), 0),
            "halt": (_cli(SMOKE_BASE + two + [
                "--out-dir", d["halt"], "--inject", "nan_grad@3",
                "--obs-halt-on", "error"]), 44),
        }
        stall = _cli(SMOKE_BASE + two + [
            "--out-dir", d["stall"], "--inject", "slow_rank:0:3s@3",
            "--obs-watchdog", "1"])
        # (a) ResNet-50, eager then graph, deterministic.
        deterministic(True)
        try:
            launches, eager, eager_ms, names = obs_eager(
                "resnet50", "twostage", d["eager"])
            check_launches(launches, {"fused_stage1_candidates": OBS_STEPS},
                           "phase 13a resnet50 twostage eager")
            with Trainer(TrainConfig(dnn="resnet50", topk_method="twostage",
                                     out_dir=d["graph"], device="cuda",
                                     steps_per_dispatch=2,
                                     **OBS_BASE)) as g:
                cuda_topk.reset_launches()
                stats = g.train(OBS_STEPS)
                gs = g.graph_stats
                counted = {name: n - gs["captured"].get(name, 0)
                           + gs["replayed"].get(name, 0)
                           for name, n in cuda_topk.launches.items()}
                check(g.dispatch == "graph" and gs["captures"] == 2,
                      f"13a graph: dispatch {g.dispatch}, captures "
                      f"{gs['captures']} (expected the audit's and the "
                      "plain step's)")
        finally:
            deterministic(False)
        check_launches(counted, {"fused_stage1_candidates": OBS_STEPS},
                       "phase 13a resnet50 twostage graph")
        graph = [json.loads(line) for line in
                 open(os.path.join(d["graph"], "metrics.jsonl"))]
        for kind in ("obs", "layers"):
            mine = [{k: v for k, v in r.items() if k != "time"}
                    for r in graph if r["kind"] == kind]
            want = [{k: v for k, v in r.items() if k != "time"}
                    for r in eager if r["kind"] == kind
                    and r["step"] % 2 == 0]
            check(len(mine) == len(want) > 0 and mine == want,
                  f"13a: the graph's {kind} records differ from the eager "
                  "run's")
        graph_ms = 1e3 * statistics.median(stats["step_times"])
        print(f"obs resnet50 twostage: eager {eager_ms:.3f} ms a step, "
              f"graph (K = 2) {graph_ms:.3f} ms; graph obs and layers "
              f"records bitwise the eager run's at steps 2, 4, 6; "
              f"captures {gs['captures']}, stage-1 launches {OBS_STEPS} "
              "in each run")
        for run in (launches, counted):
            for name, n in run.items():
                total[name] += n
        # ResNet-20 pallas: the multisection kernel under the counters.
        launches, _, ms, _ = obs_eager("resnet20", "pallas", d["pallas"])
        check_launches(launches,
                       {"multisection_tau_lo[residual]": OBS_STEPS},
                       "phase 13a resnet20 pallas eager")
        for name, n in launches.items():
            total[name] += n
        print(f"obs resnet20 pallas eager: {ms:.3f} ms a step")
        # (b) A skip, in process: bitwise the state after step 2.
        with Trainer(TrainConfig(dnn="resnet20", batch_size=32,
                                 compression="gtopk", density=0.001,
                                 topk_method="twostage", out_dir=d["skip"],
                                 inject="nan_grad@3",
                                 recover_policy="nan_loss=skip",
                                 device="cuda")) as t:
            cuda_topk.reset_launches()
            t.train(2)
            snap = {k: v.clone() for k, v in t.checkpoint_state().items()}
            t.train(1)
            check(t.step == 2 and t.recovery.n_recoveries == 1,
                  f"13b: step {t.step} after the skip")
            now = t.checkpoint_state()
            bad = [k for k, v in snap.items() if not torch.equal(now[k], v)]
            check(not bad, f"13b: the state after the skip differs from "
                           f"the snapshot in {bad[:4]}")
            t.train(1)
            t.finalize_resilience("completed")
            for name, n in cuda_topk.launches.items():
                total[name] += n
        recs = [json.loads(line) for line in
                open(os.path.join(d["skip"], "metrics.jsonl"))]
        check([r["action"] for r in recs if r["kind"] == "recovery"]
              == ["skip", "summary"], "13b: recovery records")
        print("obs skip (in process): nan_grad@3 claimed by nan_loss=skip, "
              "the state bitwise the pre-step snapshot, one skip record "
              "and the summary")
        # (b) and (c) through the command line.
        for what, (proc, rc) in cli.items():
            _cli_wait(proc, f"13 {what}", rc, total)
        recs = [json.loads(line) for line in
                open(os.path.join(d["cskip"], "metrics.jsonl"))]
        summary = [r for r in recs if r["kind"] == "recovery"]
        check([r["action"] for r in summary] == ["skip", "summary"]
              and summary[-1]["final_status"] == "completed",
              "13b CLI: expected one skip record and a completed summary")
        recs = [json.loads(line) for line in
                open(os.path.join(d["halt"], "metrics.jsonl"))]
        last = max(r["step"] for r in recs if r["kind"] == "obs")
        summary = [r for r in recs if r["kind"] == "recovery"]
        check(last == 3 and summary[-1]["final_status"] == "halted",
              f"13c halt: last obs step {last}, expected 3")
        rc, _ = _wait(stall, "13 stall", quiet=(43,))
        recs = [json.loads(line) for line in
                open(os.path.join(d["stall"], "metrics.jsonl"))]
        stalls = [r for r in recs if r["kind"] == "stall"]
        check(rc == 43 and len(stalls) == 1
              and recs[-1]["final_status"] == "stalled",
              f"13c stall: rc {rc}, {len(stalls)} stall records")
        print(f"obs CLI: skip rc 0 (one skip record, completed summary); "
              f"halt rc 44 at step {last}; stall rc 43 (waited "
              f"{stalls[0]['waited_s']} s, last completed step "
              f"{stalls[0]['last_completed_step']})")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return total


# Phase 14: the trace planes.
TRACE_BASE = dict(batch_size=32, compression="gtopk", density=0.001,
                  eval_batches=1, seed=42, log_interval=1)
TRACE_STEPS = 6
TRACE_DIST = (2, 8)  # P over gloo on the one card, steps
K2_N = 25_557_032    # ResNet-50's gradient
K2_SHARE = 0.8       # select >= 0.8 x K2's phase-2 time a launch
GOODPUT_TOL = 1e-6
CLEAN_OTHER = 0.05   # the JAX package's gate on a clean run's other_frac
# The monitor rules the trace planes feed.
TRACE_RULES = ("comm_model_drift", "recompile_storm", "device_mem_leak",
               "hbm_headroom", "critpath_shift", "goodput_collapse",
               "link_degraded")


def k2_ms(n: int = K2_N) -> float:
    """The stage-1 kernel's device ms at `n`, timed as phase 2 times it."""
    import torch

    from gtopkssgd_tpu_torch.ops import cuda_topk, topk

    gen = torch.Generator(device="cuda").manual_seed(n)
    g = torch.randn(n, device="cuda", generator=gen)
    r = 0.3 * torch.randn(n, device="cuda", generator=gen)
    groups = topk._twostage_pallas_groups(n, topk.k_for_density(n, 0.001))
    return device_ms(lambda: cuda_topk.fused_stage1_candidates(
        g, None, r, groups=groups))


def _jsonl(path: str) -> list:
    return [json.loads(line) for line in open(path)]


def trace_line(arm: str, recs: list) -> dict:
    """Print one arm's split: the attributed ms a step of each class (the
    mean over its captures), the overlap fraction, the critical path's
    wall and wait share, and the final goodput fractions."""
    from gtopkssgd_tpu_torch.obs import goodput

    attrs = [r for r in recs if r["kind"] == "attr"]
    cps = [r for r in recs if r["kind"] == "critpath"]
    fin = [r for r in recs if r["kind"] == "goodput"][-1]
    ms = {t: statistics.mean(r[f"t_{t}_us"] / 1e3 / r["n_steps"]
                             for r in attrs)
          for t in ("compute", "select", "comm")}
    fracs = {c: round(v, 4) for c, v in goodput.category_fracs(fin).items()
             if v > 0}
    print(f"trace {arm}: attributed ms a step compute {ms['compute']:.3f} "
          f"select {ms['select']:.3f} comm {ms['comm']:.3f} (source "
          f"{attrs[-1]['source']}, comm {attrs[-1]['comm_source']}); "
          f"overlap {statistics.mean(r['overlap_frac'] for r in attrs):.4f}"
          + (f"; critpath wall "
             f"{statistics.mean(r['wall_us'] for r in cps) / 1e3:.3f} ms, "
             f"wait {statistics.mean(r['t_wait_us'] for r in cps) / 1e3:.3f}"
             " ms" if cps else "")
          + f"; goodput {fracs} (other_frac {fin['other_frac']})")
    return ms


def trace_checks(run: str, recs: list) -> None:
    """Every "goodput" record conserved; no event of a trace-plane rule."""
    from gtopkssgd_tpu_torch.obs import goodput

    gps = [r for r in recs if r["kind"] == "goodput"]
    check(gps and gps[-1]["final"] == 1, f"{run}: no final goodput record")
    for r in gps:
        err = goodput.conservation_error(r)
        check(err <= GOODPUT_TOL,
              f"{run}: goodput at step {r['step']} conserved to {err}")
    fired = [(r["rule"], r["step"]) for r in recs if r["kind"] == "event"
             and r["rule"] in TRACE_RULES]
    check(not fired, f"{run}: trace-plane events {fired}")


def trace_rank(device, out_dir: str, steps: int) -> dict:
    """One rank of phase 14c: ResNet-20 ``twostage`` at P ranks over gloo
    with the calibrator, the link map and critpath every 2 steps; its
    records and the calibrator's samples."""
    import torch.distributed as dist

    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    with Trainer(TrainConfig(dnn="resnet20", topk_method="twostage",
                             nworkers=dist.get_world_size(),
                             obs_calib=True, obs_linkmap=True,
                             obs_critpath=True, obs_calib_interval=2,
                             out_dir=out_dir, device=str(device),
                             **TRACE_BASE)) as t:
        t.train(steps)
        samples = [(b, ms) for _, b, ms in t.calib.samples]
    rank = dist.get_rank()
    return {"rank": rank, "samples": samples, "records": _jsonl(
        f"{out_dir}/metrics.rank{rank}.jsonl")}


def trace_phase(k2: float = None) -> dict:
    """Phase 14, on the card, batch 32, density 0.001, TF32 off: the trace
    planes (``obs.trace_attr``, ``critpath``, ``calib``, ``linkmap``,
    ``memwatch``, ``goodput``) -- (a) ResNet-50 ``twostage`` eager with
    critpath and the memory watch every 2 steps: three "critpath" records,
    each captured dispatch's select at least K2_SHARE x K2's time `k2`
    (phase 2's at K2_N; timed here when None) with ``stage1_kernel``
    among the select events, goodput conserved, one "compile" record whose
    FLOPs equal ``benchmark.py``'s count, "mem" records whose limit is the
    card's memory; ResNet-20 ``pallas`` with a capture at step 4: the
    multisection kernel in select, the goodput before it clean (other_frac
    <= CLEAN_OTHER); (b) ResNet-50 in CUDA graphs (K = 2): attributed on
    kernel names ("ops"), K2's replayed launches in select as many as the
    replays ran; (c) P = 2 over gloo on the card: calib with finite
    constants and the "obs" records' wire bytes, "linkmap" records keyed
    by ``round_peers``, ``calib_fit_2proc.json`` naming the card, the comm
    from the host's gloo events; (d) ``--profile-dir`` (a trace the planes
    read) and a skip's final goodput (one wasted step). No event of the
    rules these planes feed. Returns the launches of the runs."""
    import os
    import tempfile

    import torch

    from gtopkssgd_tpu_torch.benchmark import BenchConfig, _Bench
    from gtopkssgd_tpu_torch.obs import linkmap, trace_attr
    from gtopkssgd_tpu_torch.obs.memwatch import step_flops
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.parallel.dist import spawn
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    total = {name: 0 for name in REPLACES}
    t0 = time.perf_counter()
    if k2 is None:
        k2 = k2_ms()
    card_bytes = torch.cuda.mem_get_info()[1]
    two = ["--topk-method", "twostage"]
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        d = {x: os.path.join(tmp, x) for x in
             ("prof", "skip", "eager", "pallas", "graph", "dist")}
        # (d) The command line: both processes at once, first.
        cli = {"prof": _cli(SMOKE_BASE + two + [
                   "--num-iters", "1", "--profile-dir", d["prof"],
                   "--profile-steps", "2"]),
               "skip": _cli(SMOKE_BASE + two + [
                   "--num-iters", "5", "--out-dir", d["skip"], "--inject",
                   "nan_grad@3", "--recover-policy", "nan_loss=skip"])}
        for what, proc in cli.items():
            _cli_wait(proc, f"14d {what}", 0, total)
        rec = trace_attr.attribute(d["prof"])
        check(os.listdir(d["prof"]) == ["rank0.trace.json"]
              and rec["t_compute_us"] > 0 and rec["t_select_us"] > 0,
              f"14d --profile-dir: {os.listdir(d['prof'])}, compute "
              f"{rec['t_compute_us']} us, select {rec['t_select_us']} us")
        fin = [r for r in _jsonl(os.path.join(d["skip"], "metrics.jsonl"))
               if r["kind"] == "goodput"][-1]
        check(fin["final"] == 1 and fin["n_wasted_steps"] == 1
              and fin["wasted_s"] > 0,
              f"14d skip: final goodput {fin}")
        print(f"trace CLI: --profile-dir trace attributed compute "
              f"{rec['t_compute_us'] / 1e3:.3f} ms select "
              f"{rec['t_select_us'] / 1e3:.3f} ms over 2 steps; skip: "
              f"{fin['n_wasted_steps']} wasted step, {fin['wasted_s']} s "
              f"of {fin['wall_s']} s")

        # (a) ResNet-50 twostage, eager.
        cuda_topk.reset_launches()
        with Trainer(TrainConfig(
                dnn="resnet50", topk_method="twostage", out_dir=d["eager"],
                obs_critpath=True, obs_calib_interval=2, obs_mem=True,
                obs_mem_interval=2, obs_goodput_interval=2, device="cuda",
                **TRACE_BASE)) as t:
            t.train(TRACE_STEPS)
        launches = dict(cuda_topk.launches)
        check_launches(launches, {"fused_stage1_candidates": TRACE_STEPS},
                       "phase 14a resnet50 twostage eager")
        for name, n in launches.items():
            total[name] += n
        recs = _jsonl(os.path.join(d["eager"], "metrics.jsonl"))
        trace_checks("14a resnet50", recs)
        cps = [r["step"] for r in recs if r["kind"] == "critpath"]
        check(cps == [2, 4, 6], f"14a: critpath records at {cps}")
        for r in (r for r in recs if r["kind"] == "attr"):
            k2s = sum(n for name, n in r["select_ops"].items()
                      if "stage1_kernel" in name)
            check(k2s == r["n_steps"] and r["t_select_us"] / 1e3
                  >= K2_SHARE * k2 * k2s,
                  f"14a step {r['step']}: {k2s} stage-1 events, select "
                  f"{r['t_select_us']} us against K2 {k2:.5f} ms a launch")
        bench = _Bench(BenchConfig(dnn="resnet50", batch_size=32,
                                   dtype="float32", topk_method="twostage"),
                       "gtopk", 0.001, torch.device("cuda"), None)
        try:
            _, flops = step_flops(bench.step)
        finally:
            bench.close()
        comp = [r for r in recs if r["kind"] == "compile"]
        check(len(comp) == 1 and comp[0]["flops"] == flops > 0,
              f"14a: compile records {comp}, benchmark FLOPs {flops}")
        mems = [r for r in recs if r["kind"] == "mem"]
        check([r["step"] for r in mems] == [1, 3, 5] and all(
            r["bytes_limit"] == card_bytes for r in mems),
            f"14a: mem records {mems}, card {card_bytes} bytes")
        trace_line("resnet50 twostage eager", recs)
        print(f"trace resnet50 compile: first step {comp[0]['compile_s']} "
              f"s, {flops:.6g} FLOPs (= benchmark.py), peak "
              f"{comp[0]['peak_hbm_bytes']} bytes; mem live "
              f"{mems[-1]['live_bytes']} reserved {mems[-1]['bytes_in_use']}"
              f" of {card_bytes}; K2 {k2:.5f} ms a launch")
        # ResNet-20 pallas: the multisection kernel in select.
        cuda_topk.reset_launches()
        with Trainer(TrainConfig(
                dnn="resnet20", topk_method="pallas", out_dir=d["pallas"],
                obs_critpath=True, obs_calib_interval=4, obs_mem=True,
                obs_mem_interval=2, obs_goodput_interval=2, device="cuda",
                **TRACE_BASE)) as t:
            t.train(4)
        launches = dict(cuda_topk.launches)
        check_launches(launches, {"multisection_tau_lo[residual]": 4},
                       "phase 14a resnet20 pallas")
        for name, n in launches.items():
            total[name] += n
        recs = _jsonl(os.path.join(d["pallas"], "metrics.jsonl"))
        trace_checks("14a resnet20 pallas", recs)
        (attr,) = [r for r in recs if r["kind"] == "attr"]
        check(attr["step"] == 4 and any(
            "multisection_kernel" in name for name in attr["select_ops"]),
            f"14a pallas: select events {attr['select_ops']}")
        clean = [r for r in recs if r["kind"] == "goodput"][0]
        check(clean["step"] == 3 and clean["other_frac"] <= CLEAN_OTHER,
              f"14a pallas: goodput before the capture {clean}")
        trace_line("resnet20 pallas eager", recs)

        # (b) ResNet-50 in CUDA graphs, K = 2: the capture at steps 3-4.
        cuda_topk.reset_launches()
        with Trainer(TrainConfig(
                dnn="resnet50", topk_method="twostage", out_dir=d["graph"],
                steps_per_dispatch=2, obs_critpath=True,
                obs_calib_interval=4, obs_goodput_interval=2, device="cuda",
                **TRACE_BASE)) as g:
            g.train(2)
            before = dict(g.graph_stats["replayed"])
            g.train(2)
            replayed = {name: n - before.get(name, 0)
                        for name, n in g.graph_stats["replayed"].items()}
            g.train(TRACE_STEPS - 4)
            gs = g.graph_stats
            counted = {name: n - gs["captured"].get(name, 0)
                       + gs["replayed"].get(name, 0)
                       for name, n in cuda_topk.launches.items()}
            check(g.dispatch == "graph" and gs["captures"] >= 1,
                  f"14b: dispatch {g.dispatch}, captures {gs['captures']}")
        check_launches(counted, {"fused_stage1_candidates": TRACE_STEPS},
                       "phase 14b resnet50 twostage graph")
        for name, n in counted.items():
            total[name] += n
        recs = _jsonl(os.path.join(d["graph"], "metrics.jsonl"))
        trace_checks("14b resnet50 graph", recs)
        (attr,) = [r for r in recs if r["kind"] == "attr"]
        k2s = sum(n for name, n in attr["select_ops"].items()
                  if "stage1_kernel" in name)
        want = replayed.get("fused_stage1_candidates", 0)
        check(attr["step"] == 4 and attr["source"] == "ops"
              and k2s == want == 2,
              f"14b: source {attr['source']}, {k2s} stage-1 events in "
              f"select, {want} replayed")
        trace_line("resnet50 twostage graph K=2", recs)

        # (c) P = 2 over gloo on the one card.
        p, steps = TRACE_DIST
        ranks = spawn(trace_rank, p, d["dist"], steps, backend="gloo",
                      device="cuda", timeout=600)
        links = {linkmap.link_key(rd["axis"], *pair)
                 for rd in linkmap.round_peers("gtopk", p)
                 for pair in rd["pairs"]}
        for out in ranks:
            run = f"14c rank {out['rank']}"
            recs = out["records"]
            trace_checks(run, recs)
            attrs = [r for r in recs if r["kind"] == "attr"]
            check(len(attrs) == steps // 2 and all(
                r["comm_source"] == "host" and r["t_comm_us"] > 0
                for r in attrs), f"{run}: attr {attrs}")
            fits = [r for r in recs if r["kind"] == "calib"]
            check(fits and all(math.isfinite(r["alpha_fit_ms"])
                               and math.isfinite(r["beta_fit_gbps"])
                               for r in fits), f"{run}: calib {fits}")
            wire = {r["step"]: r["wire_bytes"] for r in recs
                    if r["kind"] == "obs"}
            check([b for b, _ in out["samples"]]
                  == [wire[s] for s in range(2, steps + 1, 2)],
                  f"{run}: calib samples {out['samples']} vs obs {wire}")
            lms = [r for r in recs if r["kind"] == "linkmap"]
            check(len(lms) == steps // 2 and all(
                {x["link"] for x in r["links"]} <= links
                and r["wire_bytes"] == wire[r["step"]] for r in lms),
                f"{run}: linkmap records {lms}")
            cps = [r for r in recs if r["kind"] == "critpath"]
            check(all(r["t_comm_wire_us"] + r["t_wait_us"] > 0
                      and r["t_wait_us"] >= 0 for r in cps),
                  f"{run}: critpath {cps}")
            trace_line(f"resnet20 twostage P=2 gloo rank {out['rank']}",
                       recs)
            print(f"trace P=2 rank {out['rank']}: calib alpha "
                  f"{fits[-1]['alpha_fit_ms']} ms beta "
                  f"{fits[-1]['beta_fit_gbps']} Gb/s "
                  f"({fits[-1]['identifiable']}, planner's "
                  f"{fits[-1].get('planner_fit_source')}); link "
                  f"{lms[-1]['worst_link']} ewma "
                  f"{lms[-1]['worst_ewma_ms']} ms; critpath wire "
                  f"{[r['t_comm_wire_us'] for r in cps]} us, wait "
                  f"{[r['t_wait_us'] for r in cps]} us")
        art = json.load(open(os.path.join(d["dist"],
                                          "calib_fit_2proc.json")))
        check((art.get("card") or "").startswith(
            torch.cuda.get_device_name(0))
            and art["alpha_beta_fit"]["beta_gbps"] > 0,
            f"14c: calib_fit_2proc.json {art}")
        print(f"trace calib_fit_2proc.json: {art['alpha_beta_fit']} on "
              f"{art['card']}")
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return total


PLANES_BASE = ["--batch-size", "32", "--compression", "gtopk", "--density",
               "0.001", "--eval-batches", "1", "--seed", "42", "--prefetch",
               "0", "--log-interval", "1", "--nworkers", "2"]
FORECAST_RUN = ["--dnn", "resnet50", "--topk-method", "twostage",
                "--num-iters", "8", "--obs-calib", "--obs-critpath",
                "--obs-linkmap", "--obs-calib-interval", "2",
                "--obs-forecast"]
EVICT_RUN = ["--dnn", "resnet20", "--topk-method", "pallas", "--elastic",
             "--evict-after-windows", "1", "--obs-goodput-interval", "2"]
EVICT_STEPS = 12
# Rank 1 sleeps 2 s before each step. The goodput fractions count the
# start-up (about 16 s a rank on the card): at 0.3 s a step rank 1 stood
# out by more than advise's margin only at the last check, step 12; at
# 2 s the check at step 4-6 evicts it, even with 15a's runs beside it.
EVICT_INJECT = ["--inject", "slow_rank:1:2@1-12"]
FORECAST_TARGETS = (32, 256, 1024)
# The fits a forecast may price with: the committed ones, the run's own
# refit, a calib_fit file.
MEASURED_FITS = ("comm_fit.json", "comm_fit_nccl.json", "calib")
# (subcommand, run) of 15c that exit 1 by the JAX grammar: nothing to
# show, C having run no capture.
NOTHING_TO_SHOW = (("attr", "C"), ("critpath", "C"), ("linkmap", "C"),
                   ("forecast", "C"))
RANKS_TAG = "SMOKE_RANKS "


def planes_rank(device, argv) -> dict:
    """One rank of phase 15: the command line's own rank body
    (``dist_trainer._rank_run``) on the config it parses from `argv`; its
    exit code, step and kernel launches."""
    import torch.distributed as dist

    from gtopkssgd_tpu_torch import dist_trainer
    from gtopkssgd_tpu_torch.ops import cuda_topk

    args = dist_trainer.build_argparser().parse_args(argv)
    cuda_topk.reset_launches()
    out = dist_trainer._rank_run(device, dist_trainer.config_from_args(args),
                                 args.num_iters, args.preempt_save)
    return {"rc": out["rc"], "step": out["step"], "rank": dist.get_rank(),
            "launches": dict(cuda_topk.launches)}


def planes_spawn(argv) -> list:
    """Phase 15's P = 2 run of `argv` (``planes_rank`` on each rank)."""
    import torch

    from gtopkssgd_tpu_torch.parallel.dist import spawn

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    return spawn(planes_rank, 2, list(argv), backend=backend,
                 device="cuda", timeout=600)


def spawn_main(argv) -> int:
    """A phase 15 run in a process of its own (two run side by side):
    prints its ranks' results on a tagged line."""
    print(RANKS_TAG + json.dumps(planes_spawn(argv)))
    return 0


def _spawned(argv):
    """Start ``spawn_main(argv)`` in a subprocess."""
    return _python("import sys, json, chip_smoke as s; "
                   "sys.exit(s.spawn_main(json.loads(sys.argv[1])))",
                   json.dumps(list(argv)))


def _ranks(proc, what: str) -> list:
    """The ranks' results a ``_spawned`` process printed."""
    rc, out = _wait(proc, what, timeout=600)
    tagged = [line for line in out.splitlines()
              if line.startswith(RANKS_TAG)]
    check(rc == 0 and tagged, f"{what}: process rc {rc}")
    return json.loads(tagged[-1][len(RANKS_TAG):])


def _report(argv) -> tuple:
    """(exit code, stdout) of ``obs.report.main(argv)`` in this process."""
    import contextlib
    import io

    from gtopkssgd_tpu_torch.obs import report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main(list(argv))
    return rc, buf.getvalue()


def _card_line() -> str:
    from gtopkssgd_tpu_torch.profile_step import card_identity

    return card_identity()


def forecast_checks(run: str, recs: list) -> list:
    """One durable "forecast" record a capture, each with a finite
    hindcast, a recommendation at every target and a measured fit."""
    fcs = [r for r in recs if r["kind"] == "forecast"]
    caps = [r["step"] for r in recs if r["kind"] == "critpath"]
    check(fcs and [r["step"] for r in fcs] == caps,
          f"{run}: forecast records at {[r['step'] for r in fcs]}, "
          f"captures at {caps}")
    for r in fcs:
        src = str(r.get("fit_source"))
        check(math.isfinite(r["hindcast_err_x"])
              and all(f"rec_p{p}" in r for p in FORECAST_TARGETS)
              and (src in MEASURED_FITS or src.startswith("calib_fit_")),
              f"{run} step {r['step']}: forecast {r}")
    return fcs


def planes_phase() -> dict:
    """Phase 15, on the card: the fleet merge, the report, the registry,
    the forecast and the eviction (see the module docstring). Returns the
    launches of its runs."""
    import os
    import shutil
    import tempfile

    from gtopkssgd_tpu_torch.obs import registry

    total = {name: 0 for name in REPLACES}
    t0 = time.perf_counter()
    card = _card_line()
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        d = {x: os.path.join(tmp, x) for x in
             ("A", "B", "C", "D", "R", "R_A")}
        # (a) The forecast and the registry: A and B side by side, each a
        # process spawning its two ranks, one registry; (b) the eviction
        # beside them.
        fc_argv = PLANES_BASE + FORECAST_RUN + ["--registry", d["R"]]
        procs = {run: _spawned(fc_argv + ["--out-dir", d[run]])
                 for run in ("A", "B")}
        evict = _spawned(PLANES_BASE + EVICT_RUN + EVICT_INJECT + [
            "--num-iters", str(EVICT_STEPS), "--out-dir", d["C"]])
        for run, proc in procs.items():
            for out in _ranks(proc, f"15a {run}"):
                check(out["rc"] == 0, f"15a {run}: rank rc {out['rc']}")
                check_launches(out["launches"],
                               {"fused_stage1_candidates": 8},
                               f"phase 15a {run} resnet50 twostage P=2")
                for name, n in out["launches"].items():
                    total[name] += n
        t_a = time.perf_counter() - t0
        fcs = {}
        for run in ("A", "B"):
            for rank in (0, 1):
                recs = _jsonl(os.path.join(d[run],
                                           f"metrics.rank{rank}.jsonl"))
                fcs[run, rank] = forecast_checks(f"15a {run} rank {rank}",
                                                 recs)
        drift = [r for run in ("A", "B") for rank in (0, 1)
                 for r in _jsonl(os.path.join(d[run],
                                              f"metrics.rank{rank}.jsonl"))
                 if r["kind"] == "event" and r["rule"] == "forecast_drift"]
        entries, bad = registry.load_registry(d["R"])
        check(bad == 0 and len(entries) == 2
              and len({e["config_hash"] for e in entries}) == 1,
              f"15a: registry {entries}")
        # The registry as A alone would have left it: its line (the
        # manifest's time keys it).
        t_man = _jsonl(os.path.join(d["A"], "metrics.rank0.jsonl"))[0]
        registry.append_run(d["R_A"], next(
            e for e in entries if e["time"] == t_man["time"]))
        rc, out = _report(["history", d["R"]])
        check(rc == 0 and out.count(entries[0]["config_hash"][:16]) == 2,
              f"15a history: rc {rc}\n{out}")
        verdicts = {}
        for name in ("R", "R_A"):
            rc, out = _report(["regress", d["B"], "--registry", d[name]])
            both = [f for f, _, _ in registry.REGRESS_CHECKS
                    if all(isinstance(e["stats"].get(f), (int, float))
                           for e in entries)]
            check(rc in (0, 1) and all(f in out for f in both),
                  f"15a regress B --registry {name}: rc {rc}, fields "
                  f"{both}\n{out}")
            verdicts[name] = (rc, out.strip().splitlines()[-1])
        last = fcs["A", 0][-1]
        stats = registry.load_registry(d["R_A"])[0][0]["stats"]
        print(f"planes 15a: hindcast_err_x {last['hindcast_err_x']} "
              f"(pred {last['hindcast_pred_ms']} ms, meas "
              f"{last['hindcast_meas_ms']} ms, fit {last['fit_source']}); "
              f"P=256 {last['rec_p256']} step {last['step_ms_p256']} ms; "
              f"crossover_p {last.get('crossover_p')}; forecast_drift "
              f"events {len(drift)}; registry A steps_per_sec "
              f"{stats.get('steps_per_sec')} goodput_frac "
              f"{stats.get('goodput_frac')}; regress B vs R rc "
              f"{verdicts['R'][0]}, vs R as A left it rc "
              f"{verdicts['R_A'][0]} ({verdicts['R_A'][1]}); A and B "
              f"side by side {t_a:.1f} s; {card}")

        # (b) The eviction.
        ranks = _ranks(evict, "15b eviction")
        steps = {out["step"] for out in ranks}
        fracs = {rank: [(r["step"], r["goodput_frac"]) for r in _jsonl(
            os.path.join(d["C"], f"metrics.rank{rank}.jsonl"))
            if r["kind"] == "goodput"] for rank in (0, 1)}
        check([out["rc"] for out in ranks] == [46, 46] and len(steps) == 1,
              f"15b: ranks {[(o['rc'], o['step']) for o in ranks]}, "
              f"goodput (step, frac) by rank {fracs}")
        (step,) = steps
        for out in ranks:
            check_launches(out["launches"],
                           {"multisection_tau_lo[abs]": step},
                           "phase 15b resnet20 pallas P=2")
            for name, n in out["launches"].items():
                total[name] += n
        for rank in (0, 1):
            recs = _jsonl(os.path.join(d["C"], f"metrics.rank{rank}.jsonl"))
            resize = [r for r in recs if r["kind"] == "resize"]
            check(len(resize) == 1 and resize[0]["reason"] == "evict"
                  and resize[0]["evicted_ranks"] == [1]
                  and resize[0]["new_p"] == 1,
                  f"15b rank {rank}: resize records {resize}")
        lineage = json.load(open(os.path.join(d["C"], "elastic.json")))
        check(lineage["p"] == 1 and lineage["evicted_ranks"] == [1],
              f"15b: elastic.json {lineage}")
        os.makedirs(d["D"])
        shutil.copytree(os.path.join(d["C"], "ckpt"),
                        os.path.join(d["D"], "ckpt"))
        shutil.copy2(os.path.join(d["C"], "elastic.json"), d["D"])
        relaunch = _cli(
            [a for a in PLANES_BASE if a not in ("--nworkers", "2")]
            + EVICT_RUN + ["--nworkers", "1", "--resume", "--num-iters",
                           "2", "--out-dir", d["D"]])
        rc, out = _report(["goodput", d["C"], "--advise", "--json",
                           os.path.join(tmp, "advise.json")])
        hint = json.load(open(os.path.join(tmp, "advise.json")))["advise"]
        check(rc == 0 and hint and hint["rank"] == 1,
              f"15b goodput --advise: rc {rc}, {hint}\n{out}")
        rc, out = _report(["fleet", d["C"]])
        check(rc == 0 and "[straggler]" in out,
              f"15b fleet: rc {rc}\n{out}")

        # (c) Every subcommand over A and C; gate against a baseline each
        # run's first gate writes (--write) from its own records.
        base = os.path.join(tmp, "base.json")
        with open(base, "w") as fh:
            json.dump({"checks": [
                {"kind": "obs", "field": "wire_bytes", "stat": "mean",
                 "expect": 0.0, "rtol": 0.01},
                {"kind": "train", "field": "loss", "stat": "last",
                 "expect": 0.0, "rtol": 0.25}],
                "manifest": {"compression": "gtopk"}}, fh)
        codes = {}
        for run in ("A", "C"):
            _report(["gate", d[run], "--baseline", base, "--write",
                     f"{base}.{run}"])
            for sub in ("summary", "gate", "attr", "events", "recovery",
                        "timeline", "critpath", "ledger", "linkmap",
                        "forecast", "compile", "mem", "plan"):
                argv = ([d[run]] if sub == "summary" else
                        ["gate", d[run], "--baseline", f"{base}.{run}"]
                        if sub == "gate" else [sub, d[run]])
                rc, out = _report(argv)
                want = 1 if (sub, run) in NOTHING_TO_SHOW else 0
                check(rc == want, f"15c {sub} {run}: rc {rc}, expected "
                                  f"{want}\n{out[-3000:]}")
                codes[f"{sub}:{run}"] = rc
        # The relaunch ran meanwhile.
        _cli_wait(relaunch, "15b relaunch", 0, total)
        man = _jsonl(os.path.join(d["D"], "metrics.jsonl"))[0]
        check(man.get("lineage_id") == lineage["lineage_id"],
              f"15b relaunch: lineage {man.get('lineage_id')} vs "
              f"{lineage['lineage_id']}")
        print(f"planes 15b: evicted rank {hint['rank']} at step {step} "
              f"(the run's goodput_frac {hint['goodput_frac']} vs fleet "
              f"median {hint['fleet_median_frac']}, dominant badput "
              f"{hint['dominant_badput']}; (step, goodput_frac) by rank "
              f"{fracs}); relaunch at P=1 rc 0, lineage "
              f"{lineage['lineage_id']} kept; {card}")
        print(f"planes 15c: report exit codes {codes} (1 = nothing to "
              f"show: {NOTHING_TO_SHOW})")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return total


# Phase 16: the experiment grid through the port's runner, and graftlint.
EXPERIMENT_STEPS = 3
EXPERIMENT_RUNS = (
    ("16a", ["imagenet_resnet50_gtopk", "--nworkers", "1", "--batch-size",
             "32", "--num-iters", str(EXPERIMENT_STEPS), "--eval-batches",
             "1"]),
    ("16b", ["cifar10_resnet20_gtopk_recommended", "--nworkers", "2",
             "--batch-size", "32", "--num-iters", "2", "--eval-batches",
             "1"]),
)
LINT_CODE = ("import sys\n"
             "from gtopkssgd_tpu_torch.analysis.__main__ import main\n"
             "rc = main(sys.argv[1:])\n"
             "assert 'torch' not in sys.modules, 'graftlint imported torch'\n"
             "sys.exit(rc)\n")


def experiment_main(argv) -> int:
    """Phase 16a and 16b in a fresh process: the port's experiment runner
    (``experiments.run.main(argv)``); prints this process's launches on a
    tagged line; returns the runner's code."""
    from gtopkssgd_tpu_torch.experiments import run as runner
    from gtopkssgd_tpu_torch.ops import cuda_topk

    cuda_topk.reset_launches()
    rc = runner.main(list(argv))
    print(LAUNCHES_TAG + json.dumps(dict(cuda_topk.launches)))
    return rc


def _logged(err: str, tag: str, what: str) -> dict:
    """The JSON of the runner's one `tag` log line."""
    key = f"gtopkssgd_tpu_torch.experiments INFO: {tag}: "
    lines = [line for line in err.splitlines() if key in line]
    check(len(lines) == 1, f"{what}: {len(lines)} '{tag}:' lines")
    return json.loads(lines[0].split(key, 1)[1])


def experiments_phase() -> dict:
    """Phase 16, on the card: the experiment grid and graftlint (see the
    module docstring). Returns the launches of 16a."""
    t0 = time.perf_counter()
    code = ("import sys, chip_smoke as s; "
            "sys.exit(s.experiment_main(sys.argv[1:]))")
    procs = [(tag, _python(code, *argv)) for tag, argv in EXPERIMENT_RUNS]
    lint = _python(LINT_CODE, "gtopkssgd_tpu_torch", "chip_smoke.py")
    rc, out = _wait(lint, "16c graftlint", timeout=300.0)
    check(rc == 0, f"16c: graftlint rc {rc}\n{out[-2000:]}")
    print(f"16c: {out.strip().splitlines()[-1]}")
    done = {}
    total = {name: 0 for name in REPLACES}
    for tag, proc in procs:
        rc, out = _wait(proc, tag, timeout=600.0)
        check(rc == 0, f"{tag}: experiments.run rc {rc}")
        cfg = _logged(proc.texts[1], "config", tag)
        done[tag] = d = _logged(proc.texts[1], "done", tag)
        check(all(math.isfinite(x) for x in d["losses"])
              and math.isfinite(d["val_loss"]),
              f"{tag}: losses {d['losses']}, val_loss {d['val_loss']}")
        if tag == "16a":
            check(d["step"] == EXPERIMENT_STEPS and d["nworkers"] == 1
                  and d["dtype"] == "bfloat16" and d["dnn"] == "resnet50"
                  and d["compression"] == "gtopk" and d["density"] == 0.001
                  and d["topk_method"] == "auto", f"16a: done {d}")
            tagged = [line for line in out.splitlines()
                      if line.startswith(LAUNCHES_TAG)]
            got = json.loads(tagged[-1][len(LAUNCHES_TAG):])
            check_launches(got, {"fused_stage1_candidates":
                                 EXPERIMENT_STEPS}, "16a")
            for name, n in got.items():
                total[name] += n
        else:
            check(d["nworkers"] == 2 and d["dist_backend"] == "gloo"
                  and cfg["momentum_correction"] is True,
                  f"16b: config {cfg}, done {d}")
    a = done["16a"]
    print(f"16a imagenet_resnet50_gtopk: median step "
          f"{a['median_step_s'] * 1e3:.1f} ms, {a['throughput']:.1f} "
          f"samples/s, losses {a['losses']}; 16b losses "
          f"{done['16b']['losses']}; {_card_line()}")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return total


# Phase 17: the reference's convergence gate (tests/test_convergence.py,
# its port tests/test_torch_convergence.py) free on the card, from the
# port's seeded init: ResNet-20, batch 8 a rank on row `rank` of a fixed
# (GATE_P, 8) draw, 40 steps, lr 0.05, momentum 0.9; arms (name,
# compression, method, TrainConfig extras), dense first.
GATE_P, GATE_BATCH, GATE_STEPS, GATE_DENSITY = 4, 8, 40, 0.01
GATE_P1 = (("dense", "dense", "exact", {}),
           ("gtopk twostage", "gtopk", "twostage", {}),
           ("gtopk pallas", "gtopk", "pallas", {}))
GATE_DIST = (("dense", "dense", "exact", {}),
             ("gtopk", "gtopk", "auto", {}),
             ("allgather", "allgather", "auto", {}),
             ("gtopk_hier", "gtopk_hier", "auto", {"hier_ici": 2}),
             ("approx", "gtopk", "approx", {}),
             ("pallas", "gtopk", "pallas", {}))
GATE_DENSE_X, GATE_SPARSE_X = 0.35, 0.5  # last < x * first
GATE_FAMILY = ("gtopk", "gtopk_hier")  # also: last < dense's first
REAL_CIFAR = "tests/fixtures/cifar"  # phase 17b, from the checkout's root


def gate_inputs():
    """The gate's fixed batch, the reference's draw: X f32[GATE_P, 8, 32,
    32, 3] standard normal, Y i32[GATE_P, 8] in [0, 10), from
    ``np.random.default_rng(1)``."""
    import numpy as np

    npr = np.random.default_rng(1)
    x = npr.standard_normal((GATE_P, GATE_BATCH, 32, 32, 3)).astype(
        np.float32)
    y = npr.integers(0, 10, (GATE_P, GATE_BATCH)).astype(np.int32)
    return x, y


def gate_arm(device, compression: str, method: str, extra: dict,
             nworkers: int = 1) -> dict:
    """One arm of the gate on this rank (rank 0 alone at `nworkers` 1):
    a fresh trainer trains free on row `rank` of ``gate_inputs``, the
    train-mode forward's mean cross-entropy, backward and the optimizer's
    step, then (P > 1) one all-reduce averages the BatchNorm statistics
    and the loss. Returns the losses (the mean over the ranks), the
    launches of the steps (counters zeroed just before them) and the
    arm's seconds, set-up included."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    rank = dist.get_rank() if nworkers > 1 else 0
    x, y = gate_inputs()
    xb = torch.from_numpy(x[rank]).to(device)
    yb = torch.from_numpy(y[rank]).long().to(device)
    dense = compression == "dense"
    cfg = TrainConfig(
        dnn="resnet20", batch_size=GATE_BATCH, lr=0.05, momentum=0.9,
        weight_decay=0.0, compression=compression,
        density=1.0 if dense else GATE_DENSITY, topk_method=method,
        device=str(device), nworkers=nworkers, prefetch=0,
        obs_counters=False, obs_goodput=False, **extra)
    with Trainer(cfg) as t:
        opt = t.optimizer
        cuda_topk.reset_launches()
        losses = []
        for _ in range(GATE_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(t.model(xb), yb)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if t.group is not None:
                loss, = t._average_over_ranks([loss])
            losses.append(float(loss))
        launches = dict(cuda_topk.launches)
    return dict(losses=losses, launches=launches,
                seconds=time.perf_counter() - t0)


def gate_launches(method: str, p: int) -> dict:
    """The launches an arm's `GATE_STEPS` steps must count on each rank:
    the stage-1 kernel once a step under ``twostage`` and ``approx``, the
    multisection kernel once a step under ``pallas`` (residual mode at P =
    1, abs mode above), nothing else."""
    name = {"twostage": "fused_stage1_candidates",
            "approx": "fused_stage1_candidates",
            "pallas": ("multisection_tau_lo[residual]" if p == 1
                       else "multisection_tau_lo[abs]")}.get(method)
    return {name: GATE_STEPS} if name else {}


def gate_checks(p: int, arms, ranks, total: dict) -> None:
    """The gate's thresholds and launch counts for `arms` at P = `p`
    (`ranks`: per rank, ``gate_arm``'s result for each arm), one
    ``convergence`` line an arm; adds the launches to `total`."""
    dense_first = None
    for i, (name, compression, method, _) in enumerate(arms):
        run = f"gate P={p} {name}"
        got = [r[i] for r in ranks]
        want = gate_launches(method, p)
        for r, rec in enumerate(got):
            check_launches(rec["launches"], want, f"{run} rank {r}")
            for kernel in REPLACES:
                total[kernel] += rec["launches"][kernel]
        losses = got[0]["losses"]
        check(all(math.isfinite(v) for v in losses),
              f"{run}: non-finite loss {losses}")
        first, last = losses[0], losses[-1]
        if compression == "dense":
            dense_first = first
            check(last < GATE_DENSE_X * first,
                  f"{run}: last loss {last} >= {GATE_DENSE_X} x {first}")
        else:
            check(last < GATE_SPARSE_X * first,
                  f"{run}: last loss {last} >= {GATE_SPARSE_X} x {first}")
        if compression in GATE_FAMILY:
            check(dense_first is not None and last < dense_first,
                  f"{run}: last loss {last} >= dense's first {dense_first}")
        print("convergence " + json.dumps({
            "P": p, "arm": name, "compression": compression,
            "method": method, "steps": len(losses), "loss_first": first,
            "loss_step20": losses[20], "loss_last": last,
            "last_over_first": last / first,
            "launches": {k: v for k, v in got[0]["launches"].items() if v},
            "seconds": max(rec["seconds"] for rec in got)}))


def real_cifar_phase() -> dict:
    """Phase 17b: two ResNet-20 ``twostage`` steps at batch 8 on the real
    CIFAR-10 pickles of ``REAL_CIFAR``; the first batch to reach the card
    bitwise the CPU loader's, finite losses, two stage-1 launches."""
    import os

    import numpy as np

    from gtopkssgd_tpu_torch.data import get_dataset
    from gtopkssgd_tpu_torch.ops import cuda_topk
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            REAL_CIFAR)
    check(os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")),
          f"real cifar: no pickles under {data_dir}")
    seen = []
    with Trainer(TrainConfig(
            dnn="resnet20", batch_size=8, compression="gtopk",
            density=0.001, topk_method="twostage", data_dir=data_dir,
            device="cuda")) as t:
        check(not t.train_data.synthetic, "real cifar: loaded synthetic")
        prepare = t._prepare

        def first_batch(batch):
            if not seen:
                seen.append({key: (v.device.type, v.cpu().numpy())
                             for key, v in batch.items()})
            return prepare(batch)

        t._prepare = first_batch
        cuda_topk.reset_launches()
        losses = t.train(2)["losses"]
        launches = dict(cuda_topk.launches)
        seed = t.cfg.seed
    want = next(iter(get_dataset("cifar10", split="train", batch_size=8,
                                 data_dir=data_dir, seed=seed).epoch(0)))
    got = seen[0]
    check(set(got) == set(want), f"real cifar: batch keys {set(got)}")
    for key, (where, v) in got.items():
        check(where == "cuda", f"real cifar: {key} on {where}")
        check(v.dtype == want[key].dtype and np.array_equal(v, want[key]),
              f"real cifar: the card's first {key} batch differs from the "
              "CPU loader's")
    check(all(math.isfinite(v) for v in losses),
          f"real cifar: non-finite loss {losses}")
    check_launches(launches, {"fused_stage1_candidates": 2},
                   "real cifar twostage, 2 steps")
    print(f"real cifar: {len(t.train_data.images)} train images from "
          f"{REAL_CIFAR}, the first batch on the card bitwise the CPU "
          f"loader's (image {got['image'][1].shape} "
          f"{got['image'][1].dtype}, label {got['label'][1].tolist()}), "
          f"losses {losses}, launches {launches}")
    return launches


def gate_phase() -> dict:
    """Phase 17 in this process: 17a's arms at P = 1 (the P = 4 arms ride
    ``dist_phase``'s spawn), then 17b. Returns the launches per kernel."""
    total = {name: 0 for name in REPLACES}
    results = [gate_arm("cuda", compression, method, extra)
               for _, compression, method, extra in GATE_P1]
    gate_checks(1, GATE_P1, [results], total)
    for name, count in real_cifar_phase().items():
        total[name] += count
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
    t_start = t_lap = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        print(f"{what}: {now - t_lap:.1f} s")
        t_lap = now

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
    leaf_phase()

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

    lap("phases 1-4")
    for name, count in dist_phase(RESNET20_DIST, gates=GATE_DIST).items():
        total[name] += count
    lap("phases 5, 6c, 9c, 9d and 17a at P = 4")
    for name, count in correction_phase().items():
        total[name] += count
    codec_phase()
    lap("phases 6a-6b")
    for name, count in model_phase(ZOO_RUNS, ZOO_DIST).items():
        total[name] += count
    reference_steps(ZOO_REFERENCE)
    lap("phase 7")
    for name, count in model_phase(RECURRENT_RUNS, RECURRENT_DIST).items():
        total[name] += count
    reference_steps(RECURRENT_REFERENCE)
    lap("phase 8")
    for name, count in layerwise_phase().items():
        total[name] += count
    reference_steps(LAYERWISE_REFERENCE)
    dnn, runs, steps = LAYERWISE_DIST
    for name, count in dist_phase(runs, dnn, steps).items():
        total[name] += count
    planner_phase()
    lap("phases 9a, 9b and 9e")
    select_phase()
    for name, count in pipeline_phase().items():
        total[name] += count
    auto_phase()
    harness_phase()
    lap("phase 10")
    native_phase()
    resume_phase()
    for phase in (bf16_phase, dispatch_phase):
        for name, count in phase().items():
            total[name] += count
    lap("phase 11")
    for name, count in jpeg_phase().items():
        total[name] += count
    topk_phase()
    for name, count in resilience_phase().items():
        total[name] += count
    lap("phase 12")
    for name, count in obs_phase().items():
        total[name] += count
    k2 = kernels[K2_N]["fused_stage1_candidates"]["ms"]
    for name, count in trace_phase(k2).items():
        total[name] += count
    for name, count in planes_phase().items():
        total[name] += count
    for name, count in experiments_phase().items():
        total[name] += count
    lap("phases 13-16")
    for name, count in gate_phase().items():
        total[name] += count
    lap("phase 17 (17a at P = 1, 17b)")

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
