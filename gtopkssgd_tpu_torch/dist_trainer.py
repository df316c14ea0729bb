"""Command line of the port's trainer (the JAX package's flag names).

    python -m gtopkssgd_tpu_torch.dist_trainer \\
        --dnn resnet20|resnet56|vgg16|resnet50|alexnet|lstm|lstman4 \\
        [--dataset cifar10|imagenet|ptb|an4] [--s2d] \\
        --compression gtopk --density 0.001 --topk-method twostage \\
        [--num-iters 20] [--eval-batches B] [--nworkers P] [--device cpu] \\
        [--dist-backend gloo] [--wire-codec int8] [--momentum-correction] \\
        [--nesterov] [--clip-grad-norm C] [--warmup-epochs E] \\
        [--dense-warmup-epochs E] [--compression gtopk_hier --hier-ici S] \\
        [--compression gtopk_layerwise --buckets concat|leaf|auto|B \\
         --pipeline serial|overlap|auto] \\
        [--comm-plan auto|tree|balanced] [--comm-model-fit PATH] \\
        [--out-dir DIR [--resume] [--allow-ckpt-mismatch]] \\
        [--log-interval N] [--dtype bfloat16] [--synth-hard] \\
        [--prefetch N] [--steps-per-dispatch K] [--decode-workers W] \
        [--inject SPEC] [--no-preempt-save] [--elastic [--min-fleet N]] \
        [--multihost] [--no-obs-counters] [--obs-interval N] \
        [--obs-layers] [--obs-audit-interval N] [--obs-watchdog S] \
        [--no-obs-events] [--obs-halt-on error|warn] [--obs-timeline PATH] \
        [--obs-export-port PORT] [--recover-policy POLICY] \\
        [--no-obs-goodput] [--obs-goodput-interval N] [--obs-critpath] \\
        [--obs-calib [--obs-linkmap]] [--obs-calib-interval N] \\
        [--obs-mem [--obs-mem-interval N]] [--profile-dir DIR \\
         [--profile-steps N]] [--obs-forecast [--obs-forecast-targets L] \\
         [--obs-forecast-drift-x X]] [--registry DIR] \\
        [--evict-after-windows K]

Runs on the CUDA card unless ``--device cpu``. ``--nworkers P`` above 1
spawns P rank processes joined in one process group (0, the default:
every visible card, one rank on the CPU): NCCL with one rank
per card by default on CUDA (P cards needed), gloo on the CPU;
``--dist-backend gloo`` with ``--device cuda`` lets the ranks share the
visible cards. With ``--num-iters N`` the trainer takes N steps and then
evaluates (``Trainer.test()``, at most ``--eval-batches`` batches);
without it, ``Trainer.fit()`` trains and evaluates each of
``--max-epochs`` epochs, as the JAX CLI does. The dataset defaults to the
model's (``lstm``: PTB, ``lstman4``: AN4; synthetic unless ``--data-dir``
holds the real files), and so do lr, weight decay and the clip (PTB 1.0,
0, 0.25; AN4 3e-4, 0, 400). Rank 0 prints one JSON line with the
per-step losses, step times, the gradient bytes a rank shipped per step,
the wire plan, the buckets (their (n_b, k_b) pairs) and their execution
order, the dispatch (``graph`` or ``staged``), and the
validation metrics (``val_loss`` and ``val_top1``/``val_top5``,
``val_ppl``, or ``val_cer``/``val_wer``).

``--out-dir`` writes the metrics file (``metrics.jsonl``, or one
``metrics.rank{r}.jsonl`` a rank at P > 1) and the checkpoints
(``ckpt/``: each epoch of ``fit()``, and after ``--num-iters`` steps);
``--resume`` restores the newest checkpoint there before training.

Observability (``obs/``), on by default as in the JAX CLI: the on-device
counters, an "obs" record every ``--obs-interval`` steps (with
``--obs-layers`` a "layers" record a layer, with ``--obs-audit-interval``
the recall audit), and the anomaly monitor's "event" records;
``--obs-halt-on`` turns events into exit 44, ``--recover-policy`` maps
rules to skip, rollback or degrade (it needs the monitor: refused with
``--no-obs-events``), ``--obs-watchdog S`` exits 43 after S seconds
without progress, ``--obs-timeline`` writes the host timeline and
``--obs-export-port`` serves the metrics on localhost. The goodput ledger
is on by default too: a "goodput" record every ``--obs-goodput-interval``
steps and at the end. The trace planes are opt-in: every
``--obs-calib-interval`` steps one dispatch is profiled with
``torch.profiler`` and attributed ("attr"; at P > 1 a "ledger" row), with
``--obs-critpath`` into a "critpath" record, with ``--obs-calib`` (P > 1,
counters on) into the live comm-model fit ("calib", and
``calib_fit_{P}proc.json`` in the out dir) and with ``--obs-linkmap``
into the link weather map ("linkmap"); ``--obs-mem`` writes "compile" and
"mem" records. With ``--obs-forecast`` each capture also writes a
"forecast" record (the hindcast error and the forecast at
``--obs-forecast-targets``). ``--profile-dir DIR`` writes a Chrome trace a
rank, ``DIR/rank{r}.trace.json``, of ``--profile-steps`` steps (whole
dispatches) after one warm-up dispatch, before the run's own steps.
``--registry DIR`` appends the run's summary line to ``DIR/runs.jsonl`` as
it exits. Under ``--elastic`` rank 0 merges the ranks' shards every
``--evict-after-windows`` goodput windows and may evict a rank (exit 46).
``python -m gtopkssgd_tpu_torch.obs.report`` reads all of it.

Exit codes (``exit_codes.py``): 0 done; 43 stalled (the watchdog; at
P > 1 one rank's ends the command, the others stopped); 44 an anomaly
halt (``--obs-halt-on``, or a recovery budget spent); 45 preempted (a
SIGTERM or SIGINT under ``--preempt-save``, the default: the step is
saved, then relaunch the same command with ``--resume``); 46 an elastic
resize (``--elastic``: saved, ``elastic.json`` rewritten; relaunch with
``--resume --elastic --nworkers NEWP``). At P > 1 every rank returns its
code and the command returns it only when all agree. The summary line
is printed only on 0. ``--multihost``: this process is one rank of a job
launched from outside, its rank, world size and local rank in ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous in ``MASTER_ADDR`` and
``MASTER_PORT``; nothing is spawned, and rank 0 prints the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import statistics
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.data.imagenet import prefork_decode_pool
from gtopkssgd_tpu_torch.exit_codes import (
    EXIT_ERROR,
    EXIT_OK,
    EXIT_RESIZE_RESTART,
    EXIT_STALL,
    describe,
)
from gtopkssgd_tpu_torch.obs import trace_attr
from gtopkssgd_tpu_torch.obs.events import HALT_EXIT_CODE, AnomalyHalt
from gtopkssgd_tpu_torch.ops.topk import METHODS
from gtopkssgd_tpu_torch.parallel import collectives
from gtopkssgd_tpu_torch.parallel.dist import (
    BACKENDS,
    RankExited,
    default_backend,
    init_from_env,
    rank_device,
    spawn,
)
from gtopkssgd_tpu_torch.resilience import (
    PREEMPT_EXIT_CODE,
    Preempted,
    PreemptionGuard,
    ResizeRestart,
    describe_policy,
)
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dnn", default="resnet20")
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-worker batch size")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--compression", default=None,
                   choices=["none", "dense", "gtopk", "allgather", "topk",
                            "gtopk_hier", "gtopk_layerwise"],
                   help="None/dense = all-reduce baseline; gtopk = tree "
                        "sparse all-reduce; allgather/topk = the Top-k "
                        "union of every rank's picks; gtopk_layerwise = "
                        "per-layer top-k and error feedback; gtopk_hier = "
                        "dense within a slice of ranks, gtopk across "
                        "slices (set --hier-ici)")
    p.add_argument("--density", type=float, default=0.001)
    p.add_argument("--hier-ici", type=int, default=1,
                   help="gtopk_hier: ranks per slice (dense sum within "
                        "each contiguous block of this many ranks, gTop-k "
                        "hypercube across the nworkers/hier_ici slices)")
    p.add_argument("--topk-method", default="auto", choices=list(METHODS),
                   help="auto (exact up to 2^20 elements, twostage above: "
                        "ops.topk.AUTO_SWITCH) | exact | blockwise (exact, "
                        "rows of 65,536 then a reselect) | approx (the "
                        "twostage path) | threshold | pallas | twostage | "
                        "simrecall (exact with 5%% of the top k dropped "
                        "deterministically)")
    p.add_argument("--wire-codec", default="fp32",
                   help="on-wire sparse-set codec: fp32 (identity), "
                        "int8[:BLOCK] or fp8[:BLOCK] (block-scaled values, "
                        "bf16 scales, Elias-Fano indices; BLOCK defaults "
                        "to 64); the quantization error folds into the "
                        "error-feedback residual")
    p.add_argument("--comm-plan", default="auto",
                   help="wire-plan pin (parallel.planner). 'auto' "
                        "(default) scores every schedule that realizes "
                        "--compression with the alpha-beta model and "
                        "keeps the historical schedule on ties; a plan "
                        "name pins it: tree | balanced (Ok-Topk "
                        "split-and-reduce) for gtopk/gtopk_layerwise, "
                        "allgather / hier / dense for their modes. Rank 0 "
                        "prints the decision as a 'plan' line")
    p.add_argument("--buckets", default="concat",
                   help="gtopk_layerwise only: gradient bucketing "
                        "(parallel.bucketing). 'concat' (default): "
                        "per-leaf selection, one concatenated merge; "
                        "'leaf': one merge per parameter leaf; an int B "
                        "or 'auto': contiguous byte-balanced buckets by "
                        "an exact alpha-beta DP ('auto' picks B), one "
                        "selection and one merge per bucket")
    p.add_argument("--pipeline", default="serial",
                   help="bucketed gtopk_layerwise: bucket execution order. "
                        "'serial' (default): bucket b+1 selects after "
                        "bucket b's merge; 'overlap': bucket b+1 selects "
                        "(on a side CUDA stream) while bucket b merges (on "
                        "the optimizer's merge thread), bitwise the same "
                        "result; 'auto': the order with the smaller "
                        "modeled span (the bucket DP priced under both)")
    p.add_argument("--comm-model-fit", default=None, metavar="PATH",
                   help="alpha/beta fit file (alpha_beta_fit grammar, as "
                        "comm_probe writes it) pricing the planner and the "
                        "bucket DP instead of the port's committed fit for "
                        "the run's backend (gloo or nccl)")
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--nsteps-update", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=140)
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="linear LR ramp over the first N epochs")
    p.add_argument("--dense-warmup-epochs", type=int, default=0,
                   help="sparse modes: communicate dense for the first N "
                        "epochs before enabling top-k")
    p.add_argument("--momentum-correction", action="store_true",
                   help="sparse modes: DGC momentum correction and factor "
                        "masking (the velocity accumulates before "
                        "selection)")
    p.add_argument("--nworkers", type=int, default=0,
                   help="ranks; 0 = every visible card (one on the CPU)")
    p.add_argument("--dist-backend", default=None, choices=BACKENDS,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--s2d", action="store_true",
                   help="resnet50: space-to-depth stem (4x4x12 conv on 2x2 "
                        "pixel blocks)")
    p.add_argument("--num-iters", type=int, default=None,
                   help="train a fixed number of steps instead of epochs")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap on the validation batches (default: all)")
    p.add_argument("--out-dir", default=None,
                   help="metrics files and checkpoints (out-dir/ckpt)")
    p.add_argument("--log-interval", type=int, default=50,
                   help="a 'train' metrics record every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from out-dir")
    p.add_argument("--allow-ckpt-mismatch", action="store_true",
                   help="restore a checkpoint whose recorded config hash or "
                        "state digest differs from this run's (normally "
                        "refused: resuming under other flags changes the "
                        "experiment)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (parameters, gradients and the "
                        "optimizer stay float32)")
    p.add_argument("--synth-hard", action="store_true",
                   help="synthetic CIFAR only: the harder variant (weak "
                        "spatial class patterns, 10%% of the train labels "
                        "resampled)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host batches assembled ahead by a background "
                        "thread (0 = synchronous assembly)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps a dispatch: K host batches staged "
                        "in one transfer and one sync; on the card at P = "
                        "1 a CUDA graph of the step replayed K times "
                        "(Trainer.dispatch_rule)")
    p.add_argument("--decode-workers", type=int, default=0,
                   help="ImageNet JPEG path: decode worker processes (a "
                        "pool forked once a rank process)")
    p.add_argument("--obs-counters", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on-device compression/comm counters logged as "
                        "'obs' records (--no-obs-counters leaves them out "
                        "of the step)")
    p.add_argument("--obs-interval", type=int, default=1,
                   help="an 'obs' record every N optimizer steps")
    p.add_argument("--obs-layers", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="per-layer counters (obs.counters.LAYER_FIELDS), "
                        "one 'layers' record a layer an obs step")
    p.add_argument("--obs-audit-interval", type=int, default=0,
                   help="every N optimizer steps, the recall of the "
                        "selection against the exact top-k of the "
                        "accumulator (the 'obs' record's audit_recall, -1 "
                        "before the first); 0 disables")
    p.add_argument("--obs-watchdog", type=float, default=0.0,
                   help="seconds a dispatch may go without a completed "
                        "read before the stall watchdog logs a 'stall' "
                        "record and exits 43 (0 = off)")
    p.add_argument("--obs-events", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the anomaly monitor (obs.events): NaN/Inf loss, "
                        "loss spike, density collapse, residual blow-up "
                        "and age runaway as 'event' records")
    p.add_argument("--obs-halt-on", default=None, choices=["error", "warn"],
                   help="exit 44 when an event of at least this severity "
                        "fires (its record is fsynced first)")
    p.add_argument("--obs-timeline", default=None, metavar="PATH",
                   help="write the host timeline (Tracer spans, counter "
                        "tracks, event and stall markers) as Chrome-trace "
                        "JSON here on exit (a directory gets "
                        "timeline.json)")
    p.add_argument("--obs-export-port", type=int, default=0,
                   help="serve the latest metric values as OpenMetrics "
                        "text on this localhost port (curl "
                        "localhost:PORT/metrics; rank r of --nworkers P "
                        "on PORT + r); -1 an ephemeral port, 0 off")
    p.add_argument("--obs-goodput", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the goodput ledger (obs.goodput): the run's wall "
                        "split into goodput and the badput taxonomy "
                        "(select, comm, wait, compile, ckpt, wasted, "
                        "degraded, data, startup) with the remainder as "
                        "other_frac; cumulative 'goodput' records and an "
                        "end-of-run summary. Host arithmetic only: on by "
                        "default")
    p.add_argument("--obs-goodput-interval", type=int, default=50,
                   help="optimizer steps between 'goodput' records (<= 0 "
                        "keeps only the end-of-run summary); each feeds "
                        "the goodput_collapse rule")
    p.add_argument("--obs-goodput-collapse-windows", type=int, default=3,
                   help="consecutive 'goodput' records with goodput_frac "
                        "below half its EWMA before goodput_collapse fires")
    p.add_argument("--obs-calib", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="live comm-model calibration (obs.calib): every "
                        "--obs-calib-interval steps, profile one dispatch "
                        "and feed its (wire bytes, comm time) to a robust "
                        "alpha/beta fit; 'calib' records, the "
                        "comm_model_drift rule against the planner's "
                        "fit, and calib_fit_{P}proc.json in out-dir at "
                        "the end. Needs the counters and --nworkers > 1; "
                        "each sample costs a profiler capture and a sync")
    p.add_argument("--obs-calib-interval", type=int, default=25,
                   help="optimizer steps between profiled dispatches "
                        "(shared by --obs-calib and --obs-critpath)")
    p.add_argument("--obs-critpath",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="per-step stage records (obs.critpath): every "
                        "--obs-calib-interval steps, profile one dispatch "
                        "into ordered {stage, t0, t1} segments, the comm "
                        "span split into wire and wait by the alpha-beta "
                        "model; a durable 'critpath' record (and its "
                        "'attr' split). Each costs a profiler capture")
    p.add_argument("--obs-critpath-shift-windows", type=int, default=3,
                   help="consecutive captures whose critical stage leaves "
                        "the modal one before critpath_shift fires")
    p.add_argument("--obs-mem", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="compile and memory watch (obs.memwatch): a "
                        "'compile' record for each new batch shape's first "
                        "step (seconds, FLOPs, allocator peak), recompiles "
                        "(new shapes, unexpected graph captures; the "
                        "recompile_storm rule), and 'mem' records from the "
                        "CUDA caching allocator feeding device_mem_leak "
                        "and hbm_headroom")
    p.add_argument("--obs-mem-interval", type=int, default=50,
                   help="optimizer steps between 'mem' records")
    p.add_argument("--obs-recompile-warmup", type=int, default=1,
                   help="compile-watch polls before recompile_storm arms "
                        "(0 fires on any growth)")
    p.add_argument("--obs-mem-leak-windows", type=int, default=3,
                   help="consecutive growing live-memory windows before "
                        "device_mem_leak fires")
    p.add_argument("--obs-hbm-headroom-frac", type=float, default=0.92,
                   help="reserved over total device memory above which "
                        "hbm_headroom fires (the CPU never trips it)")
    p.add_argument("--obs-linkmap", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="per-(link class, peer) weather map (obs.linkmap): "
                        "each calibration capture's comm span carved over "
                        "the schedule's rounds into per-link EWMA latency "
                        "and bandwidth, a durable 'linkmap' record, the "
                        "link_degraded rule. Rides --obs-calib")
    p.add_argument("--obs-link-degraded-x", type=float, default=4.0,
                   help="a link's EWMA latency above this multiple of the "
                        "median counts as a degraded window")
    p.add_argument("--obs-link-degraded-windows", type=int, default=3,
                   help="consecutive degraded windows before "
                        "link_degraded fires")
    p.add_argument("--obs-forecast",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="scale-out forecast (obs.forecast): at each "
                        "calibration capture, hindcast this run's step "
                        "time from its comm fit and measured budgets, and "
                        "forecast step time and goodput at the P targets "
                        "over the wire schedules and axis trees; one "
                        "durable 'forecast' record a capture, feeding "
                        "forecast_drift. Rides --obs-calib (and needs "
                        "--obs-critpath's budgets); read with 'report "
                        "forecast'")
    p.add_argument("--obs-forecast-targets", default="32,256,1024",
                   metavar="LIST",
                   help="comma-separated modeled worker counts the "
                        "forecast grid prices")
    p.add_argument("--obs-forecast-drift-x", type=float, default=4.0,
                   help="hindcast error factor beyond which a capture "
                        "counts as drifted; 3 consecutive drifted "
                        "captures fire forecast_drift (honors "
                        "--obs-halt-on)")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="append this run's summary line (manifest subset, "
                        "steps/sec, comm ratio, fitted alpha/beta, recall "
                        "floor, wire bytes/step, goodput, forecast) to "
                        "DIR/runs.jsonl on exit (obs.registry, rank 0); "
                        "read with 'report history DIR' and 'report "
                        "regress OUT_DIR --registry DIR'")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace (one "
                        "rank{r}.trace.json a rank; obs.trace_attr reads "
                        "it) of --profile-steps steps after one warm-up "
                        "dispatch, before the run's own steps")
    p.add_argument("--profile-steps", type=int, default=10)
    p.add_argument("--inject", default=None, metavar="SPEC",
                   help="step-keyed fault injection (resilience/inject.py "
                        "grammar KIND[:ARG...]@STEP|A-B|latest, comma-"
                        "separated): nan_grad@K, slow_rank:R:DURs@A-B, "
                        "loader_raise@K, preempt@K, corrupt_ckpt@latest, "
                        "reshape@K, resize@K:NEWP, evict_rank:R@K")
    p.add_argument("--recover-policy", default=None, metavar="POLICY",
                   help="map anomaly rules to recovery actions instead of "
                        "exit 44 (grammar rule=action[:budget[:param]], "
                        "comma-separated; actions skip, rollback, degrade), "
                        "e.g. 'nan_loss=skip'; needs --obs-events")
    p.add_argument("--elastic", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="elastic fleet: a preemption or an injected resize "
                        "drains, saves, rewrites out-dir/elastic.json and "
                        "exits 46; relaunch with --resume --elastic at the "
                        "new --nworkers and the residual is re-partitioned "
                        "(both sides of a resize need this flag)")
    p.add_argument("--evict-after-windows", type=int, default=3,
                   help="elastic: rank 0 checks the merged per-rank "
                        "goodput/straggler view every this-many "
                        "--obs-goodput-interval windows and evicts the "
                        "rank eviction_decision names (exit 46 on every "
                        "rank; 0 disables the check; an injected "
                        "evict_rank:R@K still works)")
    p.add_argument("--min-fleet", type=int, default=1,
                   help="elastic: never resize below this many ranks (a "
                        "preemption that would falls back to exit 45)")
    p.add_argument("--preempt-save", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="intercept SIGTERM/SIGINT: save the step at the "
                        "next dispatch boundary, then exit 45 (resume with "
                        "--resume); --no-preempt-save keeps the default "
                        "signal disposition")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of an externally launched job: "
                        "init_process_group from RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR and MASTER_PORT; spawns "
                        "nothing")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, compression=args.compression,
        density=args.density, topk_method=args.topk_method,
        wire_codec=args.wire_codec, clip_grad_norm=args.clip_grad_norm,
        hier_ici=args.hier_ici, comm_plan=args.comm_plan,
        buckets=args.buckets, pipeline=args.pipeline,
        comm_model_fit=args.comm_model_fit,
        nsteps_update=args.nsteps_update, max_epochs=args.max_epochs,
        warmup_epochs=args.warmup_epochs,
        dense_warmup_epochs=args.dense_warmup_epochs,
        momentum_correction=args.momentum_correction,
        space_to_depth=args.s2d, eval_batches=args.eval_batches,
        nworkers=args.nworkers, data_dir=args.data_dir, seed=args.seed,
        out_dir=args.out_dir, log_interval=args.log_interval,
        resume=args.resume, allow_ckpt_mismatch=args.allow_ckpt_mismatch,
        dtype=args.dtype, synth_hard=args.synth_hard,
        prefetch=args.prefetch, steps_per_dispatch=args.steps_per_dispatch,
        decode_workers=args.decode_workers, inject=args.inject,
        elastic=args.elastic, min_fleet=args.min_fleet,
        obs_counters=args.obs_counters, obs_interval=args.obs_interval,
        obs_layers=args.obs_layers,
        obs_audit_interval=args.obs_audit_interval,
        obs_watchdog=args.obs_watchdog, obs_events=args.obs_events,
        obs_halt_on=args.obs_halt_on, obs_timeline=args.obs_timeline,
        obs_export_port=args.obs_export_port,
        recover_policy=args.recover_policy,
        obs_goodput=args.obs_goodput,
        obs_goodput_interval=args.obs_goodput_interval,
        obs_goodput_collapse_windows=args.obs_goodput_collapse_windows,
        obs_calib=args.obs_calib, obs_calib_interval=args.obs_calib_interval,
        obs_critpath=args.obs_critpath,
        obs_critpath_shift_windows=args.obs_critpath_shift_windows,
        obs_mem=args.obs_mem, obs_mem_interval=args.obs_mem_interval,
        obs_recompile_warmup=args.obs_recompile_warmup,
        obs_mem_leak_windows=args.obs_mem_leak_windows,
        obs_hbm_headroom_frac=args.obs_hbm_headroom_frac,
        obs_linkmap=args.obs_linkmap,
        obs_link_degraded_x=args.obs_link_degraded_x,
        obs_link_degraded_windows=args.obs_link_degraded_windows,
        obs_forecast=args.obs_forecast,
        obs_forecast_targets=args.obs_forecast_targets,
        obs_forecast_drift_x=args.obs_forecast_drift_x,
        registry=args.registry,
        evict_after_windows=args.evict_after_windows,
        device=args.device)


def profile(trainer: Trainer, profile_dir: str, steps: int) -> int:
    """The JAX CLI's ``--profile-dir``: one warm-up dispatch (the
    compile stays out of the trace), then `steps` rounded up to whole
    dispatches under ``obs.trace_attr.capture``, written to
    ``profile_dir/rank{r}.trace.json``. Returns the steps traced."""
    k = trainer.cfg.steps_per_dispatch
    traced = max(k, -(-steps // k) * k)
    trainer.train(k)
    with trace_attr.capture(profile_dir, trainer.rank):
        trainer.train(traced)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    trainer.logger.info("profiler: %d-step trace -> %s", traced,
                        profile_dir)
    return traced


def run(cfg: TrainConfig, num_iters: Optional[int],
        preempt_save: bool = False, profile_dir: Optional[str] = None,
        profile_steps: int = 10) -> dict:
    """On this process (one rank): with `profile_dir`, the profiled steps
    (``profile``) first; then train `num_iters` steps and evaluate, or
    ``fit()`` when `num_iters` is None; summarize. ``rc`` is the exit
    code: 0, or 44 (an anomaly halt), 45 (preempted) or 46 (resized), and
    then the summary holds only it, the step and the rank. `preempt_save`
    installs a ``PreemptionGuard`` for the run."""
    guard = None
    with Trainer(cfg) as trainer:
        if preempt_save:
            guard = PreemptionGuard(logger=trainer.logger).install()
            trainer.preempt = guard
        collectives.reset_wire()
        start = trainer.step
        try:
            if profile_dir:
                profile(trainer, profile_dir, profile_steps)
            if num_iters is not None:
                stats = {**trainer.train(num_iters), **trainer.test()}
                trainer.save()
            else:
                stats = trainer.fit()
            trainer.finalize_resilience("completed")
        except AnomalyHalt as halt:
            # The monitor fsynced the event record before raising.
            trainer.logger.error("anomaly halt: %s", halt)
            trainer.finalize_resilience("halted")
            return {"rc": HALT_EXIT_CODE, "step": trainer.step,
                    "rank": trainer.rank}
        except (Preempted, ResizeRestart) as why:
            status = "preempted" if isinstance(why, Preempted) else "resized"
            trainer.logger.warning("%s: %s", status, why)
            trainer.finalize_resilience(status)
            return {"rc": PREEMPT_EXIT_CODE if status == "preempted"
                    else EXIT_RESIZE_RESTART, "step": trainer.step,
                    "rank": trainer.rank}
        finally:
            if guard is not None:
                guard.close()
    return {
        "rc": EXIT_OK,
        "dnn": trainer.cfg.dnn,
        "compression": trainer.cfg.compression,
        "density": trainer.cfg.density,
        "topk_method": trainer.cfg.topk_method,
        "wire_codec": trainer.cfg.wire_codec,
        "comm_plan": (None if trainer.plan_decision is None
                      else trainer.plan_decision.plan.name),
        "buckets": (None if trainer.bucket_plan is None
                    else list(trainer.bucket_plan.pairs())),
        "pipeline": (None if trainer.bucket_plan is None
                     else trainer.bucket_plan.pipeline),
        "device": str(trainer.device),
        "dtype": trainer.cfg.dtype,
        "dispatch": trainer.dispatch,
        "step": trainer.step,
        "nworkers": trainer.cfg.nworkers,
        "num_params": trainer.num_params,
        "losses": stats["losses"],
        "median_step_s": statistics.median(stats["step_times"]),
        "throughput": stats["throughput"],
        "wire_bytes_per_step": collectives.wire["bytes"] / max(
            1, trainer.step - start),
        **{key: stats[key] for key in stats if key.startswith("val_")},
    }


def _rank_run(device, cfg: TrainConfig, num_iters: Optional[int],
              preempt_save: bool, profile_dir: Optional[str] = None,
              profile_steps: int = 10) -> dict:
    return run(dataclasses.replace(cfg, device=str(device)), num_iters,
               preempt_save, profile_dir, profile_steps)


def decode_pool_size(cfg: TrainConfig) -> int:
    """The decode pool a rank process of `cfg` forks: ``decode_workers``
    on the ImageNet JPEG path, else 0."""
    cfg = cfg.resolved()
    jpeg = (cfg.dataset == "imagenet" and cfg.data_dir is not None
            and os.path.isdir(os.path.join(cfg.data_dir, "train")))
    return cfg.decode_workers if jpeg else 0


def resolve_nworkers(args: argparse.Namespace) -> int:
    """``--nworkers``, 0 read as every visible card (``--device cuda``) or
    one rank (the CPU); under ``--multihost``, ``WORLD_SIZE``."""
    if args.multihost:
        world = int(os.environ.get("WORLD_SIZE", "0"))
        if args.nworkers not in (0, world):
            raise SystemExit(f"--multihost: --nworkers {args.nworkers} != "
                             f"WORLD_SIZE {world}")
        return world
    if args.nworkers:
        return args.nworkers
    if torch.device(args.device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def _finish(outs: list) -> int:
    """The ranks' common exit code; EXIT_ERROR when they disagree."""
    codes = sorted({o["rc"] for o in outs})
    if len(codes) > 1:
        logging.getLogger(__name__).error(
            "ranks disagree on the exit code: %s", [
                (o.get("rank"), o["rc"]) for o in outs])
        return EXIT_ERROR
    if codes[0] != EXIT_OK:
        logging.getLogger(__name__).warning("exit %d: %s", codes[0],
                                            describe(codes[0]))
    return codes[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    args.nworkers = resolve_nworkers(args)
    cfg = config_from_args(args)
    cfg.resolved()  # refuse a bad config before spawning ranks
    if args.recover_policy:
        # The policy is part of the run's identity: print it where the
        # operator finds it (stderr: stdout ends in the summary line).
        print(f"[dist] recovery policy: "
              f"{describe_policy(args.recover_policy)}", file=sys.stderr,
              flush=True)
    pool = decode_pool_size(cfg)
    if args.multihost:
        backend = args.dist_backend or default_backend(args.device)
        release = prefork_decode_pool(pool)  # before the group's threads
        try:
            rank, world, device = init_from_env(backend, args.device)
            try:
                out = run(dataclasses.replace(cfg, device=str(device)),
                          args.num_iters, args.preempt_save,
                          args.profile_dir, args.profile_steps)
                codes = [None] * world
                dist.all_gather_object(codes, out["rc"])
            finally:
                dist.destroy_process_group()
        finally:
            release()
        rc = _finish([{"rc": c, "rank": r} for r, c in enumerate(codes)])
        if rc == EXIT_OK and rank == 0:
            out["dist_backend"] = backend
            print(json.dumps(out))
        return rc
    if args.nworkers > 1:
        backend = args.dist_backend or default_backend(args.device)
        try:
            rank_device(0, args.nworkers, backend, args.device)
        except ValueError as e:
            raise SystemExit(f"--nworkers {args.nworkers}: {e}") from None
        try:
            outs = spawn(_rank_run, args.nworkers, cfg, args.num_iters,
                         args.preempt_save, args.profile_dir,
                         args.profile_steps, backend=backend,
                         device=args.device,
                         setup=functools.partial(prefork_decode_pool, pool),
                         forward_signals=args.preempt_save)
        except RankExited as e:
            if e.code != EXIT_STALL:
                raise
            # A rank's watchdog ended it (its "stall" record is in its
            # metrics shard); the others were stopped.
            logging.getLogger(__name__).error("%s: %s", e,
                                              describe(e.code))
            return EXIT_STALL
        out = outs[0]
        out["dist_backend"] = backend
    else:
        outs = [run(cfg, args.num_iters, args.preempt_save,
                    args.profile_dir, args.profile_steps)]
        out = outs[0]
    rc = _finish(outs)
    if rc == EXIT_OK:
        print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
