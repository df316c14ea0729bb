"""The trainer: the port of ``gtopkssgd_tpu.trainer`` for P data-parallel
ranks, one process each.

``TrainConfig`` keeps the JAX trainer's flag names and per-dataset defaults
(``dataset_defaults``); ``Trainer.train(n)`` runs n optimizer steps of the
model on its dataset through ``optimizer.GTopKSGD``, with
``nsteps_update`` micro-batches accumulated per step, the dataset's
schedule (cifar10: lr x0.1 at 50% and 75% of ``max_epochs``; imagenet:
x0.1 at epochs 30, 60 and 80; ptb: x0.8 an epoch from epoch 6 on; an4:
x(1/1.01) an epoch) behind an optional linear ramp over
``warmup_epochs``, and ``dense_warmup_epochs`` of dense exchange before
the sparse one. ``Trainer.test()`` evaluates on the test split (vision:
loss, top-1, top-5; ptb: loss and perplexity; an4: loss and the greedy
decode's CER and WER) and ``Trainer.fit()`` trains and evaluates epoch by
epoch. Vision batches cross to the device as uint8 NHWC and are
normalized there; PTB tokens cross as int64 indices, AN4 spectrograms,
labels and lengths as they are. Float32 throughout: TF32 is switched off
for convolutions, matrix products and cuDNN's LSTM, as the JAX model
computes in float32. Dropout draws its masks from a generator on the
device, seeded from the seed and the rank.

The language models (``ModelSpec.lm``, ``kind`` "lm"): the model is
built from ``model_config``, the published keys and the cut (a JSON
file's path, or a dict), and reads seeded token sequences (the
``tokens`` dataset at the configuration's ``seq_len`` and
``vocab_size``); the loss is the mean next-token cross-entropy over the
B x S tokens plus the model's sequence balance loss. After each step the
model moves its experts' selection biases (``update_routing``, inside the
step, so a graph holds it) and the step also reports its routing counts
(``pair_count``, ``load_ratio``, ``drop_count``), read in the dispatch's
one copy to the host and noted in the tracer (``obs.tracing.routing``,
the "spans" keys ``routing/*``).

The recurrent models (``ModelSpec.recurrent``): the PTB LSTM's loss is
the mean cross-entropy over the B x T tokens of a window, and its carry
(one (c, h) pair per layer, ``self.carry``) crosses consecutive windows,
the micro-batches of a step included, detached between them, and is
zeroed at each epoch of ``fit()`` (``reset_carry``); each rank carries
its own rows. The AN4 model's loss is ``ctc.ctc_loss`` over the frames
each utterance keeps after the convolutions.

At ``nworkers`` P > 1 the trainer is one rank of an initialized process
group of P ranks (``parallel.dist``): every rank builds the same initial
weights from the seed, draws its own shard of the data, and after each
step the ranks average the BatchNorm running statistics (if the model has
any) and the reported loss (and top-1), as the JAX trainer's ``pmean``
does. The optimizer decides the wire plan once (``plan_decision``; the
layer-wise ``bucket_plan`` with it), and rank 0 prints the decision's
record as one ``plan {...}`` line: the buckets' resolved execution order
(``pipeline``) and the chosen plan's modeled spans under either order
(``span_serial_ms``, ``span_overlap_ms``) beside every candidate's.

A dispatch is ``obs.tracing.Tracer`` spans, each a profiler range
(``torch.profiler.record_function``, and NVTX on the card) under its own
name and a host timing under its nested path: "data" (the host batches
and the issue of their copy to the device), "dispatch" holding each
step's "forward_backward" and "optimizer" (compression, the gradient
exchange and SGD), and "obs_read" (the one read of the counters);
``profile_step`` reads the ranges by name, and the span means go out as
a "spans" record every ``log_interval`` steps. On the card the tracer
also marks the device's clock three times a dispatch: "data" as staging
opens, "first" just before the first host-to-device copy, "end" after
the last device work before the read. At the read, after its sync, the
gap between the previous dispatch's "end" and this one's "first" is
split into the device's idle while the host staged ("data") and while it
finished the previous dispatch and returned to the caller ("tail"),
seconds a step, into the record ``obs.tracing.idle`` (the last 512
dispatches, emptied when a ``Trainer`` is built) and the "spans" keys
``device_idle/data`` and ``device_idle/tail``. Where a dispatch came
staged from the ring (below), the "spans" record also carries
``staging/ring_share`` and ``staging/wait``, and ``stage_stats`` keeps
the same counts since construction.

The lifecycle and the host path (the JAX trainer's):

* ``dtype="bfloat16"``: the model computes in bfloat16 with flax's
  ``dtype=`` semantics (``models.layers``); parameters, gradients, the
  selection, the wire and the optimizer stay float32.
* Host batches come from the stream ``_set_iters(epoch, skip_steps)``
  builds (epoch by epoch, fast-forwarded to a restored step mid-epoch
  too). With ``prefetch`` > 0 a background thread (``utils.prefetch``)
  takes one dispatch's K x ``nsteps_update`` micro-batches at a time, in
  order, at least ``prefetch`` ahead. On the card, with no injector, it
  copies them once into a reused ring of pinned host buffers, one slot a
  dispatch (``utils.staging``), and the main thread only issues the
  slot's copies to the card without blocking, and hands it back with an
  event the thread waits for before it writes the slot again. It falls
  back to the plain micro-batches, which the main thread stacks and
  pins, where the fields change shape or dtype (AN4's lengths), with an
  injector (its reshape acts at the consumer), on the CPU and with
  ``prefetch=0``: the same stream either way.
* ``out_dir``: JSON-lines metrics (``utils.metrics``; one file a rank at
  P > 1), the run manifest first (``utils.manifest``: the config hash,
  torch and CUDA, the card and its power limit, the backend, the world
  size, which data-prep path runs and which dispatch), then ``plan`` and
  ``bucket`` where there are any, ``train`` every ``log_interval`` steps,
  ``eval`` and ``epoch``; and checkpoints in ``out_dir/ckpt``
  (``utils.checkpoint``): ``save()`` writes each rank's whole state,
  ``restore()`` (``resume=True`` at construction) reads it back, checks
  it against the config, and fast-forwards the data stream; ``fit()``
  resumes from the restored epoch and saves after each epoch.
* ``steps_per_dispatch`` K > 1: each dispatch stages K steps' host
  batches (grouped and copied into a ring slot on the prefetch thread,
  above), copies them to the card in one transfer per field, runs the K
  steps and syncs once; ``train(n)`` needs n to be a multiple of K, and
  the steps are those of K = 1, step for step. How a dispatch runs the
  steps (``dispatch``) is decided at construction by a stated rule
  (``dispatch_rule``): on the card at P = 1 with ``dense``, ``gtopk`` or
  ``gtopk_layerwise`` under the ``serial`` pipeline, a selection method
  of ``auto``, ``exact``, ``twostage`` or ``pallas``, and a model whose
  loss reads no lengths back to the host (not AN4's CTC), one step is
  captured in a ``torch.cuda.CUDAGraph`` and replayed ("graph");
  everywhere else the steps run one after another ("staged"). See
  ``_graph_step`` for what the graph holds and when a step runs eagerly.
* The datasets are built first, before the model reaches the card and
  before the prefetch thread starts: the ImageNet JPEG path's decode
  pool (``decode_workers``) forks when its dataset is built.

Observability (``obs/``), the JAX trainer's anomaly core:

* ``obs_counters`` (default on): the optimizer computes the counters of
  ``obs.counters`` inside the step (``GTopKSGD(telemetry=True)``); every
  ``obs_interval`` steps (a dispatch that crosses a multiple) one "obs"
  record of the dispatch's last step, read in the same one device-to-host
  copy as the losses; with ``obs_layers`` one "layers" record a layer
  (``layer_names``), with ``obs_audit_interval`` the recall audit.
* ``obs_events`` (default on): an ``AnomalyMonitor`` fed those reads (the
  loss alone at ``log_interval`` when the counters are off): "event"
  records; ``obs_halt_on`` raises ``AnomalyHalt`` (exit 44).
* ``obs_watchdog`` seconds: a ``StallWatchdog`` armed over ``train()``,
  heartbeat after each dispatch's read; a stall logs a "stall" record and
  the run's summary and exits 43.
* ``obs_timeline``: the host timeline (rank 0), written on exit;
  ``obs_export_port``: the metrics as OpenMetrics text on localhost.
* ``obs_goodput`` (default on): the goodput ledger (``obs.goodput``),
  marked where the work happens -- startup, the kernels' load and each
  new batch shape's first step and graph capture as compile, "data",
  the dispatch and its reads as step time (split by the latest critpath
  shares), checkpoints, a skip's or rollback's wasted step, the degraded
  excess, evaluation as goodput, host-side attribution as other -- and a
  "goodput" record every ``obs_goodput_interval`` steps and on exit.
* Every ``obs_calib_interval`` steps (with ``obs_critpath``, or the
  calibrator) one dispatch runs under ``obs.trace_attr.capture`` and is
  attributed: an "attr" record, at P > 1 a "ledger" row, a "critpath"
  record, the calibrator's sample (``obs_calib``: P > 1, counters on;
  its ``calib_fit_{P}proc.json`` written on exit) and the link map's
  (``obs_linkmap``), and with ``obs_forecast`` (riding the calibrator)
  one durable "forecast" record (``obs.forecast``: the hindcast and the
  per-P forecast). ``obs_mem``: "compile" and "mem" records
  (``obs.memwatch``). Each feeds its monitor rule.
* ``registry``: rank 0 appends the run's summary line to
  ``registry/runs.jsonl`` as the run ends (``obs.registry``), whatever
  its exit.

Resilience (``resilience/``), the JAX trainer's:

* ``inject``: step-keyed faults (``resilience.inject``), fired at the
  dispatch boundaries; the host fetch runs under ``retry_call`` then.
* A ``PreemptionGuard`` the command line assigns to ``self.preempt``:
  at each dispatch boundary a triggered guard saves the step and raises
  ``Preempted`` (exit 45). At P > 1 the ranks agree first: one
  all-reduce of one int a dispatch (``_stop_requested``), made only
  when a guard, an injector or ``elastic`` is there, so every rank stops
  at the same step.
* ``elastic``: a resize (an agreed preemption, to P - 1 unless below
  ``min_fleet``; an injected ``resize@K:NEWP``) saves, rewrites
  ``elastic.json`` and raises ``ResizeRestart`` (exit 46); a restore at
  another P re-partitions the residual (``utils.checkpoint``). The
  checkpoint's config hash then nulls the fleet size and the elastic
  knobs, and the manifest carries the lineage id. Every
  ``obs_goodput_interval * evict_after_windows`` steps rank 0 merges the
  out dir's shards (``obs.fleet``) and may evict the rank
  ``resilience.elastic.eviction_decision`` names; the decision rides the
  same all-reduce as the stop, so every rank resizes at the same step.
* ``recover_policy`` (``resilience.policy``; needs ``obs_events``): the
  monitor's events claimed by a ``RecoveryManager`` are acted on at the
  end of the dispatch: ``skip`` restores the snapshot taken before the
  dispatch (and before an injected ``nan_grad``): a device copy of the
  parameters and BatchNorm buffers, SGD's momentum, the residual (and u),
  the counters and the age, the step and count, the PTB carry and the
  dropout generator; ``rollback`` restores the newest checkpoint;
  ``degrade`` runs the optimizer's dense warm-up branch for a cooldown.
  At P > 1 every rank sees the same averaged loss and counters, so every
  rank takes the same action.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gtopkssgd_tpu_torch import native
from gtopkssgd_tpu_torch.convert import flat_layout, layer_names
from gtopkssgd_tpu_torch.ctc import ctc_loss, greedy_error_counts
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.data.cifar import CIFAR_MEAN, CIFAR_STD
from gtopkssgd_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from gtopkssgd_tpu_torch.models import (
    DTYPES,
    get_model,
    model_spec,
    seed_dropout,
)
from gtopkssgd_tpu_torch.modes import DENSE_MODES, HIER_MODES
from gtopkssgd_tpu_torch.obs import counters as obs_counters
from gtopkssgd_tpu_torch.obs import (
    critpath,
    fleet,
    ledger,
    registry,
    report,
    trace_attr,
    tracing,
)
from gtopkssgd_tpu_torch.obs.calib import CommCalibrator
from gtopkssgd_tpu_torch.obs.events import (
    AnomalyHalt,
    AnomalyMonitor,
    Thresholds,
)
from gtopkssgd_tpu_torch.obs.exporter import MetricsExporter
from gtopkssgd_tpu_torch.obs.forecast import StepForecaster
from gtopkssgd_tpu_torch.obs.goodput import GoodputLedger
from gtopkssgd_tpu_torch.obs.linkmap import LinkMap
from gtopkssgd_tpu_torch.obs.memwatch import MemWatch, batch_shape_key
from gtopkssgd_tpu_torch.obs.timeline import TimelineRecorder
from gtopkssgd_tpu_torch.obs.tracing import Tracer
from gtopkssgd_tpu_torch.obs.watchdog import StallWatchdog, _default_on_stall
from gtopkssgd_tpu_torch.ops import _build, cuda_topk
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel import comm_model
from gtopkssgd_tpu_torch.parallel.collectives import pmean, psum
from gtopkssgd_tpu_torch.parallel.planner import planner_inputs
from gtopkssgd_tpu_torch.resilience import (
    FaultInjector,
    Preempted,
    RecoveryManager,
    ResizeRestart,
    eviction_decision,
    load_lineage,
    mint_lineage_id,
    parse_inject,
    parse_policy,
    retry_call,
    write_lineage,
)
from gtopkssgd_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    state_digest,
)
from gtopkssgd_tpu_torch.utils.manifest import config_hash, run_manifest
from gtopkssgd_tpu_torch.utils.metrics import MetricsLogger
from gtopkssgd_tpu_torch.utils.prefetch import Prefetcher
from gtopkssgd_tpu_torch.utils.staging import (
    Slot,
    StagingRing,
    group_producer,
)

#: A language model's routing counts a step (``DeepSeekV3.update_routing``).
ROUTING_NAMES = ("pair_count", "load_ratio", "drop_count")
_WIRE_STATS = {"cifar10": (CIFAR_MEAN, CIFAR_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}
# The compressions and selection methods whose P = 1 step holds no host
# sync, so it can be captured in a CUDA graph (``dispatch_rule``).
GRAPH_MODES = (None, "none", "dense", "gtopk", "gtopk_layerwise")
GRAPH_METHODS = ("auto", "exact", "twostage", "pallas")
# The selection methods that launch the port's CUDA kernels.
KERNEL_METHODS = ("auto", "approx", "twostage", "pallas")


def dataset_defaults(dataset: str, dnn: str):
    """(lr, weight_decay, clip_grad_norm) by dataset, as the reference
    hardcoded them; AlexNet on imagenet starts at lr 0.01."""
    return {
        "cifar10": (0.1, 5e-4, None),
        "imagenet": (0.01 if dnn == "alexnet" else 0.1, 1e-4, None),
        "ptb": (1.0, 0.0, 0.25),
        "an4": (3e-4, 0.0, 400.0),
        "tokens": (0.01, 1e-4, 1.0),
    }.get(dataset, (0.1, 0.0, None))


@dataclasses.dataclass
class TrainConfig:
    """The part of the JAX trainer's flag set the port implements."""

    dnn: str = "resnet20"
    dataset: Optional[str] = None  # default: the model's canonical dataset
    model_config: Optional[Union[str, dict]] = None  # a language model's
                                   # published keys and cut: a JSON file's
                                   # path, or the dict
    cuda_allocator: Optional[str] = None  # the process's CUDA caching
                                   # allocator settings (the syntax of
                                   # PYTORCH_CUDA_ALLOC_CONF), set once
                                   # before the model reaches the card
    batch_size: int = 32           # per worker
    lr: Optional[float] = None     # default per dataset
    momentum: float = 0.9
    weight_decay: Optional[float] = None  # default per dataset
    nesterov: bool = False
    compression: Optional[str] = None     # None/'dense' | 'gtopk' |
                                          # 'allgather' | 'topk' | 'topkA'
                                          # | 'topk_allgather' |
                                          # 'gtopk_hier' | 'gtopk_layerwise'
    density: float = 0.001
    topk_method: str = "auto"      # auto | exact | blockwise | approx |
                                   # threshold | pallas | twostage |
                                   # simrecall
    wire_codec: str = "fp32"       # fp32 | int8[:BLOCK] | fp8[:BLOCK]
    hier_ici: int = 1              # gtopk_hier: ranks per slice (dense sum
                                   # within it, gTop-k across slices)
    comm_plan: str = "auto"        # wire-plan pin (parallel.planner):
                                   # auto | tree | balanced | hier |
                                   # allgather | dense
    buckets: str = "concat"        # gtopk_layerwise: concat | leaf | auto
                                   # | <int B> (parallel.bucketing)
    pipeline: str = "serial"       # bucketed gtopk_layerwise: serial |
                                   # overlap | auto
    comm_model_fit: Optional[str] = None  # alpha-beta fit file pricing
                                   # the planner (default: the port's own
                                   # for the backend)
    clip_grad_norm: Optional[float] = None  # default per dataset
    nsteps_update: int = 1
    warmup_epochs: int = 0         # linear lr ramp over the first N epochs
    dense_warmup_epochs: int = 0   # sparse modes: dense exchange for the
                                   # first N epochs
    momentum_correction: bool = False  # sparse modes: DGC velocity before
                                   # selection, masked where sent
    restore_rejected_u: bool = False   # ablation of momentum_correction
                                   # only (the JAX package measured it
                                   # to diverge)
    max_epochs: int = 140
    space_to_depth: bool = False   # resnet50: the space-to-depth stem
    eval_batches: Optional[int] = None  # cap on test()'s batches
    nworkers: int = 1
    data_dir: Optional[str] = None
    out_dir: Optional[str] = None  # metrics files and checkpoints (ckpt/)
    seed: int = 42
    dtype: str = "float32"         # compute dtype: float32 | bfloat16
    synth_hard: bool = False       # synthetic CIFAR only: the harder
                                   # variant (class patterns at 0.07, 10%
                                   # of the train labels resampled)
    log_interval: int = 50         # a "train" record every N steps
    obs_counters: bool = True      # on-device counters (obs.counters) in
                                   # the step, an "obs" record every
                                   # obs_interval steps
    obs_interval: int = 1          # an "obs" record every N steps
    obs_layers: bool = False       # per-layer counters: one "layers"
                                   # record a layer (needs obs_counters)
    obs_audit_interval: int = 0    # every N steps, the recall of the
                                   # selection against the exact top-k
                                   # (audit_recall; 0 = never)
    obs_watchdog: float = 0.0      # seconds a dispatch may go without a
                                   # completed read before the watchdog
                                   # exits 43; 0 = off
    obs_events: bool = True        # the anomaly monitor (obs.events)
    obs_halt_on: Optional[str] = None  # "error" | "warn": AnomalyHalt
                                   # (exit 44) at an event of at least
                                   # this severity; None = record only
    obs_timeline: Optional[str] = None  # the host timeline's JSON path
                                   # (a directory gets timeline.json)
    obs_export_port: int = 0       # OpenMetrics on this localhost port
                                   # (rank r: the port + r); -1 an
                                   # ephemeral one; 0 = off
    recover_policy: Optional[str] = None  # anomaly rules -> skip |
                                   # rollback | degrade (resilience/
                                   # policy.py grammar; needs obs_events)
    obs_goodput: bool = True       # the goodput ledger (obs/goodput.py):
                                   # the run's wall split into goodput and
                                   # the badput taxonomy, a "goodput"
                                   # record every obs_goodput_interval
                                   # steps and at the end
    obs_goodput_interval: int = 50  # steps between "goodput" records
                                   # (<= 0: the final one only); each
                                   # feeds goodput_collapse
    obs_goodput_collapse_windows: int = 3  # records below half the
                                   # goodput EWMA before goodput_collapse
    obs_calib: bool = False        # the live comm-model fit
                                   # (obs/calib.py) from a dispatch
                                   # profiled every obs_calib_interval
                                   # steps; needs obs_counters and P > 1
    obs_calib_interval: int = 25   # steps between captures (calib and
                                   # critpath share one)
    obs_critpath: bool = False     # a "critpath" record a captured
                                   # dispatch (obs/critpath.py)
    obs_critpath_shift_windows: int = 3  # captures whose critical stage
                                   # leaves the modal one before
                                   # critpath_shift
    obs_mem: bool = False          # the compile and memory watch
                                   # (obs/memwatch.py): "compile" and
                                   # "mem" records
    obs_mem_interval: int = 50     # steps between "mem" records
    obs_recompile_warmup: int = 1  # compile-watch polls before
                                   # recompile_storm arms
    obs_mem_leak_windows: int = 3  # growing live-bytes windows before
                                   # device_mem_leak
    obs_hbm_headroom_frac: float = 0.92  # in use / limit above which
                                   # hbm_headroom fires
    obs_linkmap: bool = False      # the link weather map (obs/linkmap.py)
                                   # at the calibrator's captures
    obs_link_degraded_x: float = 4.0  # a link's EWMA over the median by
                                   # this factor is a degraded window
    obs_link_degraded_windows: int = 3  # degraded windows before
                                   # link_degraded
    obs_forecast: bool = False     # the scale-out forecast
                                   # (obs/forecast.py) at the
                                   # calibrator's captures: a "forecast"
                                   # record a capture, forecast_drift
    obs_forecast_targets: str = "32,256,1024"  # modeled worker counts
    obs_forecast_drift_x: float = 4.0  # hindcast error beyond which a
                                   # capture counts as drifted
    registry: Optional[str] = None  # append the run's summary line to
                                   # registry/runs.jsonl on exit
                                   # (obs/registry.py; rank 0)
    resume: bool = False           # restore out_dir/ckpt at construction
    allow_ckpt_mismatch: bool = False  # restore past a config hash or
                                   # state digest that differs
    prefetch: int = 2              # host batches assembled ahead by a
                                   # background thread (0 = synchronous)
    steps_per_dispatch: int = 1    # optimizer steps a dispatch: K host
                                   # batches staged in one transfer, one
                                   # sync; a CUDA graph replayed K times
                                   # where ``dispatch_rule`` allows
    decode_workers: int = 0        # ImageNet JPEG path: decode processes
    inject: Optional[str] = None   # step-keyed fault injection spec
                                   # (resilience/inject.py grammar)
    elastic: bool = False          # elastic fleet: a resize saves,
                                   # rewrites elastic.json and exits 46;
                                   # a resume at another P re-partitions
                                   # the residual
    min_fleet: int = 1             # elastic: never resize below this
    evict_after_windows: int = 3   # elastic: rank 0 checks the merged
                                   # fleet view every N goodput windows
                                   # and evicts the rank
                                   # resilience.elastic.eviction_decision
                                   # names (0 = never)
    device: str = "cuda"

    def resolved(self) -> "TrainConfig":
        """The config with the dataset's defaults filled in; refuses a
        gtopk_hier slice width that does not divide the ranks, and the
        JAX trainer's invalid values."""
        if self.nworkers < 1:
            raise ValueError(f"nworkers={self.nworkers} must be >= 1 (the "
                             "command line reads 0 as every visible "
                             "device)")
        if self.decode_workers < 0:
            raise ValueError(f"decode_workers={self.decode_workers} must "
                             "be >= 0")
        if self.min_fleet < 1:
            raise ValueError(f"min_fleet={self.min_fleet} must be >= 1")
        if self.inject:
            parse_inject(self.inject)  # a malformed spec fails here
        if self.recover_policy:
            parse_policy(self.recover_policy)  # likewise
            if not self.obs_events:
                raise ValueError(
                    "recover_policy requires obs_events (recovery acts "
                    "on AnomalyMonitor events)")
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch={self.steps_per_dispatch}"
                             " must be >= 1")
        forecast_targets(self.obs_forecast_targets)  # likewise
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r}: one of {sorted(DTYPES)}")
        if self.prefetch < 0:
            raise ValueError(f"prefetch={self.prefetch} must be >= 0")
        if (self.compression in HIER_MODES and self.nworkers > 1
                and self.nworkers % self.hier_ici):
            raise ValueError(f"axis size {self.nworkers} not divisible by "
                             f"hier_ici_size={self.hier_ici}")
        cfg = dataclasses.replace(self)
        if cfg.dataset is None:
            cfg.dataset = model_spec(cfg.dnn).dataset
        lr, wd, clip = dataset_defaults(cfg.dataset, cfg.dnn)
        if cfg.lr is None:
            cfg.lr = lr
        if cfg.weight_decay is None:
            cfg.weight_decay = wd
        if cfg.clip_grad_norm is None:
            cfg.clip_grad_norm = clip
        return cfg


def load_model_config(spec: Optional[Union[str, dict]]) -> Optional[dict]:
    """``model_config`` as a dict: a JSON file read from its path, a dict
    as it is, None as None."""
    if spec is None or isinstance(spec, dict):
        return spec
    with open(os.fspath(spec)) as fh:
        return json.load(fh)


def forecast_targets(spec: str) -> tuple:
    """The worker counts of ``obs_forecast_targets`` ("32,256,1024"); the
    JAX trainer's error for a malformed list."""
    try:
        return tuple(int(t) for t in str(spec).split(",") if t.strip())
    except ValueError:
        raise ValueError(
            "--obs-forecast-targets must be a comma-separated list of "
            f"worker counts, got {spec!r}") from None


def dispatch_rule(cfg: TrainConfig) -> str:
    """How a dispatch of ``cfg.steps_per_dispatch`` K steps runs: "graph"
    (one step captured in a CUDA graph and replayed K times) for K > 1 on
    the card at P = 1, in a mode and method whose step holds no host sync
    (``GRAPH_MODES``, ``GRAPH_METHODS``; ``gtopk_layerwise`` under the
    ``serial`` pipeline), for a model whose loss reads no lengths back to
    the host (AN4's CTC does); "staged" (the steps one after another)
    elsewhere: at K = 1, at P > 1 (the exchange ships host-staged buffers;
    gloo cannot be captured), under the ``overlap`` pipeline (its merges
    run on a thread), and for ``threshold`` (not held to the no-sync
    check)."""
    cfg = cfg.resolved()
    graph = (cfg.steps_per_dispatch > 1
             and torch.device(cfg.device).type == "cuda"
             and cfg.nworkers == 1 and cfg.compression in GRAPH_MODES
             and (cfg.compression in DENSE_MODES
                  or cfg.topk_method in GRAPH_METHODS)
             and cfg.pipeline == "serial" and cfg.dataset != "an4")
    return "graph" if graph else "staged"


def shard_steps_per_epoch(ds, batch_size: int, nsteps_update: int = 1) -> int:
    """Optimizer steps per epoch, the same on every rank: the last rank's
    shard also holds the remainder, so at P > 1 the count comes from the
    smallest shard, (n // nworkers) // batch_size; a dataset without a
    partitioner (PTB's stream rows) counts its own batches."""
    spe = ds.steps_per_epoch()
    part = getattr(ds, "partitioner", None)
    if part is not None and part.nworkers > 1:
        spe = (part.n // part.nworkers) // batch_size
    return max(1, spe // nsteps_update)


class Trainer:
    """One rank's trainer; at ``cfg.nworkers`` > 1, one of the ranks of the
    initialized default process group."""

    def __init__(self, config: TrainConfig):
        self.cfg = cfg = config.resolved()
        # The goodput ledger first, so its clock covers the whole set-up;
        # its logger and monitor are attached once they exist.
        self.goodput = (GoodputLedger(interval=cfg.obs_goodput_interval)
                        if cfg.obs_goodput else None)
        self.group = None
        self.rank = 0
        if cfg.nworkers > 1:
            self.group = dist.group.WORLD
            size = dist.get_world_size(self.group)
            if size != cfg.nworkers:
                raise ValueError(f"nworkers={cfg.nworkers} but the process "
                                 f"group has {size} ranks")
            self.rank = dist.get_rank(self.group)
        self.device = torch.device(cfg.device)
        self.logger = logging.getLogger("gtopkssgd_tpu_torch.trainer")
        # The datasets first: the JPEG path's decode pool forks here,
        # before this process touches the card or starts a thread.
        data_kw = dict(batch_size=cfg.batch_size, data_dir=cfg.data_dir,
                       seed=cfg.seed)
        if cfg.dataset == "cifar10" and cfg.synth_hard:
            data_kw["synth_hard"] = True
        if cfg.dataset == "imagenet" and cfg.decode_workers > 0:
            data_kw["decode_workers"] = cfg.decode_workers
        model_config = load_model_config(cfg.model_config)
        if cfg.dataset == "tokens":
            if model_config is None:
                raise ValueError("the tokens dataset takes its seq_len and "
                                 "vocab_size from model_config")
            data_kw.update(seq_len=model_config["seq_len"],
                           vocab_size=model_config["vocab_size"])

        def dataset(**kw):
            return retry_call(lambda: get_dataset(cfg.dataset, **kw),
                              retries=2, delay=0.5, logger=self.logger,
                              desc=f"get_dataset({cfg.dataset})")

        self.train_data = dataset(split="train", rank=self.rank,
                                  nworkers=cfg.nworkers, **data_kw)
        self.val_data = dataset(split="test", **data_kw)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model, self.spec = get_model(
            cfg.dnn, space_to_depth=cfg.space_to_depth, dtype=cfg.dtype,
            config=model_config)
        self.kind = ("lm" if self.spec.lm else cfg.dataset
                     if self.spec.recurrent else "vision")
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        if cfg.cuda_allocator and self.device.type == "cuda":
            # Process-wide, and left set for what the process runs later.
            torch.cuda.memory._set_allocator_settings(cfg.cuda_allocator)
        self.model.to(self.device).train()
        if (self.device.type == "cuda" and cfg.compression not in DENSE_MODES
                and cfg.topk_method in KERNEL_METHODS):
            # Building or loading the kernels is the port's compile.
            self._mark("startup")
            _build.load()
            self._mark("compile")
        # The JAX trainer folds the rank into its dropout key: the ranks
        # draw different masks.
        self.dropout_generator = seed_dropout(
            self.model, int(np.random.SeedSequence(
                [cfg.seed, self.rank]).generate_state(1)[0]))
        self.steps_per_epoch = shard_steps_per_epoch(
            self.train_data, cfg.batch_size, cfg.nsteps_update)
        self.layout = flat_layout(self.model)
        #: The layout's leaves by flax key path: the "layers" records'.
        self.layer_names = layer_names(self.model)
        self.num_params = self.layout.n
        self.optimizer = self.make_optimizer()
        #: The wire plan's decision at P > 1 (parallel.planner) and the
        #: layer-wise bucket partition (parallel.bucketing), resolved once
        #: here; None where there is none. Rank 0 prints them.
        self.plan_decision = self.optimizer.plan_decision
        self.bucket_plan = self.optimizer.bucket_plan
        if self.rank == 0 and self.plan_decision is not None:
            record = self.plan_decision.record()
            chosen = next(c for c in record["candidates"]
                          if c["name"] == record["plan"])
            record["span_serial_ms"] = chosen["span_serial_ms"]
            record["span_overlap_ms"] = chosen["span_overlap_ms"]
            if self.bucket_plan is not None:
                record.update(self.bucket_plan.to_manifest())
            print("plan " + json.dumps(record), flush=True)
        if self.kind == "vision":
            mean, std = _WIRE_STATS[cfg.dataset]
            self._mean = torch.as_tensor(mean, device=self.device)
            self._std = torch.as_tensor(std, device=self.device)
        self._graph = None  # the captured step (``_capture``)
        self.carry = None
        self.reset_carry()
        self.step = 0
        #: What a step reports, in ``_train_step``'s order: the loss and
        #: the forward's metrics, then a language model's routing counts.
        self._forward_names = (["top1", "top5"] if self.kind == "vision"
                               else [])
        self._metric_names = (["loss"] + self._forward_names + (
            list(ROUTING_NAMES) if self.kind == "lm" else []))
        #: "graph" or "staged" (``dispatch_rule``).
        self.dispatch = dispatch_rule(cfg)
        #: Graph bookkeeping: captures made, replays run, and per kernel
        #: counter the launches recorded in captures (the wrappers count
        #: a launch when they record it; a replay runs them again
        #: uncounted) and the launches replays ran.
        self.graph_stats = {"captures": 0, "replays": 0,
                            "captured": {}, "replayed": {}}
        # The live exporter first: it is the metrics logger's sink. Each
        # rank process exports its own view, rank r on the port plus r
        # (the ranks of one host cannot share a port); -1: ephemeral.
        self.exporter = None
        if cfg.obs_export_port:
            port = (0 if cfg.obs_export_port < 0
                    else cfg.obs_export_port + self.rank)
            self.exporter = MetricsExporter(port=port).start()
            self.logger.info("obs exporter: http://127.0.0.1:%d/metrics",
                             self.exporter.port)
        self.metrics = MetricsLogger(
            cfg.out_dir, rank=self.rank, shard=cfg.nworkers > 1,
            sink=self.exporter.observe if self.exporter else None)
        # The host timeline (rank 0), the span tracer feeding it, the
        # anomaly monitor (density rules only for a sparse mode's rho),
        # the stall watchdog and the recovery manager claiming the
        # monitor's events.
        self.timeline = (TimelineRecorder(rank=self.rank)
                         if cfg.obs_timeline and self.rank == 0 else None)
        self.tracer = Tracer(
            metrics=self.metrics,
            sink=self.timeline.span_sink if self.timeline else None,
            device=self.device)
        tracing.idle.clear()
        tracing.routing.clear()
        self.monitor = (AnomalyMonitor(
            metrics=self.metrics,
            rho=cfg.density if cfg.compression not in DENSE_MODES else None,
            halt_on=cfg.obs_halt_on, timeline=self.timeline,
            thresholds=Thresholds(
                recompile_warmup=cfg.obs_recompile_warmup,
                mem_leak_windows=cfg.obs_mem_leak_windows,
                hbm_headroom_frac=cfg.obs_hbm_headroom_frac,
                critpath_shift_windows=cfg.obs_critpath_shift_windows,
                goodput_collapse_windows=cfg.obs_goodput_collapse_windows,
                link_degraded_x=cfg.obs_link_degraded_x,
                link_degraded_windows=cfg.obs_link_degraded_windows,
                forecast_drift_x=cfg.obs_forecast_drift_x))
            if cfg.obs_events else None)
        if self.goodput is not None:
            self.goodput.metrics = self.metrics
            self.goodput.monitor = self.monitor
        self.watchdog = (StallWatchdog(
            cfg.obs_watchdog, on_stall=self._on_stall,
            diagnostics=self._stall_diagnostics)
            if cfg.obs_watchdog > 0 else None)
        self.recovery = (RecoveryManager(parse_policy(cfg.recover_policy),
                                         metrics=self.metrics,
                                         logger=self.logger)
                         if cfg.recover_policy else None)
        if self.recovery is not None:
            self.monitor.recovery = self.recovery.claim
        self._snap_bufs = None  # the recovery snapshot's buffers
        # A degrade episode: the dense warm-up branch until this step.
        self._degraded = False
        self._degrade_until = 0
        self._sparse_warmup = 0
        self.injector = (FaultInjector(cfg.inject, metrics=self.metrics,
                                       logger=self.logger, rank=self.rank)
                         if cfg.inject else None)
        #: The PreemptionGuard the command line installs (None: signals
        #: keep their handlers).
        self.preempt = None
        # The elastic lineage: one id for the logical run, carried across
        # resizes in out_dir/elastic.json; in the manifest only under
        # elastic.
        self.lineage = None
        extra = {}
        if cfg.elastic:
            if self.rank == 0:
                self.lineage = load_lineage(cfg.out_dir)
                if self.lineage is None:
                    self.lineage = {"lineage_id": mint_lineage_id(),
                                    "resize_epoch": 0, "p": cfg.nworkers}
                    if cfg.out_dir:
                        write_lineage(cfg.out_dir, **self.lineage)
            if self.group is not None:  # rank 0's, on every rank
                box = [self.lineage]
                dist.broadcast_object_list(box, src=0, group=self.group)
                self.lineage = box[0]
            extra = {"lineage_id": self.lineage["lineage_id"],
                     "resize_epoch": int(self.lineage.get("resize_epoch",
                                                          0))}
        backend = None if self.group is None else dist.get_backend(self.group)
        # The manifest's config hash keys the registry's comparisons and
        # the fleet merge: the out dir and the registry are where a run
        # writes, not what it runs, so two runs of one config into two
        # dirs share it.
        self.manifest = run_manifest(
            self._identity(out_dir=None, registry=None), device=self.device,
            backend=backend, world_size=cfg.nworkers,
            num_params=self.num_params,
            steps_per_epoch=self.steps_per_epoch,
            native_dataprep=native.available(), dispatch=self.dispatch,
            dtype=cfg.dtype, **extra)
        self.metrics.log("manifest", flush=True, **self.manifest)
        if self.plan_decision is not None:
            self.metrics.log("plan", flush=True,
                             **self.plan_decision.record())
        if self.bucket_plan is not None:
            self.metrics.log("bucket", flush=True,
                             **self.bucket_plan.to_manifest())
        #: What the comm model prices this run with (obs.ledger): the
        #: manifest, the plan's schedule, the buckets, the slice width.
        self.model_manifest = dict(self.manifest, hier_ici=cfg.hier_ici)
        if self.plan_decision is not None:
            self.model_manifest["comm_plan_schedule"] = (
                self.plan_decision.plan.schedule)
        if self.bucket_plan is not None:
            self.model_manifest.update(self.bucket_plan.to_manifest())
        self._init_trace_planes(backend)
        # The checkpoint's config hash nulls what does not change the
        # experiment (the JAX trainer's nulled fields, and resume): the
        # injected faults, and under elastic the fleet size, the elastic
        # knobs, the out dir and the registry, so both sides of a resize
        # agree.
        self._ckpt = None
        if cfg.out_dir:
            nulled = dict(allow_ckpt_mismatch=False, resume=False,
                          inject=None)
            if cfg.elastic:
                nulled.update(nworkers=0, elastic=False,
                              evict_after_windows=3, min_fleet=1,
                              out_dir=None, registry=None)
            self._ckpt = CheckpointManager(
                f"{cfg.out_dir}/ckpt",
                config_hash=config_hash(self._identity(**nulled)),
                rank=self.rank, group=self.group, logger=self.logger)
        # Staging: a prefetcher hands over one dispatch's micro-batches at
        # a time (``_group``), queued ``_group_depth`` dispatches ahead:
        # the micro-batches it keeps ready, as before, rounded up to
        # whole dispatches. On the card, with no injector (whose reshape
        # changes shapes at the consumer), they arrive stacked in a slot
        # of the ring, which outlives each prefetcher; one slot more than
        # the queue holds is the one the worker fills.
        self._group = cfg.steps_per_dispatch * cfg.nsteps_update
        self._group_depth = -(-max(cfg.prefetch, self._group) // self._group)
        self._ring = (StagingRing(self._group_depth + 1, self.device)
                      if self.device.type == "cuda" and cfg.prefetch > 0
                      and self.injector is None else None)
        #: Dispatches staged, those from the ring, and the seconds the
        #: main thread waited on the prefetch worker for them.
        self.stage_stats = {"dispatches": 0, "ring": 0, "wait_s": 0.0}
        #: Micro-batches of a group that ``_next_host`` took apart.
        self._pending: collections.deque = collections.deque()
        self._prefetch = None
        self._set_iters(start_epoch=0)
        if cfg.resume:
            self.restore()

    def _mark(self, category: Optional[str]) -> None:
        """The goodput ledger's mark, where there is a ledger."""
        if self.goodput is not None:
            self.goodput.mark(category)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _init_trace_planes(self, backend: Optional[str]) -> None:
        """The compile and memory watch (``obs_mem``), and at P > 1 with
        the counters the comm-model calibrator (``obs_calib``) with the
        link map riding it (``obs_linkmap``), as the JAX trainer builds
        them: the calibrator's baseline and the carve's constants are the
        inputs that priced this run's plan (the committed fit for the
        backend, or ``comm_model_fit``)."""
        cfg = self.cfg
        #: The batch-shape keys whose first step has run, the graph
        #: variants captured (audit, lr) and the captures beyond them:
        #: the executables the compile watch counts.
        self._shape_keys = set()
        self._graph_keys = set()
        self._extra_captures = 0
        #: The comm model's constants at P > 1, read once (a calib_fit
        #: an earlier run left in out_dir, else the committed fit for the
        #: backend): critpath's wait split and the ledger price with it.
        self.comm_fit = (ledger.load_alpha_beta(
            cfg.out_dir, nprocs=cfg.nworkers, backend=backend)
            if cfg.nworkers > 1 else None)
        self.memwatch = None
        if cfg.obs_mem:
            self.memwatch = MemWatch(
                metrics=self.metrics, monitor=self.monitor,
                mem_interval=cfg.obs_mem_interval, device=self.device,
                logger=self.logger)
            self.memwatch.attach(self._compile_cache_size)
        self.calib = self.linkmap = self.forecaster = None
        if not (cfg.obs_calib and cfg.obs_counters and cfg.nworkers > 1):
            return
        d = self.plan_decision
        if d is not None:
            wire_mode, inputs = d.plan.wire_mode, d.inputs
        else:
            wire_mode = "dense"
            inputs = planner_inputs(cfg.comm_model_fit
                                    or comm_model.committed_fit(backend))
        self.calib = CommCalibrator(
            wire_mode, cfg.nworkers,
            baseline={key: inputs.get(key) for key in
                      ("alpha_ms", "beta_gbps", "ici_gbps", "fit_source")},
            metrics=self.metrics, monitor=self.monitor,
            ici_size=cfg.hier_ici)
        if cfg.obs_linkmap:
            self.linkmap = LinkMap(
                wire_mode, cfg.nworkers, rank=self.rank,
                ici_size=cfg.hier_ici, alpha_ms=inputs.get("alpha_ms"),
                beta_gbps=inputs.get("beta_gbps"),
                ici_gbps=inputs.get("ici_gbps"),
                metrics=self.metrics, monitor=self.monitor)
        if cfg.obs_forecast:
            # The forecast rides the same captures: the critpath budgets,
            # the calibrator's refits and the link map's snapshots, from
            # the inputs that priced the plan until the first refit.
            bplan = self.bucket_plan
            k = (bplan.k_total if bplan is not None
                 else max(1, int(np.ceil(cfg.density * self.num_params))))
            if cfg.compression in DENSE_MODES:
                k = self.num_params
            self.forecaster = StepForecaster(
                {"mode": cfg.compression or "dense", "p": cfg.nworkers,
                 "n": self.num_params, "k": k, "codec": cfg.wire_codec,
                 "schedule": d.plan.schedule if d is not None else None,
                 "bucketing": cfg.buckets or "concat",
                 "buckets": bplan.pairs() if bplan is not None else None,
                 "ici_size": cfg.hier_ici},
                baseline=inputs,
                targets=forecast_targets(cfg.obs_forecast_targets),
                metrics=self.metrics, monitor=self.monitor)

    def _compile_cache_size(self) -> int:
        """The executables this run has made: one a batch shape, plus
        the graph captures beyond one a (variant, lr)."""
        return len(self._shape_keys) + self._extra_captures

    def _identity(self, **nulled) -> TrainConfig:
        """The resolved config as the manifest and the checkpoints hash it:
        the device as its type (every rank's is the same), `nulled`
        fields replaced."""
        return dataclasses.replace(self.cfg, device=self.device.type,
                                   **nulled)

    def reset_carry(self) -> None:
        """Zero the PTB model's carry (each epoch restarts every stream
        row); the other models carry nothing (None). Under a captured
        graph the carry is the graph's buffer, zeroed in place."""
        if self.kind != "ptb":
            return
        if self._graph is not None:
            for t in _leaves(self.carry):
                t.zero_()
        else:
            self.carry = self.model.initial_carry(self.cfg.batch_size)

    def make_optimizer(self, warmup_dense_steps: Optional[int] = None):
        """The optimizer; ``warmup_dense_steps`` overrides the config's
        ``dense_warmup_epochs * steps_per_epoch``, as the JAX trainer's
        ``_make_tx`` allows."""
        cfg = self.cfg
        if warmup_dense_steps is None:
            warmup_dense_steps = cfg.dense_warmup_epochs * self.steps_per_epoch
        return GTopKSGD(
            self.model.parameters(), self.lr_schedule(),
            momentum=cfg.momentum, weight_decay=cfg.weight_decay,
            nesterov=cfg.nesterov, compression=cfg.compression,
            density=cfg.density, topk_method=cfg.topk_method,
            wire_codec=cfg.wire_codec, clip_grad_norm=cfg.clip_grad_norm,
            hier_ici_size=cfg.hier_ici, comm_plan=cfg.comm_plan,
            buckets=cfg.buckets, pipeline=cfg.pipeline,
            comm_model_fit=cfg.comm_model_fit,
            warmup_dense_steps=warmup_dense_steps,
            momentum_correction=cfg.momentum_correction,
            telemetry=cfg.obs_counters, telemetry_layers=cfg.obs_layers,
            telemetry_audit_interval=cfg.obs_audit_interval,
            _restore_rejected_u=cfg.restore_rejected_u,
            layout=self.layout, process_group=self.group)

    def lr_schedule(self):
        """lr(count) in float32, bitwise the JAX trainer's: the cifar10
        step schedule, x0.1 at 50% and 75% of max_epochs (boundaries that
        collide or land at step 0 dropped), the imagenet one, x0.1 at
        epochs 30, 60 and 80, constant for other datasets;
        with ``warmup_epochs``, first a linear ramp from lr/10 to lr over
        w = warmup_epochs * steps_per_epoch steps. The JAX ramp is written
        base * (0.1 + 0.9 * min(step, w) / w); XLA folds 0.9 / w into one
        float32 constant c = 0.9 * (1 / w) and fuses the multiply and add
        into an FMA, base * fma(step, c, 0.1), and that is what the port
        computes (the product exact in float64, rounded once)."""
        cfg = self.cfg
        base = np.float32(cfg.lr)
        inner = self._dataset_schedule(base)
        if cfg.warmup_epochs <= 0:
            return inner
        f32 = np.float32
        w = cfg.warmup_epochs * self.steps_per_epoch
        c = float(f32(0.9) * (f32(1.0) / f32(w)))

        def schedule(count: int) -> float:
            if count >= w:
                return inner(count)
            return float(base * f32(count * c + float(f32(0.1))))

        return schedule

    def _dataset_schedule(self, base: np.float32):
        cfg, spe = self.cfg, self.steps_per_epoch
        if cfg.dataset in ("ptb", "an4"):
            # base * r ** e with e whole epochs (ptb: r = 0.8 from epoch 6
            # on; an4: r = 1/1.01), r in float32 and the power computed
            # in float32 as XLA computes the JAX schedule's jnp.power: the
            # float64 power of the float32 r, rounded once.
            r = np.float32(0.8 if cfg.dataset == "ptb" else 1 / 1.01)
            skip = 5 if cfg.dataset == "ptb" else 0

            def decay(count: int) -> float:
                e = max(0, count // spe - skip)
                return float(base * np.float32(np.float64(r) ** e))

            return decay
        if cfg.dataset == "cifar10":
            bounds = sorted({int(cfg.max_epochs * f) * spe
                             for f in (0.5, 0.75)} - {0})
        elif cfg.dataset == "imagenet":
            bounds = [30 * spe, 60 * spe, 80 * spe]
        else:
            return lambda count: float(base)

        def schedule(count: int) -> float:
            v = base
            for b in bounds:
                if count >= b:
                    v = v * np.float32(0.1)
            return float(v)

        return schedule

    # ------------------------------------------------------ the data path
    def _set_iters(self, start_epoch: int, skip_steps: int = 0) -> None:
        """(Re)build the host batch stream from epoch `start_epoch`,
        `skip_steps` optimizer steps into it (a restored step mid-epoch),
        and (re)start the prefetcher on it. Batch b of epoch e is a pure
        function of the seed, the rank, e and b, so the stream is the one
        an uninterrupted run reads."""
        self._close_prefetch()
        self._pending.clear()
        data = self.train_data

        def stream():
            e = start_epoch
            while True:
                yield from data.epoch(e)
                e += 1

        it = stream()
        for _ in range(skip_steps * self.cfg.nsteps_update):
            next(it)
        self._iter = it
        if self.cfg.prefetch > 0:
            # The closures hold the iterator and the ring, not the
            # trainer. The thread assembles the next dispatch while the
            # card runs this one; the stop flag ends its wait on a slot.
            stop = threading.Event()
            if self._ring is not None:
                self._ring.reset()
            self._prefetch = Prefetcher(
                group_producer(it.__next__, self._group, self._ring, stop),
                depth=self._group_depth)
            self._finalizer = weakref.finalize(self, _stop_prefetch,
                                               self._prefetch, stop)

    def _close_prefetch(self) -> None:
        if getattr(self, "_prefetch", None) is not None:
            self._finalizer()
            self._prefetch = None

    def close(self) -> None:
        """Stop the prefetcher and the optimizer's merge thread, and drop
        the datasets' hold on the decode pool. Training goes on only
        through ``restore()`` or a new Trainer; ``test()`` is unaffected
        (its batches decode in this process then). The metrics file
        stays open until ``__exit__``."""
        self._close_prefetch()
        self._iter = None
        self.optimizer.close()
        for data in (self.train_data, self.val_data):
            if hasattr(data, "close"):
                data.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        if self.watchdog is not None:
            self.watchdog.close()
        if self.timeline is not None:
            try:
                path = self.timeline.write(self.cfg.obs_timeline)
                self.logger.info("timeline -> %s", path)
            except OSError as e:
                self.logger.warning("timeline write failed: %s", e)
        # The calibrator's fit for the next run, then the goodput
        # summary (final=1), the JAX trainer's last records.
        if (self.calib is not None and self.cfg.out_dir
                and self.rank == 0):
            try:
                path = self.calib.write_artifact(
                    self.cfg.out_dir, manifest=self.model_manifest)
                if path:
                    self.logger.info("comm-model fit -> %s", path)
            except OSError as e:
                self.logger.warning("calib artifact write failed: %s", e)
        if self.goodput is not None:
            try:
                self.goodput.log_record(self.step, final=True)
            except Exception as e:
                self.logger.warning("goodput summary failed: %s", e)
        self._append_registry()
        if self.exporter is not None:
            self.exporter.close()
        self.metrics.close()

    def _append_registry(self) -> None:
        """Rank 0 appends the run's summary line (``obs.registry.
        run_summary`` of the out dir's records) to ``registry/runs.jsonl``,
        as the run ends: from ``__exit__``, which every exit of the
        command line passes (0, and 44, 45 and 46 after their records),
        and from the stall path (43). A failure is logged and never
        changes the exit."""
        cfg = self.cfg
        if not (cfg.registry and cfg.out_dir and self.rank == 0):
            return
        try:
            records, _ = report.load_records(cfg.out_dir)
            entry = registry.run_summary(records)
            if entry is not None:
                path = registry.append_run(cfg.registry, entry)
                self.logger.info("registry += %s", path)
        except (OSError, ValueError) as e:
            self.logger.warning("registry append failed: %s", e)

    def _fetch(self, k: int, source):
        """``next(source)``. With an injector, the fetch for the dispatch
        of steps (step, step + k] runs under ``retry_call``, which absorbs
        a loader fault (injected or not)."""
        def fetch():
            if self.injector is not None:
                self.injector.check_loader(self.step, self.step + k)
            return next(source)

        if self.injector is None:
            return fetch()
        return retry_call(fetch, retries=2, delay=0.05, logger=self.logger,
                          desc="host batch fetch")

    def _next_host(self, k: int = 1) -> Dict[str, np.ndarray]:
        """The next host micro-batch of the stream: from the prefetcher,
        one of its group taken apart (a slot's rows copied out, the slot
        handed back at once), else from the stream itself."""
        if self._iter is None:
            raise RuntimeError("Trainer is closed; build a new Trainer "
                               "(restore() reopens it from a checkpoint)")
        if self._prefetch is None:
            return self._fetch(k, self._iter)
        if not self._pending:
            group = self._fetch(k, self._prefetch)
            if isinstance(group, Slot):
                hosts = group.hosts()
                self._ring.release(group)
                group = hosts
            self._pending.extend(group)
        return self._pending.popleft()

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The host arrays on the device as they are; on the card from
        pinned memory, without blocking (the caching host allocator
        keeps a pinned block until its copy has run). The device-clock
        mark "first" goes just before the first copy: in ``_stage``, the
        dispatch's first device work."""
        out = {}
        for key, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
                if not out:
                    self.tracer.mark("first")
                t = t.to(self.device, non_blocking=True)
            out[key] = t
        return out

    def _prepare(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """A device batch as the model reads it: images normalized to
        float32, tokens and labels as int64 indices, the rest as it is."""
        out = dict(batch)
        if self.kind == "vision":
            out["image"] = (out["image"].float() / 255.0
                            - self._mean) / self._std
            out["label"] = out["label"].long()
        elif self.kind in ("ptb", "lm"):
            out = {key: v.long() for key, v in out.items()}
        return out

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """The host batch on the device, prepared."""
        return self._prepare(self._to_device(batch))

    def _forward(self, batch: Dict[str, torch.Tensor]):
        """(mean loss, per-batch metrics, logits) of `batch`; the PTB model
        reads ``self.carry`` and leaves its new carry there, detached."""
        model = self.model
        if self.kind == "lm":
            logits, aux = model(batch["tokens"])
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   batch["targets"].reshape(-1))
            return loss + aux, {}, logits
        if self.kind == "ptb":
            logits, carry = model(batch["tokens"], self.carry)
            self.carry = tuple((c.detach(), h.detach()) for c, h in carry)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   batch["targets"].reshape(-1))
            return loss, {}, logits
        if self.kind == "an4":
            lengths = batch["input_lengths"]
            logits = model(batch["spectrogram"], lengths)
            loss = ctc_loss(logits, model.output_length(lengths),
                            batch["labels"], batch["label_lengths"])
            return loss, {}, logits
        logits = model(batch["image"])
        y = batch["label"]
        loss = F.cross_entropy(logits, y)
        top5 = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        return loss, {"top1": (logits.argmax(-1) == y).float().mean(),
                      "top5": (top5 == y[:, None]).any(-1).float().mean()
                      }, logits

    @torch.no_grad()
    def _average_over_ranks(self, scalars: List[torch.Tensor]
                            ) -> List[torch.Tensor]:
        """One all-reduce averages the BatchNorm running statistics (none
        for AlexNet and the PTB model) and `scalars` (the loss, top-1)
        over the ranks; returns the averaged scalars."""
        bufs = list(self.model.buffers())
        flat = torch.cat([b.reshape(-1) for b in bufs]
                         + [v.reshape(1) for v in scalars])
        flat = pmean(flat, group=self.group)
        off = 0
        for b in bufs:
            b.copy_(flat[off:off + b.numel()].view_as(b))
            off += b.numel()
        return list(flat[off:])

    # --------------------------------------------------------- training
    def _train_step(self, batches: List[Dict[str, torch.Tensor]]
                    ) -> List[torch.Tensor]:
        """One optimizer step over the device micro-batches `batches`
        (raw, ``_prepare`` runs here); returns the ``_metric_names``
        values (the loss, and top-1 and top-5 for the vision models),
        averaged over the micro-batches and the ranks, as device tensors. Holds no host sync at P = 1, so a graph can
        capture it."""
        cfg, opt = self.cfg, self.optimizer
        opt.zero_grad(set_to_none=True)
        sums = None
        for raw in batches:
            with self.tracer.span("forward_backward"):
                loss, metrics = self._forward(self._prepare(raw))[:2]
                loss.backward()
            values = [loss.detach()] + [metrics[key]
                                        for key in self._forward_names]
            sums = values if sums is None else [
                a + b for a, b in zip(sums, values)]
        with self.tracer.span("optimizer"):
            if cfg.nsteps_update > 1:
                for p in self.model.parameters():
                    p.grad.div_(cfg.nsteps_update)
            opt.step()
        scalars = [v / cfg.nsteps_update for v in sums]
        if self.group is not None:
            scalars = self._average_over_ranks(scalars)
        if self.kind == "lm":
            # After the ranks averaged the loads: the bias update and the
            # routing counts.
            scalars += list(self.model.update_routing())
        return scalars

    def _stage(self, k: int) -> List[List[Dict[str, torch.Tensor]]]:
        """The next `k` steps' micro-batches, staged: the host batches
        stacked per field and copied to the device in one transfer each;
        returns per step its list of micro-batches (views). A dispatch
        the prefetcher grouped comes as one group: a ring slot the worker
        filled, whose copies go out from it as they are, or the plain
        micro-batches, stacked here."""
        m = self.cfg.nsteps_update
        self.tracer.mark("data")
        with self.tracer.span("data"):
            grouped = (self._prefetch is not None and not self._pending
                       and k * m == self._group)
            if grouped:
                t0 = time.perf_counter()
                group = self._fetch(k, self._prefetch)
                self._note_stage(k, isinstance(group, Slot),
                                 time.perf_counter() - t0)
            else:
                group = [self._next_host(k) for _ in range(k * m)]
            if isinstance(group, Slot):
                stacked = self._slot_to_device(group)
            else:
                host = {key: np.stack([h[key] for h in group])
                        if len(group) > 1 else group[0][key][None]
                        for key in group[0]}
                if self.injector is not None:
                    host = self.injector.reshape_batch(
                        host, self.step, self.step + k, axis=1)
                stacked = self._to_device(host)
        return [[{key: v[i * m + j] for key, v in stacked.items()}
                 for j in range(m)] for i in range(k)]

    def _slot_to_device(self, slot: Slot) -> Dict[str, torch.Tensor]:
        """A ring slot's fields copied to the device without blocking
        (mark "first" before the first), and the slot handed back with
        an event after the last copy, which the worker waits for before
        it writes the slot again."""
        out = {}
        for key, t in slot.fields.items():
            if not out:
                self.tracer.mark("first")
            out[key] = t.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            if slot.event is None:
                slot.event = torch.cuda.Event()
            slot.event.record(torch.cuda.current_stream(self.device))
        self._ring.release(slot)
        return out

    def _note_stage(self, steps: int, ring: bool, wait_s: float) -> None:
        """Count a grouped dispatch in ``stage_stats`` and the tracer's
        window."""
        stats = self.stage_stats
        stats["dispatches"] += 1
        stats["ring"] += int(ring)
        stats["wait_s"] += wait_s
        self.tracer.note_stage(steps, ring, wait_s)

    def _eager_until(self) -> int:
        """The count below which a graph dispatch runs its steps eagerly:
        the dense warm-up (another branch of the step) and the lr ramp
        (a new lr every step)."""
        opt, cfg = self.optimizer, self.cfg
        return max(opt.warmup_dense_steps,
                   cfg.warmup_epochs * self.steps_per_epoch)

    def _graph_step(self, batches: List[Dict[str, torch.Tensor]]
                    ) -> List[torch.Tensor]:
        """One step of a "graph" dispatch. The graph holds one whole step
        (zero_grad, forward, backward, the selection's kernel launches,
        SGD) reading static input buffers, and writes the state it
        replaces (residual, the PTB carry) back into the buffers it read,
        so each replay continues from the last. SGD's lr enters the graph
        as the constant it is, a launch constant of the SGD apply
        (``ops.cuda_topk.sgd_apply``; a tensor lr would need a host read or
        another rounding), so the update keeps the eager step's arithmetic
        and a graph is captured anew when the schedule's lr changes (the
        step schedules change it at a few epoch boundaries). The SGD
        apply's leaf table is built before each capture
        (``GTopKSGD.prepare_capture``).
        A step runs eagerly, not in the graph, below ``_eager_until()``
        (the dense warm-up's branch, the lr ramp) and while SGD has no
        momentum buffers yet (its first step makes them). The dropout
        generator is registered with the graph, so each replay draws the
        masks the eager step would. With the counters' recall audit, a step
        whose count is a multiple of the audit interval replays a second
        capture, the audit's (``_graph`` holds one capture a variant,
        keyed by whether the step audits); the host picks the variant by
        the count it keeps, and the two share the state buffers."""
        opt = self.optimizer
        count = opt.state["count"]
        lr = float(opt.schedule(count)) if opt.schedule else None
        fresh = opt.param_groups[0]["momentum"] and any(
            "momentum_buffer" not in opt.state.get(p, {})
            for p in self.model.parameters())
        audit = bool(opt.telemetry and opt.audit_interval > 0
                     and count % opt.audit_interval == 0)
        held = next(iter(self._graph.values())) if self._graph else None
        if count < self._eager_until() or fresh or (
                held is not None and any(
                    static[key].shape != raw[key].shape
                    for static, raw in zip(held["inputs"], batches)
                    for key in static)):
            return self._train_step(batches)
        if held is not None and held["lr"] != lr:
            self._reset_graphs()  # every variant holds the old lr
        if not self._graph or audit not in self._graph:
            self._capture(batches, lr, audit)
        g = self._graph[audit]
        for static, raw in zip(g["inputs"], batches):
            for key, t in static.items():
                t.copy_(raw[key])
        g["graph"].replay()
        # The captured step's host side effects, which the replay skips.
        opt.state["count"] += 1
        if lr is not None:
            for group in opt.param_groups:
                group["lr"] = lr
        stats = self.graph_stats
        stats["replays"] += 1
        for name, n in g["launches"].items():
            stats["replayed"][name] = stats["replayed"].get(name, 0) + n
        return [t.clone() for t in g["outputs"]]

    def _reset_graphs(self) -> None:
        """Drop every captured step."""
        for g in (self._graph or {}).values():
            g["graph"].reset()
        self._graph = None

    def _capture(self, batches: List[Dict[str, torch.Tensor]],
                 lr: Optional[float], audit: bool = False) -> None:
        """Capture one step in a new CUDA graph, the variant `audit` (the
        count's step decides it; see ``_graph_step``), with host syncs
        made errors while it records. The capture checks this thread
        only: the prefetch thread may poll a ring slot's event meanwhile
        (``utils.staging``), which a capture checking every thread would
        take for an unsafe call and fail on."""
        opt = self.optimizer
        if self.goodput is not None:
            # The steps this dispatch ran so far are step time; the
            # capture is the port's compile.
            self.goodput.step_mark(degraded=self._degraded)
        if (audit, lr) in self._graph_keys:
            self._extra_captures += 1
        self._graph_keys.add((audit, lr))
        inputs = [{key: v.clone() for key, v in b.items()} for b in batches]
        residual, carry = opt.state["residual"], self.carry
        count = opt.state["count"]
        # The graph allocates from a pool of its own: hand the blocks the
        # eager steps left cached back to the card first.
        torch.cuda.empty_cache()
        opt.prepare_capture()
        graph = torch.cuda.CUDAGraph()
        if self.dropout_generator is not None:
            graph.register_generator_state(self.dropout_generator)
        before = dict(cuda_topk.launches)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outputs = self._train_step(inputs)
                for dst, src in zip(_leaves(residual),
                                    _leaves(opt.state["residual"])):
                    dst.copy_(src)
                for dst, src in zip(_leaves(carry), _leaves(self.carry)):
                    dst.copy_(src)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        # The capture ran nothing: undo its host side effects.
        opt.state["residual"], self.carry = residual, carry
        opt.state["count"] = count
        launches = {name: n - before.get(name, 0)
                    for name, n in cuda_topk.launches.items()
                    if n != before.get(name, 0)}
        stats = self.graph_stats
        stats["captures"] += 1
        for name, n in launches.items():
            stats["captured"][name] = stats["captured"].get(name, 0) + n
        self._graph = self._graph or {}
        self._graph[audit] = {"graph": graph, "lr": lr, "inputs": inputs,
                              "outputs": outputs, "launches": launches}
        self._mark("compile")

    def train(self, num_iters: int) -> Dict[str, object]:
        """Run `num_iters` optimizer steps, ``steps_per_dispatch`` K at a
        time (`num_iters` must be a multiple of K). Returns the last
        step's loss (and top-1 for the vision models, perplexity exp(min(
        loss, 20)) for PTB), the per-step lists, the per-step wall times
        (each dispatch ends in a device sync on CUDA; a step of a K-step
        dispatch is given 1/K of it), the throughput in samples/s and
        ``dispatch``. A "train" record goes to the metrics file whenever
        a dispatch crosses a multiple of ``log_interval``, with the epoch
        its last step belongs to; an "obs" record (and "layers" records)
        whenever it crosses a multiple of ``obs_interval``, read in the
        dispatch's one device-to-host copy. The monitor sees those reads;
        a recovery it claims is applied before the next dispatch. A
        skipped dispatch keeps its entries in the returned lists."""
        cfg = self.cfg
        k = cfg.steps_per_dispatch
        if self._iter is None:
            raise RuntimeError("Trainer is closed; build a new Trainer "
                               "(restore() reopens it from a checkpoint)")
        if k > 1 and num_iters % k != 0:
            raise ValueError(
                f"num_iters={num_iters} must be a multiple of "
                f"steps_per_dispatch={k} (a dispatch stages and runs K "
                "steps)")
        cuda = self.device.type == "cuda"
        opt = self.optimizer
        cols: Dict[str, List[float]] = {name: []
                                         for name in self._metric_names}
        step_times: List[float] = []
        t_start = time.perf_counter()
        samples = 0
        inj, rec, wd = self.injector, self.recovery, self.watchdog
        nm = len(self._metric_names)
        nf = len(opt.telemetry_fields)
        gp = self.goodput
        if wd is not None:
            wd.arm("train", step=self.step)
        if gp is not None:
            # The first call: all since construction not yet attributed is
            # startup; a later call (fit()'s epochs) drops the gap.
            gp.train_started()
        try:
            for _ in range(num_iters // k):
                t0 = time.perf_counter()
                if self._degraded and self.step >= self._degrade_until:
                    self._end_degrade()
                if inj is not None:
                    inj.sleep_if_slow(self.step, self.step + k)
                    # Injected slowness is the taxonomy's wait.
                    self._mark("wait")
                staged = self._stage(k)
                self._mark("data")
                # What a skip restores: taken before an injected NaN.
                snap = self._snapshot() if rec is not None else None
                if inj is not None:
                    inj.poison_params(self.model.parameters(), self.step,
                                      self.step + k)
                # One profiled dispatch serves critpath and the calibrator,
                # at the JAX trainer's cadence.
                capture = ((self.calib is not None or cfg.obs_critpath)
                           and cfg.obs_calib_interval > 0
                           and (self.step + k) % cfg.obs_calib_interval < k)
                trace_dir = (tempfile.mkdtemp(prefix="gtopk-capture-")
                             if capture else None)
                outs = []
                with self.tracer.span("dispatch"), (
                        trace_attr.capture(trace_dir, self.rank) if capture
                        else contextlib.nullcontext()):
                    for batches in staged:
                        outs.append(self._step(batches))
                        self.step += 1
                    if capture:  # the device's work inside the trace
                        self._sync()
                step = self.step
                if gp is not None:
                    # The dispatch is step time, split by the latest
                    # critpath stage shares (all goodput before one).
                    gp.step_mark(begin=True, degraded=self._degraded)
                if capture:
                    self._attribute_capture(step, k, trace_dir)
                    # Host-side attribution is no category: other.
                    self._mark(None)
                obs_now = (opt.telemetry and cfg.obs_interval > 0
                           and step % cfg.obs_interval < k)
                # One device-to-host copy a dispatch: the steps' scalars
                # and, on an obs step, the counters.
                # The device-clock mark "end" follows the dispatch's last
                # device work before the read.
                vals = torch.stack([torch.stack(o) for o in outs])
                if obs_now:
                    with self.tracer.span("obs_read"):
                        flat = torch.cat([vals.reshape(-1),
                                          opt.state["telemetry"]])
                        self.tracer.mark("end")
                        host = flat.cpu()
                        scalars, max_age = self._log_obs(
                            step, host[k * nm:].tolist(), nf)
                else:
                    self.tracer.mark("end")
                    host = vals.reshape(-1).cpu()
                if cuda:
                    torch.cuda.synchronize(self.device)
                # The marks are complete: the gap before this dispatch.
                self.tracer.idle_split(k)
                dt = (time.perf_counter() - t0) / k
                step_times.extend([dt] * k)
                rows = host[:k * nm].view(k, nm)
                for name, col in zip(self._metric_names, rows.T.tolist()):
                    cols[name].extend(col)
                if self.kind == "lm":
                    for row in rows[:, -len(ROUTING_NAMES):].tolist():
                        self.tracer.note_routing(*row)
                samples += k * cfg.batch_size * cfg.nsteps_update
                observed = False
                if obs_now and self.monitor is not None:
                    # The read above synced the step: no extra device read.
                    self.monitor.observe(step, loss=cols["loss"][-1],
                                         telemetry=scalars,
                                         max_residual_age=max_age)
                    observed = True
                if step % cfg.log_interval < k:
                    row = dict(step=step,
                               epoch=(step - 1) // self.steps_per_epoch,
                               loss=cols["loss"][-1],
                               throughput=samples / (time.perf_counter()
                                                     - t_start))
                    row.update({name: cols[name][-1]
                                for name in self._metric_names[1:]})
                    if self.kind == "ptb":
                        row["ppl"] = float(np.exp(min(row["loss"], 20.0)))
                    self.metrics.log("train", **row)
                    self.tracer.flush(step)
                    if self.timeline is not None:
                        self.timeline.counter("train", row)
                    # The loss alone when the counters are off.
                    if self.monitor is not None and not observed:
                        self.monitor.observe(step, loss=row["loss"])
                        observed = True
                if gp is not None:
                    # The reads waited for the dispatch: step time too.
                    gp.step_mark(degraded=self._degraded)
                if rec is not None:
                    pending = rec.pop_pending()
                    if pending:
                        self._apply_recovery(pending, snap)
                    elif observed:
                        rec.note_ok()
                if wd is not None:
                    wd.heartbeat(step=self.step)
                if self.memwatch is not None:
                    # Recompiles and live memory, at the sync just paid;
                    # may raise AnomalyHalt after its records.
                    self.memwatch.poll(self.step)
                    self._mark("compile")
                if gp is not None:
                    # A "goodput" record every interval (a skip may have
                    # set the step back).
                    gp.tick(self.step)
                self._at_boundary(step - k, step)
        finally:
            if wd is not None:
                wd.disarm()
        wall = time.perf_counter() - t_start
        losses = cols["loss"]
        out = {
            "loss": losses[-1] if losses else float("nan"),
            "losses": losses,
            "step_times": step_times,
            "throughput": samples / wall if wall > 0 else 0.0,
            "wall": wall,
            "dispatch": self.dispatch,
        }
        for name in self._metric_names[1:]:
            out[name + "s"] = cols[name]
            out[name] = cols[name][-1] if cols[name] else float("nan")
        if self.kind == "ptb":
            out["ppl"] = float(np.exp(min(out["loss"], 20.0)))
        return out

    def _step(self, batches: List[Dict[str, torch.Tensor]]
              ) -> List[torch.Tensor]:
        """One step of a dispatch. The first step of a new batch shape is
        the port's compile (set-up the card does once: cuDNN, cuBLAS,
        lazy module loads): it runs eagerly between two syncs, timed as
        compile, and with ``obs_mem`` counted and logged (a "compile"
        record, ``MemWatch.account``)."""
        key = batch_shape_key(batches)
        if key in self._shape_keys:
            if self.dispatch == "graph":
                return self._graph_step(batches)
            return self._train_step(batches)
        if self.goodput is not None:
            self.goodput.step_mark(degraded=self._degraded)
        self._shape_keys.add(key)
        if self.memwatch is not None:
            out, _ = self.memwatch.account(
                lambda: self._train_step(batches), shape_key=key,
                step=self.step + 1)
        else:
            self._sync()
            out = self._train_step(batches)
            self._sync()
        self._mark("compile")
        return out

    def _attribute_capture(self, step: int, k: int, trace_dir: str) -> None:
        """Attribute the dispatch of `k` steps just profiled into
        `trace_dir` (``obs.trace_attr``): an "attr" record; at P > 1 its
        "ledger" row against the comm model; with ``obs_critpath`` one
        durable "critpath" record (the comm span wait-split against the
        modeled wire time of `k` steps), the goodput ledger's new stage
        shares and the critpath_shift rule; with the calibrator, its
        sample (``_feed_calibrator``). A failed attribution degrades to a
        warning, as in the JAX trainer; AnomalyHalt propagates."""
        cfg = self.cfg
        try:
            w = (critpath.modeled_wire_us(self.model_manifest,
                                          fit=self.comm_fit)
                 if cfg.obs_critpath and self.comm_fit else None)
            rec = trace_attr.attribute(
                trace_dir, mode=cfg.compression,
                stage_intervals=cfg.obs_critpath,
                wire_us=None if w is None else w * k)
        except Exception as e:
            self.logger.warning("trace attribution failed: %s", e)
            return
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        cp = rec.pop("critpath", None)
        rec.pop("trace_file", None)
        self.metrics.log("attr", step=step, n_steps=k, **rec)
        if self.comm_fit is not None:
            rows = ledger.ledger_rows(
                [{"kind": "attr", "step": step, "n_steps": k, **rec}],
                manifest=self.model_manifest, fit=self.comm_fit)
            for row in rows:
                self.metrics.log("ledger", **{key: v for key, v in
                                              row.items() if key != "rank"})
        if cp:
            self.metrics.log("critpath", flush=True, step=step, **cp)
            if self.goodput is not None:
                self.goodput.note_stage_fracs(cp)
            if self.forecaster is not None:
                # Before the shift rule, which may halt.
                self.forecaster.note_critpath(cp, spd=k)
            if self.monitor is not None:
                self.monitor.observe_critpath(
                    step, crit_stage=cp.get("crit_stage"))
        if self.calib is not None:
            self._feed_calibrator(step, k, rec)
        if self.forecaster is not None:
            # One "forecast" record a capture (durable), then
            # forecast_drift, which may halt.
            self.forecaster.observe(step)

    def _feed_calibrator(self, step: int, k: int, rec: Dict) -> None:
        """One (wire bytes, comm ms a step) sample of the captured
        dispatch to the calibrator, then the link map: the counters'
        wire bytes of its last step, its attributed comm over `k`. An
        overlapped pipeline's sample is quarantined (its comm is partly
        hidden). A refit and a link snapshot go to the forecaster."""
        t_comm_us = rec.get("t_comm_us")
        tel = self.optimizer.state.get("telemetry")
        if (not isinstance(t_comm_us, (int, float)) or t_comm_us <= 0
                or tel is None):
            return
        opt = self.optimizer
        wire = float(obs_counters.telemetry_scalars(
            tel[:len(opt.telemetry_fields)].tolist(),
            opt.telemetry_fields).get("wire_bytes", 0.0))
        if not math.isfinite(wire) or wire <= 0:
            return
        overlapped = (self.bucket_plan is not None
                      and self.bucket_plan.pipeline == "overlap")
        t_comm_ms = float(t_comm_us) / 1e3 / k
        calib_rec = self.calib.observe(step, wire_bytes=wire,
                                       t_comm_ms=t_comm_ms,
                                       overlapped=overlapped)
        lm_rec = None
        if self.linkmap is not None and not overlapped:
            lm_rec = self.linkmap.observe(step, t_comm_ms=t_comm_ms,
                                          wire_bytes=wire)
        if self.forecaster is not None:
            # The forecast reprices from what this capture refreshed.
            if calib_rec is not None:
                self.forecaster.note_calib(calib_rec)
            if lm_rec is not None:
                self.forecaster.note_linkmap(lm_rec)

    def _log_obs(self, step: int, values: List[float], nf: int):
        """The "obs" record of `step` from the counters' host copy
        `values` (``nf`` scalars, then the layers' rows), the "layers"
        records and the timeline's counter track. Returns the scalars and
        the largest mean residual age of a layer (None without layers),
        the monitor's feed."""
        opt = self.optimizer
        scalars = obs_counters.telemetry_scalars(values[:nf],
                                                 opt.telemetry_fields)
        self.metrics.log("obs", step=step, **scalars)
        max_age = None
        if opt.telemetry_layers:
            rows = obs_counters.layer_rows(values[nf:],
                                           len(self.layer_names))
            ages = rows["residual_age"]
            max_age = float(ages.max()) if ages.size else None
            for i, name in enumerate(self.layer_names):
                self.metrics.log("layers", step=step, layer=name,
                                 **{f: float(c[i]) for f, c in rows.items()})
        if self.timeline is not None:
            self.timeline.counter("obs", scalars)
        return scalars, max_age

    # ------------------------------------------------------ recovery
    def _snapshot_sources(self):
        """The live tensors a snapshot copies, in order -- the parameters
        and model buffers, SGD's momentum buffers that exist, the residual
        (and u), the counters and the age, the PTB carry -- and which
        parameters have a momentum buffer."""
        opt = self.optimizer
        params = list(self.model.parameters())
        moms = [opt.state.get(p, {}).get("momentum_buffer") for p in params]
        live = (params + list(self.model.buffers())
                + [b for b in moms if b is not None]
                + _leaves(opt.state["residual"])
                + [opt.state[key] for key in ("telemetry", "age")
                   if key in opt.state]
                + _leaves(self.carry))
        return live, tuple(b is not None for b in moms)

    @torch.no_grad()
    def _snapshot(self) -> Dict[str, object]:
        """A device copy of everything a step changes (``_snapshot_
        sources``), into buffers kept from one dispatch to the next, in a
        fused copy a dtype; with the step, the count, the dropout
        generator's state and which momentum buffers existed. Torch
        updates in place, so the live tensors are no snapshot."""
        live, has_momentum = self._snapshot_sources()
        bufs = self._snap_bufs
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [
                (t.shape, t.dtype) for t in live]:
            bufs = self._snap_bufs = [torch.empty_like(t) for t in live]
        _copy_all(bufs, live)
        return {"step": self.step, "count": self.optimizer.state["count"],
                "momentum": has_momentum,
                "dropout": (None if self.dropout_generator is None
                            else self.dropout_generator.get_state())}

    @torch.no_grad()
    def _restore_snapshot(self, snap: Dict[str, object]) -> None:
        """Put `snap` back into the live tensors (a captured graph keeps
        reading them): bitwise the state before the snapshot's dispatch.
        A momentum buffer SGD made in between is dropped again."""
        opt = self.optimizer
        for p, had in zip(self.model.parameters(), snap["momentum"]):
            if not had:
                opt.state.get(p, {}).pop("momentum_buffer", None)
        live, _ = self._snapshot_sources()
        _copy_all(live, self._snap_bufs)
        if snap["dropout"] is not None:
            self.dropout_generator.set_state(snap["dropout"])
        opt.state["count"] = snap["count"]
        self.step = snap["step"]

    def _apply_recovery(self, pending, snap) -> None:
        """Apply the actions claimed during this dispatch's observations
        (the JAX trainer's ``_apply_recovery``): skip restores the
        dispatch's snapshot; rollback the newest checkpoint, after a
        backoff that doubles with each use (none: halt); degrade runs the
        dense warm-up branch until ``param`` steps from now."""
        rec, opt = self.recovery, self.optimizer
        for event, spec in pending:
            rule = spec.rule
            if spec.action == "skip":
                self._restore_snapshot(snap)
                rec.consecutive_skips += 1
                if self.goodput is not None:
                    # The discarded update's step time was no progress.
                    self.goodput.wasted_step()
                rec.record("skip", self.step, rule,
                           consecutive=rec.consecutive_skips,
                           budget=spec.budget)
            elif spec.action == "rollback":
                if self._ckpt is None or not self._ckpt.all_steps():
                    self.logger.error(
                        "recovery: rollback for rule %s but no checkpoint "
                        "exists -- escalating to halt", rule)
                    raise AnomalyHalt(event)
                uses = rec.rollback_uses.get(rule, 0)
                wait = spec.param * (2 ** uses)
                rec.rollback_uses[rule] = uses + 1
                if wait > 0:
                    time.sleep(wait)
                self.restore()
                if self.goodput is not None:
                    # restore() marked its span ckpt (the backoff in it);
                    # the rewound step's time becomes wasted.
                    self.goodput.wasted_step()
                rec.record("rollback", self.step, rule, backoff_s=wait,
                           use=uses + 1, budget=spec.budget)
            elif spec.action == "degrade":
                if self._degraded:
                    continue
                # The dense branch of the same step over the same state.
                self._sparse_warmup = opt.warmup_dense_steps
                opt.warmup_dense_steps = 1 << 30
                self._degraded = True
                rec.degraded = True
                rec.degrade_episodes += 1
                self._degrade_until = self.step + int(spec.param)
                rec.record("degrade", self.step, rule,
                           until_step=self._degrade_until,
                           episode=rec.degrade_episodes, budget=spec.budget)

    def _end_degrade(self) -> None:
        """The degrade cooldown is over: back to the sparse step."""
        self.optimizer.warmup_dense_steps = self._sparse_warmup
        self._degraded = False
        if self.recovery is not None:
            self.recovery.degraded = False
            self.recovery.record("sparse_resume", step=self.step)

    # ------------------------------------------------------ the watchdog
    def _stall_diagnostics(self) -> Dict[str, object]:
        """Host state for the stall record: the span means of the current
        logging window. Never touches the device (presumed wedged)."""
        return {"phase_means_s": {
            path: round(sec, 6)
            for path, sec in self.tracer.stats.summary().items()}}

    def _on_stall(self, record: Dict[str, object]) -> None:
        """On the watchdog's thread, with the card presumed wedged: the
        "stall" record and the run's summary (final_status "stalled"),
        fsynced, the registry line, the timeline, then stderr and exit
        43. Nothing here touches the device, and ``os._exit`` skips every
        handler."""
        step = record.get("step", record.get("last_completed_step"))
        step = int(step) if isinstance(step, (int, float)) else 0
        try:
            self.metrics.log("stall", flush=True, **{
                key: v for key, v in record.items()
                if key not in ("kind", "time")})
            if self.goodput is not None:
                # The wall this run did spend before it wedged.
                self.goodput.log_record(step, final=True)
            self.metrics.log(
                "recovery", flush=True, action="summary",
                final_status="stalled", completed=0,
                n_recoveries=(self.recovery.n_recoveries
                              if self.recovery is not None else 0),
                step=step)
            self.metrics.close()
            self._append_registry()
        except Exception:
            pass
        if self.timeline is not None:
            try:
                self.timeline.instant("stall", args={
                    key: v for key, v in record.items()
                    if isinstance(v, (int, float, str))})
                self.timeline.write(self.cfg.obs_timeline)
            except Exception:
                pass
        _default_on_stall(record)

    # ------------------------------------------------------ resilience
    def _at_boundary(self, prev: int, new: int) -> None:
        """The dispatch of steps (prev, new] has run (a skip may have set
        the step back since): fire the injected preemption and resizes,
        then act on what the ranks agree on: an eviction (rank 0's
        self-check, ``_eviction_check``) resizes to P - 1 without the
        evicted rank; a stop resizes to P - 1 under elastic, else saves
        and exits 45."""
        inj = self.injector
        if inj is not None:
            inj.maybe_preempt(prev, new, self.preempt)
            new_p = inj.pending_resize(prev, new)
            if new_p is not None:
                self._injected_resize(new_p, reason="inject")
            rank = inj.pending_evict(prev, new)
            if rank is not None:
                self._injected_resize(self.cfg.nworkers - 1, reason="evict",
                                      evicted_ranks=(rank,))
        stop, evict = self._stop_requested(self._eviction_check(prev, new))
        if evict is not None:
            self._resize_now(self.cfg.nworkers - 1, reason="evict",
                             evicted_ranks=(evict,))
        if stop:
            if self.cfg.elastic:
                self._resize_now(self.cfg.nworkers - 1, reason="preempt")
            self._preempt_now()

    def _eviction_check(self, prev: int, new: int) -> Optional[int]:
        """Rank 0's eviction self-check (the JAX trainer's
        ``_maybe_evict``), under elastic with an out dir, when the
        dispatch (prev, new] crosses a multiple of ``obs_goodput_interval
        * evict_after_windows``: the rank that
        ``resilience.elastic.eviction_decision`` names on the merged
        shards of the out dir, or None. The merge reads the records of
        steps up to `prev` only: each rank wrote those before it joined
        the previous boundary's all-reduce, so the decision does not
        depend on how far a peer has got writing this dispatch's. A
        failing merge never stops the run: no eviction."""
        cfg = self.cfg
        every = cfg.obs_goodput_interval * cfg.evict_after_windows
        if not (cfg.elastic and cfg.out_dir and self.rank == 0
                and cfg.evict_after_windows > 0
                and cfg.obs_goodput_interval > 0 and new % every < new - prev):
            return None
        try:
            merged = fleet.merge([cfg.out_dir], through_step=prev)
            decision = eviction_decision(merged, p=cfg.nworkers,
                                         min_fleet=cfg.min_fleet)
        except Exception as e:
            self.logger.debug("elastic: eviction check skipped (%s: %s)",
                              type(e).__name__, e)
            return None
        if decision is None:
            return None
        self.logger.warning("elastic: eviction decision %s", decision)
        return int(decision["rank"])

    def _stop_requested(self, evict: Optional[int] = None):
        """(stop, evicted rank) as every rank agrees on them: at P > 1 one
        all-reduce (max) of one int, made only when a guard, an injector
        or elastic is there (all ranks have the same configuration, so
        all make it or none does). The int is 0, 1 for a preemption
        signalled on this rank, or 2 + r for rank 0's eviction of rank r
        (`evict`), which outranks a stop."""
        local = int(self.preempt is not None and self.preempt.triggered)
        if evict is not None:
            local = 2 + int(evict)
        if self.group is not None and (self.preempt is not None
                                       or self.injector is not None
                                       or self.cfg.elastic):
            nccl = dist.get_backend(self.group) == "nccl"
            flag = torch.tensor([local], dtype=torch.int32,
                                device=self.device if nccl else "cpu")
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            local = int(flag.item())
        if local >= 2:
            return False, local - 2
        return bool(local), None

    def _injected_resize(self, new_p: int, *, reason: str,
                         evicted_ranks=()) -> None:
        if not self.cfg.elastic:
            self.logger.warning("inject: %s to P=%d ignored: run without "
                                "--elastic", reason, new_p)
            return
        self._resize_now(new_p, reason=reason, evicted_ranks=evicted_ranks)

    def _preempt_now(self) -> None:
        """Save this step (every rank) and raise ``Preempted``."""
        step = self.step
        if self._ckpt is not None:
            self.save()
            self.metrics.log("recovery", flush=True,
                             action="emergency_save", step=step)
            self.logger.warning("preemption: emergency checkpoint at step "
                                "%d -> %s", step, self._ckpt.directory)
        else:
            self.logger.warning("preemption at step %d with no out_dir: "
                                "nothing saved", step)
        raise Preempted(f"preemption signal at step {step}")

    def _resize_now(self, new_p: int, *, reason: str,
                    evicted_ranks=()) -> None:
        """An elastic resize at this step: save (every rank), rank 0
        rewrites ``elastic.json`` for `new_p`, a flushed "resize" record,
        then ``ResizeRestart``. Below ``min_fleet`` a preemption falls
        back to the emergency save and exit 45, anything else to a
        warning; without an out dir there is nothing to hand on."""
        cfg, step, p = self.cfg, self.step, self.cfg.nworkers
        if new_p < max(1, cfg.min_fleet):
            self.logger.warning("elastic: refusing resize %d -> %d below "
                                "min_fleet=%d (%s)", p, new_p,
                                cfg.min_fleet, reason)
            if reason == "preempt":
                self._preempt_now()
            return
        if self._ckpt is None:
            self.logger.warning("elastic: resize (%s) at step %d with no "
                                "out_dir: nothing to hand the relaunch; "
                                "ignoring", reason, step)
            return
        self.save()
        evicted = [int(r) for r in evicted_ranks]
        lineage = dict(self.lineage or {})
        lineage.update(
            lineage_id=lineage.get("lineage_id") or mint_lineage_id(),
            resize_epoch=int(lineage.get("resize_epoch", 0)) + 1,
            prev_p=p, p=int(new_p), reason=reason, evicted_ranks=evicted,
            drained_step=step)
        if self.rank == 0:
            write_lineage(cfg.out_dir, **lineage)
        if self.group is not None:
            dist.barrier(group=self.group)  # the lineage is on disk
        self.lineage = lineage
        self.metrics.log(
            "resize", flush=True, step=step, old_p=p, new_p=int(new_p),
            reason=reason, evicted_ranks=evicted, drained_step=step,
            restore_step=step, lineage_id=lineage["lineage_id"],
            resize_epoch=lineage["resize_epoch"])
        self.logger.warning(
            "elastic resize (%s): p %d -> %d at step %d; relaunch with "
            "--resume --elastic --nworkers %d", reason, p, new_p, step,
            new_p)
        raise ResizeRestart(f"resize {p} -> {new_p} ({reason}) at step "
                            f"{step}")

    def finalize_resilience(self, status: str) -> None:
        """The run's closing "recovery" record (status: completed, halted,
        preempted, resized); none for a completed run without faults or a
        recovery policy."""
        if (self.injector is None and self.recovery is None
                and status == "completed"):
            return
        self.metrics.log(
            "recovery", flush=True, action="summary", final_status=status,
            completed=int(status == "completed"),
            n_recoveries=(0 if self.recovery is None
                          else self.recovery.n_recoveries),
            step=self.step,
            injected={} if self.injector is None
            else self.injector.summary())

    @torch.no_grad()
    def test(self) -> Dict[str, float]:
        """Validation metrics, the JAX trainer's ``test()``: in eval mode
        (BatchNorm on its running statistics, no dropout), over the first
        ``cfg.eval_batches`` batches of the test split (all when None),
        each batch's mean loss averaged with the batch sizes as weights,
        and by model:

        * vision: top-1 and top-5, averaged likewise;
        * ptb: ``val_ppl`` = exp(min(val_loss, 20)); the windows run in
          stream order with a fresh carry threaded through them;
        * an4: ``val_cer`` and ``val_wer``, corpus error rates of the
          greedy decode (``ctc.greedy_error_counts``).

        At P > 1 the ranks sum one float64 table of per-batch rows in which
        each rank filled its own rows and left zeros elsewhere (adding
        zeros is exact; the an4 counts are integers), so every rank
        returns what one rank doing every batch returns. Rank r makes and
        evaluates batches r, r + P, ...; PTB's windows depend on the carry
        of the window before, so rank 0 evaluates all of them."""
        cfg, model = self.cfg, self.model
        nb = self.val_data.steps_per_epoch()
        if cfg.eval_batches is not None:
            nb = min(nb, cfg.eval_batches)
        if nb == 0:
            return {"val_loss": float("nan")}
        cols = {"vision": 4, "ptb": 2, "an4": 6, "lm": 2}[self.kind]
        table = torch.zeros(nb, cols, dtype=torch.float64)
        if self.kind == "ptb":
            mine = range(nb) if self.rank == 0 else range(0)
            batches = self.val_data.epoch(0)
            train_carry = self.carry
            self.carry = model.initial_carry(cfg.batch_size)
        else:
            mine = range(self.rank, nb, cfg.nworkers)
            batches = self.val_data.epoch(0, mine)
        model.eval()
        try:
            for i, batch in zip(mine, batches):
                b = self._device_batch(batch)
                loss, metrics, logits = self._forward(b)
                row = [float(loss)]
                if self.kind == "an4":
                    row += greedy_error_counts(
                        logits.cpu().numpy(),
                        model.output_length(batch["input_lengths"]),
                        batch["labels"], batch["label_lengths"]).tolist()
                elif self.kind == "vision":
                    row += [float(metrics["top1"]), float(metrics["top5"])]
                table[i] = torch.tensor(row + [len(next(iter(
                    batch.values())))], dtype=torch.float64)
        finally:
            model.train()
            if self.kind == "ptb":
                self.carry = train_carry
        if self.group is not None:
            table = psum(table.to(self.device), group=self.group).cpu()
        t = table.numpy()
        size = t[:, -1]
        out = {"val_loss": float(np.average(t[:, 0], weights=size))}
        if self.kind == "vision":
            out["val_top1"] = float(np.average(t[:, 1], weights=size))
            out["val_top5"] = float(np.average(t[:, 2], weights=size))
        elif self.kind == "ptb":
            out["val_ppl"] = float(np.exp(min(out["val_loss"], 20.0)))
        elif self.kind == "an4":
            ce, chars, we, words = t[:, 1:5].sum(0)
            if chars > 0:
                out["val_cer"] = float(ce / chars)
                out["val_wer"] = float(we / max(1.0, words))
        self.metrics.log("eval", step=self.step, **out)
        # Evaluation is productive work: goodput, as in the JAX trainer.
        self._mark("goodput")
        return out

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, object]:
        """Train and evaluate epoch by epoch, from the epoch ``self.step``
        has reached (a restored run goes on where it stopped) up to
        `max_epochs` (default ``cfg.max_epochs``): the carry zeroed,
        ``steps_per_epoch`` steps less those already taken in a
        mid-epoch resume, ``test()``, an "epoch" record and, with an
        out dir, a checkpoint. Returns the last epoch's ``train``
        statistics and metrics."""
        k = self.cfg.steps_per_dispatch
        spe = self.steps_per_epoch
        if k > 1 and spe % k != 0:
            raise ValueError(
                f"steps_per_dispatch={k} must divide steps_per_epoch={spe} "
                "for epoch training (each dispatch runs K steps)")
        result: Dict[str, object] = {}
        for epoch in range(self.step // spe, max_epochs or self.cfg.max_epochs):
            if self.step % spe == 0:
                self.reset_carry()
            stats = self.train(spe - self.step % spe)
            result = {**stats, **self.test()}
            # The JAX trainer's epoch record: its train() result (loss,
            # throughput, wall, top-1) and the validation metrics.
            row = {key: result[key] for key in ("loss", "throughput",
                                                "wall", "top1", "top5")
                   if key in result}
            self.metrics.log("epoch", epoch=epoch, **row, **{
                key: v for key, v in result.items()
                if key.startswith("val_")})
            if self._ckpt is not None:
                self.save()
        return result

    # ------------------------------------------------------ checkpoints
    def checkpoint_state(self) -> Dict[str, torch.Tensor]:
        """This rank's whole training state as named tensors: the step,
        the model's parameters and BatchNorm statistics ("model."), the
        SGD momentum buffers ("momentum.", by parameter name; a buffer
        SGD has not made yet is saved as zeros, which is what its first
        step would start from no more than a missing one), the residual
        ("residual", or "residual.v" and "residual.u" under momentum
        correction) and the count, the counters ("telemetry": the audit's
        carried recall is state) and the residual age ("age") where the
        optimizer keeps them, the PTB carry, and the dropout generator's
        state."""
        opt = self.optimizer
        state = {"step": torch.tensor(self.step, dtype=torch.int64),
                 "count": torch.tensor(opt.state["count"],
                                       dtype=torch.int64)}
        for name, t in self.model.state_dict().items():
            state["model." + name] = t
        if opt.param_groups[0]["momentum"]:
            for name, p in self.model.named_parameters():
                buf = opt.state.get(p, {}).get("momentum_buffer")
                state["momentum." + name] = (torch.zeros_like(p)
                                             if buf is None else buf)
        res = opt.state["residual"]
        if isinstance(res, dict):
            state.update({f"residual.{key}": v for key, v in res.items()})
        else:
            state["residual"] = res
        for key in ("telemetry", "age"):
            if key in opt.state:
                state[key] = opt.state[key]
        for i, t in enumerate(_leaves(self.carry)):
            state[f"carry.{i}"] = t
        if self.dropout_generator is not None:
            state["dropout_rng"] = self.dropout_generator.get_state()
        return state

    def save(self) -> None:
        """Checkpoint this rank's state at ``self.step`` into
        ``out_dir/ckpt`` (collective at P > 1); nothing without an out
        dir."""
        if self._ckpt is not None:
            self._ckpt.save(self.step, self.checkpoint_state())
            self._mark("ckpt")

    def restore(self) -> bool:
        """Restore the newest checkpoint of ``out_dir/ckpt`` and
        fast-forward the data stream to its step (mid-epoch too; at a new
        P, this P's shards and epochs); False when there is none. Refuses
        a checkpoint of another config (unless ``allow_ckpt_mismatch``)
        or of another P unless ``elastic``, which re-partitions the
        residual (collective at P > 1). An injected ``corrupt_ckpt``
        tears the newest step first."""
        if self._ckpt is None:
            return False
        if self.injector is not None:
            # corrupt_ckpt@latest fires here, right before the read.
            if self.rank == 0:
                self.injector.maybe_corrupt_ckpt(self._ckpt.directory)
            if self.group is not None:
                dist.barrier(group=self.group)
        mine = self.checkpoint_state()
        saved = self._ckpt.restore(
            state_digest(mine), allow_mismatch=self.cfg.allow_ckpt_mismatch,
            device=self.device, elastic=self.cfg.elastic,
            rank_local=("dropout_rng", "carry."))
        if saved is None:
            return False
        if self._ckpt.last_restored_world != self.cfg.nworkers:
            # A rank the resize added keeps its own rank-local state.
            saved = {**mine, **saved}
            self.logger.warning(
                "elastic restore: residual re-partitioned %d -> %d ranks",
                self._ckpt.last_restored_world, self.cfg.nworkers)
        opt = self.optimizer
        self.model.load_state_dict(
            {name[len("model."):]: t for name, t in saved.items()
             if name.startswith("model.")})
        named = dict(self.model.named_parameters())
        for name, t in saved.items():
            if name.startswith("momentum."):
                opt.state[named[name[len("momentum."):]]][
                    "momentum_buffer"] = t
        if isinstance(opt.state["residual"], dict):
            opt.state["residual"] = {key: saved[f"residual.{key}"]
                                     for key in opt.state["residual"]}
        else:
            opt.state["residual"] = saved["residual"]
        opt.state["count"] = int(saved["count"])
        for key in ("telemetry", "age"):  # in place: fixed addresses
            if key in opt.state and key in saved:
                opt.state[key].copy_(saved[key])
        if self.carry is not None:
            flat = [saved[f"carry.{i}"] for i in range(len(_leaves(
                self.carry)))]
            self.carry = tuple((flat[2 * i], flat[2 * i + 1])
                               for i in range(len(flat) // 2))
        if self.dropout_generator is not None:
            self.dropout_generator.set_state(saved["dropout_rng"].cpu())
        self.step = int(saved["step"])
        self._graph = None
        # The restore drops the captured graphs: a recapture is expected.
        self._graph_keys.clear()
        self.logger.info("restored step %d from %s", self.step,
                         self._ckpt.directory)
        self._set_iters(self.step // self.steps_per_epoch,
                        skip_steps=self.step % self.steps_per_epoch)
        # The restore and the stream's fast-forward are checkpoint cost.
        self._mark("ckpt")
        return True


def _stop_prefetch(prefetcher: Prefetcher, stop: threading.Event) -> None:
    """End a prefetcher's wait on a ring slot, then close it."""
    stop.set()
    prefetcher.close()


def _copy_all(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """dst.copy_(src) for each pair, one fused copy a dtype."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, src in zip(dsts, srcs):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(src)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tensor, a dict of them, or nested tuples of them
    (None: none), in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    return [t for sub in tree for t in _leaves(sub)]
