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

A step is three profiler ranges (``torch.profiler.record_function``):
"data" (host batch + copy to the device), "forward_backward" and
"optimizer" (compression, the gradient exchange and SGD); ``profile_step``
reads them.

The lifecycle and the host path (the JAX trainer's):

* ``dtype="bfloat16"``: the model computes in bfloat16 with flax's
  ``dtype=`` semantics (``models.layers``); parameters, gradients, the
  selection, the wire and the optimizer stay float32.
* Host batches come from the stream ``_set_iters(epoch, skip_steps)``
  builds (epoch by epoch, fast-forwarded to a restored step mid-epoch
  too), assembled ``prefetch`` batches ahead on a background thread
  (``utils.prefetch``; numpy only there), and cross to the card from
  pinned memory without blocking.
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
  batches, copies them to the card in one transfer per field, runs the K
  steps and syncs once; ``train(n)`` needs n to be a multiple of K, and
  the steps are those of K = 1, step for step. How a dispatch runs the
  steps (``dispatch``) is decided at construction by a stated rule
  (``dispatch_rule``): on the card at P = 1 with ``dense``, ``gtopk`` or
  ``gtopk_layerwise`` under the ``serial`` pipeline, a selection method
  of ``exact`` (``auto``), ``twostage`` or ``pallas``, and a model whose
  loss reads no lengths back to the host (not AN4's CTC), one step is
  captured in a ``torch.cuda.CUDAGraph`` and replayed ("graph");
  everywhere else the steps run one after another ("staged"). See
  ``_graph_step`` for what the graph holds and when a step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from gtopkssgd_tpu_torch import native
from gtopkssgd_tpu_torch.convert import flat_layout
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
from gtopkssgd_tpu_torch.ops import cuda_topk
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.collectives import pmean, psum
from gtopkssgd_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    state_digest,
)
from gtopkssgd_tpu_torch.utils.manifest import config_hash, run_manifest
from gtopkssgd_tpu_torch.utils.metrics import MetricsLogger
from gtopkssgd_tpu_torch.utils.prefetch import Prefetcher

_WIRE_STATS = {"cifar10": (CIFAR_MEAN, CIFAR_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}
# The compressions and selection methods whose P = 1 step holds no host
# sync, so it can be captured in a CUDA graph (``dispatch_rule``).
GRAPH_MODES = (None, "none", "dense", "gtopk", "gtopk_layerwise")
GRAPH_METHODS = ("auto", "exact", "twostage", "pallas")


def dataset_defaults(dataset: str, dnn: str):
    """(lr, weight_decay, clip_grad_norm) by dataset, as the reference
    hardcoded them; AlexNet on imagenet starts at lr 0.01."""
    return {
        "cifar10": (0.1, 5e-4, None),
        "imagenet": (0.01 if dnn == "alexnet" else 0.1, 1e-4, None),
        "ptb": (1.0, 0.0, 0.25),
        "an4": (3e-4, 0.0, 400.0),
    }.get(dataset, (0.1, 0.0, None))


@dataclasses.dataclass
class TrainConfig:
    """The part of the JAX trainer's flag set the port implements."""

    dnn: str = "resnet20"
    dataset: Optional[str] = None  # default: the model's canonical dataset
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
    topk_method: str = "auto"      # auto | exact | threshold | pallas |
                                   # twostage
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
    resume: bool = False           # restore out_dir/ckpt at construction
    allow_ckpt_mismatch: bool = False  # restore past a config hash or
                                   # state digest that differs
    prefetch: int = 2              # host batches assembled ahead by a
                                   # background thread (0 = synchronous)
    steps_per_dispatch: int = 1    # optimizer steps a dispatch: K host
                                   # batches staged in one transfer, one
                                   # sync; a CUDA graph replayed K times
                                   # where ``dispatch_rule`` allows
    device: str = "cuda"

    def resolved(self) -> "TrainConfig":
        """The config with the dataset's defaults filled in; refuses a
        gtopk_hier slice width that does not divide the ranks, and the
        JAX trainer's invalid values."""
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch={self.steps_per_dispatch}"
                             " must be >= 1")
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
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model, self.spec = get_model(
            cfg.dnn, space_to_depth=cfg.space_to_depth, dtype=cfg.dtype)
        self.kind = cfg.dataset if self.spec.recurrent else "vision"
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device).train()
        # The JAX trainer folds the rank into its dropout key: the ranks
        # draw different masks.
        self.dropout_generator = seed_dropout(
            self.model, int(np.random.SeedSequence(
                [cfg.seed, self.rank]).generate_state(1)[0]))
        data_kw = dict(batch_size=cfg.batch_size, data_dir=cfg.data_dir,
                       seed=cfg.seed)
        if cfg.dataset == "cifar10" and cfg.synth_hard:
            data_kw["synth_hard"] = True
        self.train_data = get_dataset(
            cfg.dataset, split="train", rank=self.rank,
            nworkers=cfg.nworkers, **data_kw)
        self.val_data = get_dataset(cfg.dataset, split="test", **data_kw)
        self.steps_per_epoch = shard_steps_per_epoch(
            self.train_data, cfg.batch_size, cfg.nsteps_update)
        self.layout = flat_layout(self.model)
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
        #: What a step reports, in ``_train_step``'s order.
        self._metric_names = (["loss", "top1", "top5"]
                              if self.kind == "vision" else ["loss"])
        #: "graph" or "staged" (``dispatch_rule``).
        self.dispatch = dispatch_rule(cfg)
        #: Graph bookkeeping: captures made, replays run, and per kernel
        #: counter the launches recorded in captures (the wrappers count
        #: a launch when they record it; a replay runs them again
        #: uncounted) and the launches replays ran.
        self.graph_stats = {"captures": 0, "replays": 0,
                            "captured": {}, "replayed": {}}
        self.logger = logging.getLogger("gtopkssgd_tpu_torch.trainer")
        self.metrics = MetricsLogger(cfg.out_dir, rank=self.rank,
                                     shard=cfg.nworkers > 1)
        backend = None if self.group is None else dist.get_backend(self.group)
        self.manifest = run_manifest(
            self._identity(), device=self.device, backend=backend,
            world_size=cfg.nworkers, num_params=self.num_params,
            steps_per_epoch=self.steps_per_epoch,
            native_dataprep=native.available(), dispatch=self.dispatch,
            dtype=cfg.dtype)
        self.metrics.log("manifest", flush=True, **self.manifest)
        if self.plan_decision is not None:
            self.metrics.log("plan", flush=True,
                             **self.plan_decision.record())
        if self.bucket_plan is not None:
            self.metrics.log("bucket", flush=True,
                             **self.bucket_plan.to_manifest())
        # The checkpoint's config hash nulls what does not change the
        # experiment (the JAX trainer's nulled fields, and resume).
        self._ckpt = None
        if cfg.out_dir:
            self._ckpt = CheckpointManager(
                f"{cfg.out_dir}/ckpt", config_hash=config_hash(
                    self._identity(allow_ckpt_mismatch=False,
                                   resume=False)),
                rank=self.rank, group=self.group, logger=self.logger)
        self._prefetch = None
        self._set_iters(start_epoch=0)
        if cfg.resume:
            self.restore()

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
            # The closure holds the iterator, not the trainer. A dispatch
            # takes K steps' batches at once: the thread keeps at least
            # that many ready, assembling the next dispatch's while the
            # card runs this one.
            cfg = self.cfg
            depth = max(cfg.prefetch, cfg.steps_per_dispatch
                        * cfg.nsteps_update)
            self._prefetch = Prefetcher(lambda: next(it), depth=depth)
            self._finalizer = weakref.finalize(self, self._prefetch.close)

    def _close_prefetch(self) -> None:
        if getattr(self, "_prefetch", None) is not None:
            self._finalizer.detach()
            self._prefetch.close()
            self._prefetch = None

    def close(self) -> None:
        """Stop the prefetcher and the optimizer's merge thread. Training
        goes on only through ``restore()`` or a new Trainer; ``test()``
        is unaffected. The metrics file stays open until ``__exit__``."""
        self._close_prefetch()
        self._iter = None
        self.optimizer.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        self.metrics.close()

    def _next_host(self) -> Dict[str, np.ndarray]:
        """The next host micro-batch of the stream."""
        if self._iter is None:
            raise RuntimeError("Trainer is closed; build a new Trainer "
                               "(restore() reopens it from a checkpoint)")
        return next(self._prefetch) if self._prefetch is not None \
            else next(self._iter)

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The host arrays on the device as they are; on the card from
        pinned memory, without blocking (the caching host allocator
        keeps a pinned block until its copy has run)."""
        out = {}
        for key, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
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
        elif self.kind == "ptb":
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
            with record_function("forward_backward"):
                loss, metrics, _ = self._forward(self._prepare(raw))
                loss.backward()
            values = [loss.detach()] + [metrics[key]
                                        for key in self._metric_names[1:]]
            sums = values if sums is None else [
                a + b for a, b in zip(sums, values)]
        with record_function("optimizer"):
            if cfg.nsteps_update > 1:
                for p in self.model.parameters():
                    p.grad.div_(cfg.nsteps_update)
            opt.step()
        scalars = [v / cfg.nsteps_update for v in sums]
        if self.group is not None:
            scalars = self._average_over_ranks(scalars)
        return scalars

    def _stage(self, k: int) -> List[List[Dict[str, torch.Tensor]]]:
        """The next `k` steps' micro-batches, staged: the host batches
        stacked per field and copied to the device in one transfer each;
        returns per step its list of micro-batches (views)."""
        m = self.cfg.nsteps_update
        with record_function("data"):
            hosts = [self._next_host() for _ in range(k * m)]
            stacked = self._to_device({
                key: np.stack([h[key] for h in hosts]) if len(hosts) > 1
                else hosts[0][key][None] for key in hosts[0]})
        return [[{key: v[i * m + j] for key, v in stacked.items()}
                 for j in range(m)] for i in range(k)]

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
        as the constant it is: ``torch.optim.SGD`` reads a tensor lr back
        to the host (``_to_scalar``, a sync), and its fused kernel rounds
        differently from the foreach path, so the update keeps the eager
        step's arithmetic and a graph is captured anew when the schedule's
        lr changes (the step schedules change it at a few epoch boundaries).
        A step runs eagerly, not in the graph, below ``_eager_until()``
        (the dense warm-up's branch, the lr ramp) and while SGD has no
        momentum buffers yet (its first step makes them). The dropout
        generator is registered with the graph, so each replay draws the
        masks the eager step would."""
        opt = self.optimizer
        count = opt.state["count"]
        lr = float(opt.schedule(count)) if opt.schedule else None
        fresh = opt.param_groups[0]["momentum"] and any(
            "momentum_buffer" not in opt.state.get(p, {})
            for p in self.model.parameters())
        if count < self._eager_until() or fresh:
            return self._train_step(batches)
        if self._graph is None or self._graph["lr"] != lr:
            self._capture(batches, lr)
        g = self._graph
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

    def _capture(self, batches: List[Dict[str, torch.Tensor]],
                 lr: Optional[float]) -> None:
        """Capture one step in a new CUDA graph (replacing the last one),
        with host syncs made errors while it records."""
        opt = self.optimizer
        if self._graph is not None:
            self._graph["graph"].reset()
        self._graph = None
        inputs = [{key: v.clone() for key, v in b.items()} for b in batches]
        residual, carry = opt.state["residual"], self.carry
        count = opt.state["count"]
        graph = torch.cuda.CUDAGraph()
        if self.dropout_generator is not None:
            graph.register_generator_state(self.dropout_generator)
        before = dict(cuda_topk.launches)
        with torch.cuda.graph(graph):
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
        self._graph = {"graph": graph, "lr": lr, "inputs": inputs,
                       "outputs": outputs, "launches": launches}

    def train(self, num_iters: int) -> Dict[str, object]:
        """Run `num_iters` optimizer steps, ``steps_per_dispatch`` K at a
        time (`num_iters` must be a multiple of K). Returns the last
        step's loss (and top-1 for the vision models, perplexity exp(min(
        loss, 20)) for PTB), the per-step lists, the per-step wall times
        (each dispatch ends in a device sync on CUDA; a step of a K-step
        dispatch is given 1/K of it), the throughput in samples/s and
        ``dispatch``. A "train" record goes to the metrics file whenever
        a dispatch crosses a multiple of ``log_interval``, with the epoch
        its last step belongs to."""
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
        cols: Dict[str, List[float]] = {name: []
                                         for name in self._metric_names}
        step_times: List[float] = []
        t_start = time.perf_counter()
        samples = 0
        for _ in range(num_iters // k):
            t0 = time.perf_counter()
            outs = []
            for batches in self._stage(k):
                if self.dispatch == "graph":
                    outs.append(self._graph_step(batches))
                else:
                    outs.append(self._train_step(batches))
                self.step += 1
            # One sync a dispatch: the scalars come back together.
            host = torch.stack([torch.stack(o) for o in outs]).cpu()
            if cuda:
                torch.cuda.synchronize(self.device)
            dt = (time.perf_counter() - t0) / k
            step_times.extend([dt] * k)
            for name, col in zip(self._metric_names, host.T.tolist()):
                cols[name].extend(col)
            samples += k * cfg.batch_size * cfg.nsteps_update
            if self.step % cfg.log_interval < k:
                row = dict(step=self.step,
                           epoch=(self.step - 1) // self.steps_per_epoch,
                           loss=cols["loss"][-1],
                           throughput=samples / (time.perf_counter()
                                                 - t_start))
                row.update({name: cols[name][-1]
                            for name in self._metric_names[1:]})
                if self.kind == "ptb":
                    row["ppl"] = float(np.exp(min(row["loss"], 20.0)))
                self.metrics.log("train", **row)
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
        cols = {"vision": 4, "ptb": 2, "an4": 6}[self.kind]
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
        else:
            ce, chars, we, words = t[:, 1:5].sum(0)
            if chars > 0:
                out["val_cer"] = float(ce / chars)
                out["val_wer"] = float(we / max(1.0, words))
        self.metrics.log("eval", step=self.step, **out)
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
        correction) and the count, the PTB carry, and the dropout
        generator's state."""
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

    def restore(self) -> bool:
        """Restore the newest checkpoint of ``out_dir/ckpt`` and
        fast-forward the data stream to its step (mid-epoch too); False
        when there is none. Refuses a checkpoint of another config (unless
        ``allow_ckpt_mismatch``) or another P (collective at P > 1)."""
        if self._ckpt is None:
            return False
        mine = self.checkpoint_state()
        saved = self._ckpt.restore(
            state_digest(mine), allow_mismatch=self.cfg.allow_ckpt_mismatch,
            device=self.device)
        if saved is None:
            return False
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
        if self.carry is not None:
            flat = [saved[f"carry.{i}"] for i in range(len(_leaves(
                self.carry)))]
            self.carry = tuple((flat[2 * i], flat[2 * i + 1])
                               for i in range(len(flat) // 2))
        if self.dropout_generator is not None:
            self.dropout_generator.set_state(saved["dropout_rng"].cpu())
        self.step = int(saved["step"])
        self._graph = None
        self.logger.info("restored step %d from %s", self.step,
                         self._ckpt.directory)
        self._set_iters(self.step // self.steps_per_epoch,
                        skip_steps=self.step % self.steps_per_epoch)
        return True


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
