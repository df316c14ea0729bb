"""The trainer: the port of ``gtopkssgd_tpu.trainer`` for P data-parallel
ranks, one process each.

``TrainConfig`` keeps the JAX trainer's flag names and per-dataset defaults
(cifar10: lr 0.1, weight decay 5e-4, no clip); ``Trainer.train(n)`` runs n
optimizer steps of the model on its dataset through
``optimizer.GTopKSGD``, with ``nsteps_update`` micro-batches accumulated
per step, the cifar10 step schedule (lr x0.1 at 50% and 75% of
``max_epochs``) behind an optional linear ramp over ``warmup_epochs``, and
``dense_warmup_epochs`` of dense exchange before the sparse one. Batches
cross to the device as uint8 NHWC and are normalized there. Float32
throughout: TF32 is switched off for convolutions and matrix products, as
the JAX model computes in float32.

At ``nworkers`` P > 1 the trainer is one rank of an initialized process
group of P ranks (``parallel.dist``): every rank builds the same initial
weights from the seed, draws its own shard of the data, and after each
step the ranks average the BatchNorm running statistics and the reported
loss and top-1, as the JAX trainer's ``pmean`` does.

A step is three profiler ranges (``torch.profiler.record_function``):
"data" (host batch + copy to the device), "forward_backward" and
"optimizer" (compression, the gradient exchange and SGD); ``profile_step``
reads them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from gtopkssgd_tpu_torch.convert import flat_layout
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.data.cifar import CIFAR_MEAN, CIFAR_STD
from gtopkssgd_tpu_torch.models import get_model
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.collectives import pmean

# dataset: (lr, weight_decay, clip_grad_norm) -- the reference hardcoded
# these per dataset.
_DATASET_DEFAULTS = {"cifar10": (0.1, 5e-4, None)}
_WIRE_STATS = {"cifar10": (CIFAR_MEAN, CIFAR_STD)}


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
                                          # | 'topk_allgather'
    density: float = 0.001
    topk_method: str = "auto"      # auto | exact | threshold | pallas |
                                   # twostage
    wire_codec: str = "fp32"       # fp32 | int8[:BLOCK] | fp8[:BLOCK]
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
    nworkers: int = 1
    data_dir: Optional[str] = None
    seed: int = 42
    device: str = "cuda"

    def resolved(self) -> "TrainConfig":
        cfg = dataclasses.replace(self)
        if cfg.dataset is None:
            cfg.dataset = get_model(cfg.dnn)[1].dataset
        lr, wd, clip = _DATASET_DEFAULTS.get(cfg.dataset, (0.1, 0.0, None))
        if cfg.lr is None:
            cfg.lr = lr
        if cfg.weight_decay is None:
            cfg.weight_decay = wd
        if cfg.clip_grad_norm is None:
            cfg.clip_grad_norm = clip
        return cfg


def shard_steps_per_epoch(ds, batch_size: int, nsteps_update: int = 1) -> int:
    """Optimizer steps per epoch, the same on every rank: the last rank's
    shard also holds the remainder, so the count comes from the smallest
    shard, (n // nworkers) // batch_size."""
    part = ds.partitioner
    return max(1, (part.n // part.nworkers) // batch_size // nsteps_update)


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
        self.model, self.spec = get_model(cfg.dnn)
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device).train()
        self.train_data = get_dataset(
            cfg.dataset, split="train", batch_size=cfg.batch_size,
            rank=self.rank, nworkers=cfg.nworkers, data_dir=cfg.data_dir,
            seed=cfg.seed)
        self.steps_per_epoch = shard_steps_per_epoch(
            self.train_data, cfg.batch_size, cfg.nsteps_update)
        self.layout = flat_layout(self.model)
        self.num_params = self.layout.n
        self.optimizer = self.make_optimizer()
        mean, std = _WIRE_STATS[cfg.dataset]
        self._mean = torch.as_tensor(mean, device=self.device)
        self._std = torch.as_tensor(std, device=self.device)
        self._batches = iter(self.train_data)
        self.step = 0

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
            warmup_dense_steps=warmup_dense_steps,
            momentum_correction=cfg.momentum_correction,
            _restore_rejected_u=cfg.restore_rejected_u,
            layout=self.layout, process_group=self.group)

    def lr_schedule(self):
        """lr(count) in float32, bitwise the JAX trainer's: the cifar10
        step schedule, x0.1 at 50% and 75% of max_epochs (boundaries that
        collide or land at step 0 dropped), constant for other datasets;
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
        cfg = self.cfg
        if cfg.dataset != "cifar10":
            return lambda count: float(base)
        bounds = sorted({int(cfg.max_epochs * f) * self.steps_per_epoch
                         for f in (0.5, 0.75)} - {0})

        def schedule(count: int) -> float:
            v = base
            for b in bounds:
                if count >= b:
                    v = v * np.float32(0.1)
            return float(v)

        return schedule

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        x = torch.from_numpy(batch["image"]).to(self.device)
        y = torch.from_numpy(batch["label"]).to(self.device).long()
        x = (x.float() / 255.0 - self._mean) / self._std
        return x, y

    @torch.no_grad()
    def _average_over_ranks(self, loss: torch.Tensor,
                            top1: torch.Tensor):
        """One all-reduce averages the BatchNorm running statistics, the
        loss and the top-1 over the ranks; returns (loss, top1)."""
        bufs = list(self.model.buffers())
        flat = torch.cat([b.reshape(-1) for b in bufs]
                         + [loss.reshape(1), top1.reshape(1)])
        flat = pmean(flat, group=self.group)
        off = 0
        for b in bufs:
            b.copy_(flat[off:off + b.numel()].view_as(b))
            off += b.numel()
        return flat[off], flat[off + 1]

    def train(self, num_iters: int) -> Dict[str, object]:
        """Run `num_iters` optimizer steps. Returns the last step's loss and
        top-1, the per-step lists, the per-step wall times (each step ends
        in a device sync on CUDA) and the throughput in samples/s."""
        cfg, model, opt = self.cfg, self.model, self.optimizer
        cuda = self.device.type == "cuda"
        losses: List[torch.Tensor] = []
        top1s: List[torch.Tensor] = []
        step_times: List[float] = []
        t_start = time.perf_counter()
        for _ in range(num_iters):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss_sum = top1_sum = 0.0
            for _ in range(cfg.nsteps_update):
                with record_function("data"):
                    x, y = self._device_batch(next(self._batches))
                with record_function("forward_backward"):
                    logits = model(x)
                    loss = F.cross_entropy(logits, y)
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
                top1_sum = top1_sum + (logits.argmax(-1) == y).float().mean()
            with record_function("optimizer"):
                if cfg.nsteps_update > 1:
                    for p in model.parameters():
                        p.grad.div_(cfg.nsteps_update)
                opt.step()
            loss, top1 = (loss_sum / cfg.nsteps_update,
                          top1_sum / cfg.nsteps_update)
            if self.group is not None:
                loss, top1 = self._average_over_ranks(loss, top1)
            losses.append(loss)
            top1s.append(top1)
            if cuda:
                torch.cuda.synchronize(self.device)
            step_times.append(time.perf_counter() - t0)
            self.step += 1
        wall = time.perf_counter() - t_start
        loss_list = [float(v) for v in losses]
        top1_list = [float(v) for v in top1s]
        return {
            "loss": loss_list[-1] if loss_list else float("nan"),
            "top1": top1_list[-1] if top1_list else float("nan"),
            "losses": loss_list,
            "top1s": top1_list,
            "step_times": step_times,
            "throughput": (num_iters * cfg.batch_size * cfg.nsteps_update
                           / wall) if wall > 0 else 0.0,
        }
