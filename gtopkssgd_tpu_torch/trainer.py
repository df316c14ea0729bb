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
does.

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
from gtopkssgd_tpu_torch.ctc import ctc_loss, greedy_error_counts
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.data.cifar import CIFAR_MEAN, CIFAR_STD
from gtopkssgd_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from gtopkssgd_tpu_torch.models import get_model, model_spec, seed_dropout
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel.collectives import pmean, psum

_WIRE_STATS = {"cifar10": (CIFAR_MEAN, CIFAR_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}


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
    space_to_depth: bool = False   # resnet50: the space-to-depth stem
    eval_batches: Optional[int] = None  # cap on test()'s batches
    nworkers: int = 1
    data_dir: Optional[str] = None
    seed: int = 42
    device: str = "cuda"

    def resolved(self) -> "TrainConfig":
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
            cfg.dnn, space_to_depth=cfg.space_to_depth)
        self.kind = cfg.dataset if self.spec.recurrent else "vision"
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device).train()
        # The JAX trainer folds the rank into its dropout key: the ranks
        # draw different masks.
        seed_dropout(self.model, int(np.random.SeedSequence(
            [cfg.seed, self.rank]).generate_state(1)[0]))
        data_kw = dict(batch_size=cfg.batch_size, data_dir=cfg.data_dir,
                       seed=cfg.seed)
        self.train_data = get_dataset(
            cfg.dataset, split="train", rank=self.rank,
            nworkers=cfg.nworkers, **data_kw)
        self.val_data = get_dataset(cfg.dataset, split="test", **data_kw)
        self.steps_per_epoch = shard_steps_per_epoch(
            self.train_data, cfg.batch_size, cfg.nsteps_update)
        self.layout = flat_layout(self.model)
        self.num_params = self.layout.n
        self.optimizer = self.make_optimizer()
        if self.kind == "vision":
            mean, std = _WIRE_STATS[cfg.dataset]
            self._mean = torch.as_tensor(mean, device=self.device)
            self._std = torch.as_tensor(std, device=self.device)
        self.carry = None
        self.reset_carry()
        self._batches = iter(self.train_data)
        self.step = 0

    def reset_carry(self) -> None:
        """Zero the PTB model's carry (each epoch restarts every stream
        row); the other models carry nothing (None)."""
        if self.kind == "ptb":
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

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """The host batch on the device: images normalized to float32,
        tokens and labels as int64 indices, the rest as it is."""
        out = {key: torch.from_numpy(np.asarray(v)).to(self.device)
               for key, v in batch.items()}
        if self.kind == "vision":
            out["image"] = (out["image"].float() / 255.0
                            - self._mean) / self._std
            out["label"] = out["label"].long()
        elif self.kind == "ptb":
            out = {key: v.long() for key, v in out.items()}
        return out

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
        return loss, {"top1": (logits.argmax(-1) == y).float().mean()}, logits

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

    def train(self, num_iters: int) -> Dict[str, object]:
        """Run `num_iters` optimizer steps. Returns the last step's loss
        (and top-1 for the vision models, perplexity exp(min(loss, 20))
        for PTB), the per-step lists, the per-step wall times (each step
        ends in a device sync on CUDA) and the throughput in samples/s."""
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
                    batch = self._device_batch(next(self._batches))
                with record_function("forward_backward"):
                    loss, metrics, _ = self._forward(batch)
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
                if "top1" in metrics:
                    top1_sum = top1_sum + metrics["top1"]
            with record_function("optimizer"):
                if cfg.nsteps_update > 1:
                    for p in model.parameters():
                        p.grad.div_(cfg.nsteps_update)
                opt.step()
            scalars = [loss_sum / cfg.nsteps_update]
            if self.kind == "vision":
                scalars.append(top1_sum / cfg.nsteps_update)
            if self.group is not None:
                scalars = self._average_over_ranks(scalars)
            losses.append(scalars[0])
            top1s.extend(scalars[1:])
            if cuda:
                torch.cuda.synchronize(self.device)
            step_times.append(time.perf_counter() - t0)
            self.step += 1
        wall = time.perf_counter() - t_start
        loss_list = [float(v) for v in losses]
        out = {
            "loss": loss_list[-1] if loss_list else float("nan"),
            "losses": loss_list,
            "step_times": step_times,
            "throughput": (num_iters * cfg.batch_size * cfg.nsteps_update
                           / wall) if wall > 0 else 0.0,
        }
        if self.kind == "vision":
            out["top1s"] = [float(v) for v in top1s]
            out["top1"] = out["top1s"][-1] if top1s else float("nan")
        elif self.kind == "ptb":
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
                    top5 = logits.topk(min(5, logits.shape[-1]),
                                       dim=-1).indices
                    row += [float(metrics["top1"]), float(
                        (top5 == b["label"][:, None]).any(-1).float().mean())]
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
        return out

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, object]:
        """Train and evaluate epoch by epoch, from the epoch ``self.step``
        has reached up to `max_epochs` (default ``cfg.max_epochs``): the
        carry zeroed, ``steps_per_epoch`` steps, then ``test()``. Returns
        the last epoch's ``train`` statistics and metrics."""
        result: Dict[str, object] = {}
        for _ in range(self.step // self.steps_per_epoch,
                       max_epochs or self.cfg.max_epochs):
            self.reset_carry()
            result = {**self.train(self.steps_per_epoch), **self.test()}
        return result
