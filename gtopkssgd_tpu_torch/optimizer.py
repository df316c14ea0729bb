"""gTop-k S-SGD: error-feedback top-k compression of the flat gradient,
the gTop-k all-reduce over P ranks, then SGD with momentum and weight
decay.

Counterpart of the flat path of ``gtopkssgd_tpu.optimizer.gtopk_sgd``
(``update_fn``, modes ``dense`` and ``gtopk``). One step:

1. ravel every parameter's gradient into one flat f32[N] buffer, in the
   order and layout of the JAX package's ``ravel_pytree`` (``FlatLayout``;
   ``convert.flat_layout`` builds it for a model) -- top-k buckets are
   positions in this vector, so the order decides what is selected;
2. ``gtopk`` at P = 1: acc = grad + residual; keep = |acc| >= tau by the
   threshold-mask compressor (the selection reads grad and residual
   unfused); residual = where(keep, 0, acc); the update is acc - residual.
   ``gtopk`` at P > 1: the local set (vals, idx) = compress(acc) in index
   form, through ``select_topk``; the global set (gvals, gidx) by the
   hypercube merge; rejected local picks go back into the residual
   (``repair``); the update is scatter_add_dense(gidx, gvals) / P.
   ``dense``: the update is the gradient, all-reduced and divided by P;
3. unravel the update into the parameters' ``.grad`` and take one
   ``torch.optim.SGD`` step: g + wd*p, then buf = momentum*buf + g, then
   p -= lr*buf -- the arithmetic of the JAX package's
   ``add_decayed_weights(wd)`` + ``sgd(momentum)`` chain, applied to every
   parameter, BatchNorm scale and bias included.

The residual and the step count live in the optimizer's ``state`` (keys
"residual" and "count"), so ``state_dict()`` saves error feedback.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.compression import get_compressor
from gtopkssgd_tpu_torch.modes import ALL_MODES, DENSE_MODES
from gtopkssgd_tpu_torch.ops import scatter_add_dense
from gtopkssgd_tpu_torch.parallel.collectives import (
    dense_allreduce,
    sparse_allreduce,
)

Schedule = Callable[[int], float]


class FlatLayout:
    """Map between a list of parameters and one flat f32[N] vector.

    Entry i is (param, perm): its segment of the flat vector is
    ``param.permute(perm).reshape(-1)``, segments back to back in list
    order. ``perm`` turns the port's tensor layout into the reference's
    (conv OIHW -> HWIO is (2, 3, 1, 0), Linear (out, in) -> (in, out) is
    (1, 0)); the identity keeps a tensor as it is.
    """

    def __init__(self, entries: Sequence[Tuple[torch.Tensor,
                                               Tuple[int, ...]]]):
        self.params: List[torch.Tensor] = [p for p, _ in entries]
        self.perms = [tuple(perm) for _, perm in entries]
        self.shapes = [tuple(p.permute(perm).shape) for p, perm in entries]
        self.inverse = [tuple(sorted(range(len(perm)), key=perm.__getitem__))
                        for perm in self.perms]
        self.sizes = [p.numel() for p in self.params]
        self.offsets, off = [], 0
        for s in self.sizes:
            self.offsets.append(off)
            off += s
        self.n = off

    @classmethod
    def identity(cls, params: Iterable[torch.Tensor]) -> "FlatLayout":
        return cls([(p, tuple(range(p.dim()))) for p in params])

    def _segments(self, flat: torch.Tensor):
        for off, size, shape in zip(self.offsets, self.sizes, self.shapes):
            yield flat[off:off + size].view(shape)

    def ravel(self, tensors: Sequence[Optional[torch.Tensor]],
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Flatten `tensors` (shaped like the params; None = zeros)."""
        if out is None:
            out = torch.empty(self.n, dtype=torch.float32,
                              device=self.params[0].device)
        for seg, t, perm in zip(self._segments(out), tensors, self.perms):
            if t is None:
                seg.zero_()
            else:
                seg.copy_(t.permute(perm))
        return out

    def unravel_into(self, flat: torch.Tensor,
                     targets: Sequence[torch.Tensor]) -> None:
        """Copy each segment of `flat` into the matching target tensor."""
        for seg, t, inv in zip(self._segments(flat), targets, self.inverse):
            t.copy_(seg.permute(inv))


class GTopKSGD(torch.optim.SGD):
    """SGD (momentum, weight decay) on the gTop-k-compressed gradient.

    ``lr`` is a float or a schedule ``lr(count)`` read before every step,
    count being the number of steps taken. ``layout`` fixes the flat order
    (default: ``params`` in the given order, each raveled as it is).
    ``process_group`` is the group of the P data-parallel ranks, or None
    for one worker.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: Union[float, Schedule],
        *,
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        compression: Optional[str] = "gtopk",
        density: float = 0.001,
        topk_method: str = "auto",
        layout: Optional[FlatLayout] = None,
        process_group=None,
    ):
        if compression not in ALL_MODES:
            raise ValueError(
                f"compression {compression!r} is not in the port yet; "
                f"it has {ALL_MODES}")
        params = list(params)
        self.schedule = lr if callable(lr) else None
        super().__init__(params, lr=float(lr(0)) if callable(lr) else lr,
                         momentum=momentum, weight_decay=weight_decay)
        self.layout = layout or FlatLayout.identity(params)
        if {id(p) for p in self.layout.params} != {id(p) for p in params}:
            raise ValueError("layout does not cover exactly these params")
        self.compressor = get_compressor(compression, density, topk_method)
        self.mode = compression
        self.dense_mode = compression in DENSE_MODES
        self.group = process_group
        self.p = 1
        if process_group is not None:
            self.p = dist.get_world_size(process_group)
        device = params[0].device
        self.state["residual"] = self.compressor.init_residual(
            self.layout.n, device)
        self.state["count"] = 0
        #: The flat gradient of the last step (one buffer, reused).
        self.flat_grad = torch.empty(self.layout.n, dtype=torch.float32,
                                     device=device)
        #: The keep mask of the last gtopk step at P = 1.
        self.last_keep: Optional[torch.Tensor] = None
        #: The last gtopk step's local (vals, idx) and global (gvals, gidx)
        #: sets at P > 1.
        self.last_local: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.last_global: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def compress(self, flat: torch.Tensor) -> torch.Tensor:
        """The update for flat gradient `flat`, averaged over the P ranks;
        advances the residual."""
        p = self.p
        if self.dense_mode:
            if p == 1:
                return flat
            return dense_allreduce(flat, group=self.group) / p
        residual_in = self.state["residual"]
        acc = self.compressor.accumulate(flat, residual_in)
        if p == 1:
            keep, residual, _ = self.compressor.compress_by_threshold(
                acc, grad=flat, residual=residual_in)
            self.state["residual"] = residual
            self.last_keep = keep
            return acc - residual
        n = flat.shape[0]
        vals, idx, residual = self.compressor.compress(
            acc, grad=flat, residual=residual_in)
        gvals, gidx, _ = sparse_allreduce(
            self.mode, vals, idx, k=self.compressor.k(n), n=n,
            group=self.group)
        self.state["residual"] = self.compressor.repair(
            residual, vals, idx, gidx)
        self.last_local = (vals, idx)
        self.last_global = (gvals, gidx)
        return scatter_add_dense(n, gidx, gvals) / p

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lay = self.layout
        flat = lay.ravel([p.grad for p in lay.params], out=self.flat_grad)
        update = self.compress(flat)
        for p in lay.params:
            if p.grad is None:
                p.grad = torch.empty_like(p)
        lay.unravel_into(update, [p.grad for p in lay.params])
        if self.schedule is not None:
            lr = float(self.schedule(self.state["count"]))
            for group in self.param_groups:
                group["lr"] = lr
        super().step()
        self.state["count"] += 1
        return loss
