"""gTop-k S-SGD: error-feedback top-k compression of the flat gradient,
the gTop-k all-reduce (or the Top-k allgather) over P ranks, then SGD with
momentum and weight decay.

Counterpart of the flat path of ``gtopkssgd_tpu.optimizer.gtopk_sgd``
(``update_fn``: modes ``dense``, ``gtopk`` and ``allgather | topk | topkA
| topk_allgather``, with every option of that path). One step:

1. ravel every parameter's gradient into one flat f32[N] buffer, in the
   order and layout of the JAX package's ``ravel_pytree`` (``FlatLayout``;
   ``convert.flat_layout`` builds it for a model) -- top-k buckets are
   positions in this vector, so the order decides what is selected; with
   ``clip_grad_norm`` c, scale it by min(1, c / (||flat|| + 1e-6)) first;
2. the source: the flat gradient, or under ``momentum_correction`` (DGC,
   arXiv:1712.01887) the local velocity u = momentum*u + flat, whose
   accumulation v plays the residual;
3. during the first ``warmup_dense_steps`` steps of a sparse mode, the
   update is the source all-reduced and divided by P; the residual (and
   u) pass through unchanged;
4. sparse, at P = 1: acc = src + residual; keep = |acc| >= tau by the
   threshold-mask compressor (the selection reads src and residual
   unfused); residual = where(keep, 0, acc); u = where(keep, 0, u); the
   update is acc - residual. At P > 1: the local set (vals, idx) =
   compress(acc) in index form; a lossy wire codec's round-trip error is
   folded into the residual and the roundtripped values ship (not in mode
   ``topk``); u is zeroed at the local picks; then ``gtopk``: the global
   set by the hypercube merge, rejected local picks back into the
   residual (``repair``), the update scatter_add_dense(gidx, gvals) / P;
   the allgather modes: the update is the dense union / P, no repair;
   ``dense``: the update is the gradient, all-reduced and divided by P;
5. unravel the update into the parameters' ``.grad`` and take one
   ``torch.optim.SGD`` step: g + wd*p, then buf = momentum*buf + g (with
   ``nesterov``, g + momentum*buf is applied), then p -= lr*buf -- the
   arithmetic of the JAX package's ``add_decayed_weights(wd)`` +
   ``sgd(momentum, nesterov)`` chain, applied to every parameter,
   BatchNorm scale and bias included. Under momentum correction the SGD
   step runs with no momentum (the velocity lives before the exchange).

The residual and the step count live in the optimizer's ``state`` (keys
"residual" and "count"; under momentum correction the residual is
{"v": v, "u": u}), so ``state_dict()`` saves error feedback.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.compression import get_compressor
from gtopkssgd_tpu_torch.modes import ALL_MODES, DENSE_MODES
from gtopkssgd_tpu_torch.ops import membership_mask, scatter_add_dense
from gtopkssgd_tpu_torch.parallel.codec import get_codec, roundtrip_aligned
from gtopkssgd_tpu_torch.parallel.collectives import (
    dense_allreduce,
    sparse_allreduce,
)

Schedule = Callable[[int], float]

# The JAX package's hierarchical and layer-wise modes come with ROADMAP.md
# section 1, item 5.
_LATER_MODES = ("gtopk_hier", "gtopk_layerwise")


def clip_by_global_norm(flat: torch.Tensor, max_norm: float) -> torch.Tensor:
    """flat * min(1, max_norm / (||flat|| + 1e-6)), in float32: the JAX
    optimizer's clip before compression."""
    gnorm = torch.sqrt(torch.sum(flat * flat))
    # An IEEE quotient: torch computes a Python number over a tensor as
    # the tensor's reciprocal times the number.
    scale = torch.full_like(gnorm, max_norm) / (gnorm + 1e-6)
    return flat * torch.clamp(scale, max=1.0)


def velocity_update(momentum: float, u: torch.Tensor,
                    flat: torch.Tensor) -> torch.Tensor:
    """momentum * u + flat rounded once to float32, as a fused multiply-add
    rounds it (XLA emits one for the JAX optimizer's expression). Two
    float32 roundings would differ by an ulp in some entries, and v sums
    the velocities, so the difference would grow step by step. The
    product of two float32 values is exact in float64; the sum rounds to
    float64 and then to float32."""
    m = float(np.float32(momentum))
    return (m * u.double() + flat.double()).float()


def _mean(total: torch.Tensor, p: int) -> torch.Tensor:
    """total / p as XLA compiles the JAX optimizer's division by the
    constant P: times the float32 reciprocal of P (exact at powers of
    two)."""
    return total * float(np.float32(1.0) / np.float32(p))


def _zero_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x with the entries at idx set to 0; padding indices (n) drop out."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    out[idx.clamp(max=n).long()] = 0.0
    return out[:n]


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
    """SGD (momentum, weight decay, Nesterov) on the gTop-k-compressed
    gradient; the options of the JAX package's ``gtopk_sgd`` flat path.

    ``lr`` is a float or a schedule ``lr(count)`` read before every step,
    count being the number of steps taken. ``layout`` fixes the flat order
    (default: ``params`` in the given order, each raveled as it is).
    ``process_group`` is the group of the P data-parallel ranks, or None
    for one worker. ``wire_codec`` is a ``parallel.codec`` spec (``fp32 |
    int8[:B] | fp8[:B]``). ``_restore_rejected_u`` is an ablation of
    momentum correction only: it gives globally rejected picks their
    velocity back, which the JAX package measured to diverge.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: Union[float, Schedule],
        *,
        momentum: float = 0.9,
        weight_decay: float = 0.0,
        nesterov: bool = False,
        compression: Optional[str] = "gtopk",
        density: float = 0.001,
        topk_method: str = "auto",
        wire_codec="fp32",
        clip_grad_norm: Optional[float] = None,
        warmup_dense_steps: int = 0,
        momentum_correction: bool = False,
        _restore_rejected_u: bool = False,
        layout: Optional[FlatLayout] = None,
        process_group=None,
    ):
        if compression in _LATER_MODES:
            raise ValueError(
                f"compression {compression!r} is not in the port yet, "
                f"ROADMAP.md section 1, item 5; it has {ALL_MODES}")
        if compression not in ALL_MODES:
            raise ValueError(f"unknown compression mode {compression!r}")
        if warmup_dense_steps < 0:
            raise ValueError(
                f"warmup_dense_steps must be >= 0, got {warmup_dense_steps}")
        if nesterov and not momentum:
            raise ValueError("nesterov momentum requires momentum > 0")
        self.dense_mode = compression in DENSE_MODES
        if momentum_correction:
            if self.dense_mode:
                raise ValueError(
                    "momentum_correction only applies to sparse modes (the "
                    "dense path IS classic momentum-SGD already)")
            if not momentum:
                raise ValueError("momentum_correction requires momentum > 0")
            if nesterov:
                raise ValueError(
                    "momentum_correction defines its own velocity "
                    "recursion; nesterov is not expressible in it")
        if _restore_rejected_u and not momentum_correction:
            raise ValueError(
                "_restore_rejected_u is a momentum_correction ablation knob; "
                "it needs momentum_correction=True")
        self.codec = get_codec(wire_codec)
        params = list(params)
        self.schedule = lr if callable(lr) else None
        # Under momentum correction the velocity lives before the exchange
        # (state "u"); the SGD step must not apply momentum a second time.
        super().__init__(params, lr=float(lr(0)) if callable(lr) else lr,
                         momentum=0.0 if momentum_correction else momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        self.layout = layout or FlatLayout.identity(params)
        if {id(p) for p in self.layout.params} != {id(p) for p in params}:
            raise ValueError("layout does not cover exactly these params")
        self.compressor = get_compressor(compression, density, topk_method)
        self.mode = compression
        self.clip_grad_norm = clip_grad_norm
        self.warmup_dense_steps = warmup_dense_steps
        self.correction = momentum_correction
        self.velocity_momentum = momentum
        self.restore_rejected_u = _restore_rejected_u
        self.group = process_group
        self.p = 1
        if process_group is not None:
            self.p = dist.get_world_size(process_group)
        device = params[0].device
        n = self.layout.n
        residual = self.compressor.init_residual(n, device)
        if momentum_correction:
            residual = {"v": residual,
                        "u": torch.zeros(n, dtype=torch.float32,
                                         device=device)}
        self.state["residual"] = residual
        self.state["count"] = 0
        #: The flat gradient of the last step, before the clip (one
        #: buffer, reused).
        self.flat_grad = torch.empty(n, dtype=torch.float32, device=device)
        #: The keep mask of the last sparse step at P = 1.
        self.last_keep: Optional[torch.Tensor] = None
        #: The last sparse step's shipped local (vals, idx) at P > 1, and
        #: its global (gvals, gidx) set (gtopk) or dense union before the
        #: division by P (the allgather modes). None after a dense step.
        self.last_local: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.last_global: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.last_union: Optional[torch.Tensor] = None

    def compress(self, flat: torch.Tensor) -> torch.Tensor:
        """The update for flat gradient `flat`, averaged over the P ranks;
        advances the residual (and the velocity)."""
        p = self.p
        self.last_keep = self.last_local = None
        self.last_global = self.last_union = None
        if self.clip_grad_norm is not None:
            flat = clip_by_global_norm(flat, self.clip_grad_norm)
        if self.dense_mode:
            if p == 1:
                return flat
            return _mean(dense_allreduce(flat, group=self.group), p)
        state = self.state["residual"]
        u = None
        if self.correction:
            u = velocity_update(self.velocity_momentum, state["u"], flat)
            src, res_in = u, state["v"]
        else:
            src, res_in = flat, state
        if self.state["count"] < self.warmup_dense_steps:
            # Dense warm-up: nothing is selected, so nothing is masked.
            reduced = src if p == 1 else dense_allreduce(src,
                                                         group=self.group)
            update, residual, u_out = _mean(reduced, p), res_in, u
        else:
            update, residual, u_out = self._sparse(src, res_in, u)
        self.state["residual"] = ({"v": residual, "u": u_out}
                                  if self.correction else residual)
        return update

    def _sparse(self, src: torch.Tensor, res_in: torch.Tensor,
                u: Optional[torch.Tensor]):
        """(update, residual, u) of a sparse step from source `src`."""
        comp, p, n = self.compressor, self.p, src.shape[0]
        acc = comp.accumulate(src, res_in)
        if p == 1:
            keep, residual, _ = comp.compress_by_threshold(
                acc, grad=src, residual=res_in)
            self.last_keep = keep
            if u is not None:  # every local pick is delivered at P = 1
                u = torch.where(keep, torch.zeros_like(u), u)
            return acc - residual, residual, u
        vals, idx, residual = comp.compress(acc, grad=src, residual=res_in)
        if self.codec.lossy and self.mode != "topk":
            # Ship the roundtripped values and keep their error: repair then
            # restores the original value of a rejected pick. Mode 'topk'
            # ships the exact picks (every one lands), as in the JAX package.
            vq = roundtrip_aligned(self.codec, vals, idx, n=n)
            residual = comp.fold_wire_error(residual, idx, vals - vq)
            vals = vq
        self.last_local = (vals, idx)
        # Momentum factor masking at the local picks, delivered or not.
        u_out = None if u is None else _zero_at(u, idx)
        result, gidx, needs_repair = sparse_allreduce(
            self.mode, vals, idx, k=comp.k(n), n=n, group=self.group,
            codec=self.codec)
        if not needs_repair:  # the allgather union: every pick lands
            self.last_union = result
            return _mean(result, p), residual, u_out
        self.last_global = (result, gidx)
        residual = comp.repair(residual, vals, idx, gidx)
        if u is not None and self.restore_rejected_u:
            pos = idx.clamp(max=n).long()
            rejected = ~membership_mask(idx, gidx)
            back = torch.where(rejected, torch.cat([u, u.new_zeros(1)])[pos],
                               0.0)
            u_out = torch.cat([u_out, u_out.new_zeros(1)])
            u_out = u_out.index_add_(0, pos, back)[:n]
        return _mean(scatter_add_dense(n, gidx, result), p), residual, u_out

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
