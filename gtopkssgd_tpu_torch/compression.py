"""Gradient compression with error feedback (reference TopKCompressor).

The residual is an explicit flat f32[N] tensor owned by the optimizer (and
saved in its state_dict). Per step:

    acc             = grad + residual                     (accumulate)
    vals, idx, res' = compress(acc)                       (select + zero-out)
    res''           = repair(res', vals, idx, gidx)       (error-feedback fix)

or, where no index set is needed (one worker), the mask form
``compress_by_threshold``. The functions return new tensors and leave
their inputs alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gtopkssgd_tpu_torch import modes
from gtopkssgd_tpu_torch.ops import (
    k_for_density,
    membership_mask,
    select_tau,
    select_topk,
)


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Magnitude top-k with error feedback. `density` = k / N; `method`
    picks the selection (ops.topk.select_topk): auto | exact | threshold |
    pallas | twostage."""

    density: float
    method: str = "auto"

    def k(self, n: int) -> int:
        return k_for_density(n, self.density)

    def init_residual(self, n: int, device=None) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.float32, device=device)

    def accumulate(self, grad_flat: torch.Tensor,
                   residual: torch.Tensor) -> torch.Tensor:
        return grad_flat + residual

    def compress(
        self,
        acc: torch.Tensor,
        *,
        grad: Optional[torch.Tensor] = None,
        residual: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(vals f32[k], idx i32[k], residual f32[N]): the top-k of |acc|,
        and acc with the selected entries zeroed. Given the unfused
        operands (acc == grad + residual), the selection reads them."""
        n = acc.shape[0]
        if grad is not None:
            vals, idx = select_topk(grad, self.k(n), self.method,
                                    residual=residual)
        else:
            vals, idx = select_topk(acc, self.k(n), self.method)
        residual_out = torch.cat([acc, acc.new_zeros(1)])
        # padding -> slot n; index_fill_ takes the 0 as an argument, where
        # an indexed assignment would copy it to the card and wait
        residual_out.index_fill_(0, idx.clamp(max=n).long(), 0.0)
        return vals, idx, residual_out[:n]

    def compress_by_threshold(
        self,
        acc: torch.Tensor,
        *,
        grad: Optional[torch.Tensor] = None,
        residual: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(keep bool[N], residual f32[N], kept_tau f32[]) with keep =
        |acc| >= tau, tau the k-th largest magnitude the method reports,
        residual = where(keep, 0, acc), kept_tau the smallest magnitude
        kept (0 if none). Ties at tau all pass. When tau == 0, zeros are
        kept OUT: |x| >= 0 holds for everything, and keeping all would
        zero the whole residual instead of touching <= k entries."""
        n = acc.shape[0]
        if grad is not None:
            tau = select_tau(grad, self.k(n), self.method,
                             residual=residual)
        else:
            tau = select_tau(acc, self.k(n), self.method)
        mag = acc.abs()
        keep = (mag >= tau) & (mag > 0.0)
        kept_tau = torch.where(keep, mag, torch.inf).min()
        kept_tau = torch.where(torch.isfinite(kept_tau), kept_tau,
                               torch.zeros_like(kept_tau))
        return keep, torch.where(keep, torch.zeros_like(acc), acc), kept_tau

    def repair(
        self,
        residual: torch.Tensor,
        local_vals: torch.Tensor,
        local_idx: torch.Tensor,
        global_idx: torch.Tensor,
    ) -> torch.Tensor:
        """Local picks that did NOT survive the global top-k go back into
        the residual (reference `add_residuals`)."""
        n = residual.shape[0]
        rejected = ~membership_mask(local_idx, global_idx)
        put_back = torch.where(rejected, local_vals,
                               torch.zeros_like(local_vals))
        out = torch.cat([residual, residual.new_zeros(1)])
        out.index_add_(0, local_idx.clamp(max=n).long(), put_back)
        return out[:n]

    def fold_wire_error(
        self,
        residual: torch.Tensor,
        local_idx: torch.Tensor,
        wire_err: torch.Tensor,
    ) -> torch.Tensor:
        """Add a lossy codec's error, ``vals - roundtrip_aligned(vals)`` per
        local pick, into the residual, before the collective. The shipped
        values are then the roundtripped ones, and ``repair`` of a rejected
        pick restores roundtrip + error = the original value. Padding slots
        carry no error and drop out."""
        n = residual.shape[0]
        out = torch.cat([residual, residual.new_zeros(1)])
        out.index_add_(0, local_idx.clamp(max=n).long(), wire_err)
        return out[:n]


@dataclasses.dataclass(frozen=True)
class NoneCompressor:
    """Dense passthrough (reference `NoneCompressor`): no selection, no
    residual."""

    density: float = 1.0
    method: str = "none"

    def k(self, n: int) -> int:
        return n

    def init_residual(self, n: int, device=None) -> torch.Tensor:
        return torch.zeros(0, dtype=torch.float32, device=device)

    def accumulate(self, grad_flat: torch.Tensor,
                   residual: torch.Tensor) -> torch.Tensor:
        return grad_flat

    def compress(self, acc: torch.Tensor, *,
                 grad: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None):
        idx = torch.arange(acc.shape[0], dtype=torch.int32,
                           device=acc.device)
        return acc, idx, acc.new_zeros(0)

    def repair(self, residual, local_vals, local_idx, global_idx):
        return residual


# Name -> class, keyed by the mode vocabulary so the two cannot drift.
compressors = {
    **{m: NoneCompressor for m in modes.DENSE_MODES},
    **{m: TopKCompressor for m in modes.SPARSE_MODES},
}


def get_compressor(name: Optional[str], density: float = 0.001,
                   method: str = "auto"):
    try:
        cls = compressors[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}") from None
    if cls is NoneCompressor:
        return NoneCompressor()
    return cls(density=density, method=method)
