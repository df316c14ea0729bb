"""The dense step over P workers (traffic ``compression`` "dense"):
S-SGD's exchange, the baseline gTop-k is judged against. The update is
the mean of the workers' flat gradients, their sum times 1/P; nothing is
selected, so each residual stays zero and every entry reaches the
update. SGD follows as for gTop-k (``gtopk.sgd``)."""

from __future__ import annotations

from typing import List, Tuple

import torch


def step(grads: List[torch.Tensor], residuals: List[torch.Tensor], k: int
         ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(update, residuals, kept masks), as ``gtopk.step`` returns them;
    `k` is not read."""
    update = torch.stack(grads).sum(0) * (1.0 / len(grads))
    kept = [torch.ones_like(update, dtype=torch.bool) for _ in grads]
    return update, residuals, kept
