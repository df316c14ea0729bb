"""How a run decides ``correct``: the program's first three steps, read
from its state, against the plain reference's (``reference/run.py``).

Set-up drives the trainer it hands to the window through its first
dispatches (``train(K)``, the window's call), three distinct batches of
the pool for the first three steps. From its state
the harness keeps (``ProgramRecord``): the flat parameters before the
first step and after the third, each step's loss, and after the first
step the residual and the SGD velocity, from which it works out the
first gradient as the optimizer got it (residual + velocity - wd * p0,
the residual plus the update the step applied) and the kept entries
(residual 0, update not 0); a step that keeps no residual (the dense
exchange's) reads as one whose residual is zero. The reference follows
the same three steps.

The numbers (``compare``), each against its limit in
``workloads/<cell>.json``:

* ``loss``: the largest relative gap of a step's loss;
* ``grad_leaf``: by the worst leaf, the gap between the two first
  gradients' norms over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``grad_err``: the norm of the difference of the two first gradients
  over the reference's norm, over the whole model: a gap of norms moves
  little when every entry carries rounding error alike, so where nothing
  is selected this is the number a lower precision fails;
* ``change_leaf``: the same as ``grad_leaf`` of the parameters' change
  over the three steps;
* ``change_all``: the gap between the two changes' norms over the whole
  model, over the reference's;
* ``select_miss``: the entries kept by one side and not the other, over
  the reference's kept count;
* ``layout``: leaves whose name, size or place in the flat vector differ
  from the reference's (an exact comparison).

Leaves whose reference gradient stays under a thousandth of the median
leaf's (``grad_leaf``, ``grad_err``: at the first step; ``change_leaf``:
at every step) are left out: their values move by round-off alone. At P
workers the gradient, the kept entries and ``select_miss`` are each
rank's own and the worst rank counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

QUIET = 1e-3  # a leaf's gradient under this share of the median's


class ProgramRecord:
    """The program's state around its first three steps, on the host."""

    def __init__(self, trainer, weight_decay: float):
        self.trainer = trainer
        self.wd = float(weight_decay)
        lay = trainer.layout
        self.leaves = []
        for name, off, size in zip(trainer.layer_names, lay.offsets,
                                   lay.sizes):
            self.leaves.append((name, off, size))
        self.losses: List[float] = []

    def _flat_params(self) -> torch.Tensor:
        lay = self.trainer.layout
        return lay.ravel([p.detach() for p in lay.params])

    def before(self) -> None:
        self._p0_dev = self._flat_params().clone()
        self.p0 = self._p0_dev.cpu()

    def after_first(self) -> None:
        opt, lay = self.trainer.optimizer, self.trainer.layout
        vel = lay.ravel([opt.state.get(p, {}).get("momentum_buffer")
                         for p in lay.params])
        update = vel - self.wd * self._p0_dev
        residual = opt.state.get("residual")
        if residual is None or residual.numel() == 0:
            # A dense step selects nothing and keeps no residual.
            residual = torch.zeros_like(update)
        self.h1 = (residual + update).cpu()
        self.keep1 = ((residual == 0) & (update != 0)).cpu()
        del self._p0_dev

    def params_now(self) -> None:
        self.p3 = self._flat_params().cpu()

    def after_last(self, losses: List[float]) -> None:
        self.losses = [float(v) for v in losses]
        self.trainer = None


def _norms(flat: torch.Tensor, leaves) -> torch.Tensor:
    return torch.stack([flat[o:o + s].double().norm() for _, o, s in leaves])


def _gaps(cand: torch.Tensor, ref: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's; 0 for a leaf left out."""
    den = torch.maximum(ref, ref.median())
    gap = (cand - ref).abs() / torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(mask, gap, torch.zeros_like(gap))


def compare(prog: ProgramRecord, ref: Dict, rank: int,
            device: Optional[torch.device] = None,
            detail: Optional[Dict] = None) -> Dict[str, float]:
    """The numbers of one rank's record against the reference's; a
    `detail` dict receives the worst leaves and their readings."""
    dev = device or torch.device("cpu")
    leaves = ref["leaves"]
    layout = sum(1 for a, b in zip(prog.leaves, leaves) if a != b)
    layout += abs(len(prog.leaves) - len(leaves))
    out = {"layout": float(layout)}
    lr = torch.tensor(ref["losses"], dtype=torch.float64)
    lc = torch.tensor(prog.losses, dtype=torch.float64)
    out["loss"] = float(((lc - lr).abs() / lr.abs()).max())
    if layout:
        return out
    g = torch.stack(ref["grad_norms"])  # [steps, leaves]
    quiet1 = g[0] >= QUIET * g[0].median()
    gmax = g.max(0).values
    quiet = gmax >= QUIET * gmax.median()
    hc = _norms(prog.h1.to(dev), leaves).cpu()
    hr = _norms(ref["h1"][rank].to(dev), leaves).cpu()
    gg = _gaps(hc, hr, quiet1)
    out["grad_leaf"] = float(gg.max())
    q1 = torch.where(quiet1, 1.0, 0.0).double()
    he = _norms((prog.h1 - ref["h1"][rank]).to(dev), leaves).cpu()
    out["grad_err"] = float((he.square() * q1).sum().sqrt()
                            / (hr.square() * q1).sum().sqrt())
    chg_c = (prog.p3 - prog.p0).to(dev)
    chg_r = (ref["p3"] - ref["p0"]).to(dev)
    dc, dr = _norms(chg_c, leaves).cpu(), _norms(chg_r, leaves).cpu()
    gc = _gaps(dc, dr, quiet)
    out["change_leaf"] = float(gc.max())
    sq = torch.where(quiet, 1.0, 0.0).double()
    all_c, all_r = (dc.square() * sq).sum().sqrt(), (dr.square() * sq).sum().sqrt()
    out["change_all"] = float((all_c - all_r).abs() / all_r)
    if detail is not None:
        i, j = int(gg.argmax()), int(gc.argmax())
        _, o, n = leaves[j]
        detail.update(
            grad_leaf=leaves[i][0], change_leaf=leaves[j][0],
            change_size=n, change_cand=float(dc[j]), change_ref=float(dr[j]),
            change_median=float(dr.median()),
            moved_cand=int((chg_c[o:o + n] != 0).sum()),
            moved_ref=int((chg_r[o:o + n] != 0).sum()),
            p0_norm=float(ref["p0"][o:o + n].norm()),
            top_cand=[float(v) for v in chg_c[o:o + n].abs().topk(
                min(3, n)).values], top_ref=[float(v) for v in
                                            chg_r[o:o + n].abs().topk(
                                                min(3, n)).values])
    kc, kr = prog.keep1.to(dev), ref["keep1"][rank].to(dev)
    out["select_miss"] = float((kc ^ kr).sum()) / max(1.0, float(kr.sum()))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each compared number with its limit; a number the cell gives no
    limit is not compared."""
    return {name: {"value": numbers.get(name, float("nan")),
                   "limit": float(limit)}
            for name, limit in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
