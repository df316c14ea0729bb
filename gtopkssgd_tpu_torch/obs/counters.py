"""On-device training-health counters of the compression pipeline, the
port of ``gtopkssgd_tpu/obs/counters.py``.

Every function here is plain PyTorch on the step's device tensors, with no
host sync, so the optimizer computes the counters inside the step (in a
CUDA graph too) and the trainer reads them back once a dispatch. The
counter set (``TELEMETRY_FIELDS``):

  grad_norm_pre    -- L2 of the local gradient entering the pipeline
                      (after the clip, after the slice sum of gtopk_hier)
  grad_norm_post   -- L2 of the averaged dense update applied
  residual_norm    -- L2 of the error-feedback residual after the repair
                      (v under momentum correction; 0 in dense mode)
  tau              -- the smallest selected magnitude (0 when dense)
  sent_elems       -- nonzero elements in the shipped set
  achieved_density -- sent_elems / N
  wire_bytes       -- the comm model's bytes for the step
                      (``parallel.collectives.comm_bytes_per_step``)
  m_k              -- mass capture ||selected||^2 / ||acc||^2
  collective_count -- wire-level collectives a step: 0 at P = 1, B for a
                      bucketed layer-wise wire, 2 for gtopk_hier's two
                      levels, else 1

and, with per-layer telemetry, ``LAYER_FIELDS`` as [L] arrays in the
layout's leaf order plus the residual age buffer f32[N] (steps since a
coordinate last shipped).

The port's residual is one flat f32[N] buffer in every mode (the layout's
order, ``optimizer.FlatLayout``), so a per-layer statistic is a reduction
over each leaf's view of a flat buffer: the JAX package's segment sums
become ``torch._foreach_*`` reductions over the leaf views (one fused
launch for all leaves, in a fixed order: deterministic on the card, where
a ``scatter_add`` is not), and its sparse (vals, idx) forms a flat buffer
first (``densify``: one add a slot, unique indices). Sums of squares and
norms are float32 sums in another order than XLA's; minima and counts are
exact.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gtopkssgd_tpu_torch.parallel.collectives import comm_bytes_per_step

TELEMETRY_FIELDS = (
    "grad_norm_pre",
    "grad_norm_post",
    "residual_norm",
    "tau",
    "sent_elems",
    "achieved_density",
    "wire_bytes",
    "m_k",
    "collective_count",
)

LAYER_FIELDS = (
    "density",
    "tau",
    "grad_norm_pre",
    "grad_norm_post",
    "residual_norm",
    "residual_age",
    "m_k",
)

_MASS_EPS = 1e-30


def _tensors(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    return [t for sub in tree for t in _tensors(sub)]


def _sq1(t: torch.Tensor) -> torch.Tensor:
    """Sum of squares of one tensor, float32: a dot product, one pass and
    no temporary. (torch's vector norm sums naively on the CPU, 1.5e-3
    relative at 25.6M floats; the dot is as exact as a pairwise sum.)"""
    t = t.reshape(-1).float()
    return torch.dot(t, t)


def tree_l2(tree, device=None) -> torch.Tensor:
    """L2 norm over every tensor of a tensor, a sequence or a dict of them
    (0 for none or for empty tensors); several tensors on the card in one
    fused launch (``leaf_l2``)."""
    parts = _tensors(tree)
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=device)
    if len(parts) == 1:
        return torch.sqrt(_sq1(parts[0]))
    return torch.sqrt(_sq1(leaf_l2([t.reshape(-1).float() for t in parts])))


def _sq(tree, device=None) -> torch.Tensor:
    """Sum of squares over every tensor of `tree`, float32."""
    return torch.square(tree_l2(tree, device))


def residual_l2(residual, device=None) -> torch.Tensor:
    """L2 of the error-feedback buffer: under momentum correction the
    residual is {"v", "u"} and v plays the residual's role (u would count
    the momentum twice)."""
    if isinstance(residual, dict) and "v" in residual:
        residual = residual["v"]
    return tree_l2(residual, device)


def _min_nonzero(mags: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The smallest of `mags` where `keep`, 0 where none is kept."""
    t = torch.where(keep, mags, torch.inf).min()
    return torch.where(torch.isfinite(t), t, 0.0).float()


def selected_tau(vals: torch.Tensor) -> torch.Tensor:
    """The smallest NONZERO selected magnitude: padding slots hold 0 and
    would hide the real threshold."""
    mags = vals.abs()
    return _min_nonzero(mags, mags > 0)


def keep_tau(keep: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """tau of the mask form: the smallest kept magnitude, 0 when nothing
    is kept."""
    return _min_nonzero(acc.abs(), keep)


def sent_count(vals: torch.Tensor) -> torch.Tensor:
    """Nonzeros in a shipped value buffer, float32."""
    return (vals != 0).sum(dtype=torch.float32)


def wire_model(*, n: int, k: int, p: int, mode, ici_size: int = 1,
               codec="fp32", schedule=None,
               buckets=None) -> Tuple[int, int]:
    """(wire_bytes, collective_count) of a step, the constants of
    ``make_telemetry``: the model's bytes for the step's collective (summed
    over the buckets of a bucketed wire) and its launches. During a dense
    warm-up they still describe the sparse wire the run switches to."""
    if buckets:
        wire = sum(comm_bytes_per_step(mode, int(n_b), int(k_b), p,
                                       ici_size=ici_size, codec=codec,
                                       schedule=schedule)
                   for n_b, k_b in buckets)
        return wire, (len(buckets) if p > 1 else 0)
    wire = comm_bytes_per_step(mode, n, k, p, ici_size=ici_size,
                               codec=codec, schedule=schedule)
    if p <= 1:
        return wire, 0
    return wire, (2 if (mode == "gtopk_hier" and ici_size > 1) else 1)


def make_telemetry(*, n: int, wire_bytes: torch.Tensor,
                   collective_count: torch.Tensor, grad_norm_pre,
                   grad_norm_post, residual_norm, tau, sent_elems,
                   m_k) -> Dict[str, torch.Tensor]:
    """The per-step counters as float32 0-d tensors; `wire_bytes` and
    `collective_count` are the device constants of ``wire_model``."""
    sent = sent_elems.float()
    return {
        "grad_norm_pre": grad_norm_pre.float(),
        "grad_norm_post": grad_norm_post.float(),
        "residual_norm": residual_norm.float(),
        "tau": tau.float(),
        "sent_elems": sent,
        "achieved_density": sent * reciprocal(n),
        "wire_bytes": wire_bytes,
        "m_k": m_k.float(),
        "collective_count": collective_count,
    }


def reciprocal(n: int) -> float:
    """1 / max(1, n) rounded to float32: XLA divides by a constant as a
    multiply by its float32 reciprocal, so the JAX counters' densities and
    mean ages are products with it."""
    return float(np.float32(1.0) / np.float32(max(1, n)))


def mass_ratio(acc_sq: torch.Tensor, sel_sq: torch.Tensor) -> torch.Tensor:
    """m(k) = ||selected||^2 / ||acc||^2 (arXiv:1911.08772) from the two
    sums of squares."""
    return sel_sq / torch.clamp(acc_sq, min=_MASS_EPS)


# --------------------------------------------------------------------------
# Per-layer counters: reductions over the leaf views of flat f32[N] buffers.
# --------------------------------------------------------------------------


def leaf_views(flat: torch.Tensor, offsets: Sequence[int],
               sizes: Sequence[int]) -> List[torch.Tensor]:
    """Each leaf's view of a flat buffer in the layout's order."""
    return [flat[o:o + s] for o, s in zip(offsets, sizes)]


def leaf_l2(views: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stacked per-leaf L2 norms, f32[L]: one fused reduction on the card
    (tree sums), a dot product a leaf on the CPU (see ``_sq1``)."""
    views = list(views)
    if views[0].is_cuda:
        return torch.stack(torch._foreach_norm(views))
    return torch.sqrt(torch.stack([_sq1(v) for v in views]))


def leaf_sum(views: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-leaf sums of nonnegative buffers, f32[L] (exact for integer
    values below 2^24 a leaf)."""
    return torch.stack(torch._foreach_norm(list(views), 1))


def leaf_min(flat: torch.Tensor, offsets: Sequence[int],
             sizes: Sequence[int]) -> torch.Tensor:
    """Per-leaf minima of a flat buffer, f32[L], one exact reduction a
    leaf."""
    return torch.stack([v.amin() for v in leaf_views(flat, offsets,
                                                     sizes)])


def seg_l2(x: torch.Tensor, offsets: Sequence[int],
           sizes: Sequence[int]) -> torch.Tensor:
    """Per-layer L2 norms of a flat f32[N] buffer."""
    return leaf_l2(leaf_views(x.float(), offsets, sizes))


def densify(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The shipped set (vals, idx) as a flat f32[n] buffer, its values in
    place and 0 elsewhere; indices >= n (padding) drop out. The real
    indices are unique, so each slot takes at most one add."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx.clamp(max=n).long(), vals.float())
    return out[:n]


def selection_layer_stats(acc: torch.Tensor, sel_dense: torch.Tensor,
                          offsets: Sequence[int], sizes: Sequence[int]
                          ) -> Dict[str, torch.Tensor]:
    """Per-layer selection stats {sent, tau, m_k} as f32[L] from the
    accumulator and the selection densified (selected values in place, 0
    elsewhere). A value-0 slot counts as not sent."""
    mask = sel_dense != 0
    mags = sel_dense.abs()
    sent = leaf_sum(leaf_views(mask.float(), offsets, sizes))
    tau = leaf_min(torch.where(mask, mags, torch.inf), offsets, sizes)
    tau = torch.where(torch.isfinite(tau), tau, 0.0)
    acc_n = seg_l2(acc, offsets, sizes)
    sel_n = seg_l2(sel_dense, offsets, sizes)
    return {"sent": sent, "tau": tau,
            "m_k": mass_ratio(acc_n * acc_n, sel_n * sel_n)}


def dense_phase_selection_stats(sizes_f: torch.Tensor
                                ) -> Dict[str, torch.Tensor]:
    """The dense phase's selection stats: everything ships, no threshold,
    full mass capture. `sizes_f` is the leaf sizes, f32[L] on the
    device."""
    return {"sent": sizes_f, "tau": torch.zeros_like(sizes_f),
            "m_k": torch.ones_like(sizes_f)}


def update_age(age: torch.Tensor, delivered: torch.Tensor) -> torch.Tensor:
    """The residual-age recursion, in place: a coordinate's age resets to 0
    the step it ships (is nonzero in the applied update) and grows by 1
    otherwise. The update is the same on every rank, so the ages are too,
    without a collective. Returns `age`."""
    return age.add_(1.0).masked_fill_(delivered, 0.0)


def layer_age_means(age: torch.Tensor, offsets: Sequence[int],
                    sizes: Sequence[int],
                    inv_sizes: torch.Tensor) -> torch.Tensor:
    """Mean residual age per layer: each leaf's sum times the float32
    reciprocal of its size (`inv_sizes`, f32[L])."""
    return leaf_sum(leaf_views(age, offsets, sizes)) * inv_sizes


def assemble_layer_telemetry(*, sel_stats: Dict[str, torch.Tensor],
                             inv_sizes: torch.Tensor, grad_norm_pre_l,
                             grad_norm_post_l, residual_norm_l,
                             residual_age_l) -> torch.Tensor:
    """The LAYER_FIELDS rows stacked, f32[7, L]; `inv_sizes` the float32
    reciprocals of the leaf sizes on the device."""
    rows = {
        "density": sel_stats["sent"] * inv_sizes,
        "tau": sel_stats["tau"],
        "grad_norm_pre": grad_norm_pre_l,
        "grad_norm_post": grad_norm_post_l,
        "residual_norm": residual_norm_l,
        "residual_age": residual_age_l,
        "m_k": sel_stats["m_k"],
    }
    return torch.stack([rows[f].float() for f in LAYER_FIELDS])


def topk_recall(hits: torch.Tensor, exact_vals: torch.Tensor
                ) -> torch.Tensor:
    """Recall of the production selection against the exact top-k: the
    share of the exact top-k (zero padding excluded) it also selected;
    `hits` is bool[k], membership of the exact indices."""
    real = exact_vals.abs() > 0
    n_real = torch.clamp(real.sum(dtype=torch.float32), min=1.0)
    return (hits & real).sum(dtype=torch.float32) / n_real


def telemetry_scalars(values: Sequence[float],
                      fields: Sequence[str]) -> Dict[str, float]:
    """Host floats of the scalar counters, `fields` in the order of the
    optimizer's telemetry vector (``GTopKSGD.telemetry_fields``)."""
    return {f: float(v) for f, v in zip(fields, values)}


def layer_rows(values: Sequence[float], n_layers: int
               ) -> Dict[str, np.ndarray]:
    """The per-layer block of the telemetry vector (7 x L floats) as one
    f64[L] array a LAYER_FIELDS field."""
    arr = np.asarray(values, dtype=np.float64).reshape(len(LAYER_FIELDS),
                                                       n_layers)
    return {f: arr[i] for i, f in enumerate(LAYER_FIELDS)}


def zero_vector(n_scalars: int, n_layers: int, audit: bool,
                device=None) -> torch.Tensor:
    """The telemetry vector at init: zeros, audit_recall -1 (never
    audited) when there is one (the last scalar)."""
    vec = torch.zeros(n_scalars + len(LAYER_FIELDS) * n_layers,
                      dtype=torch.float32, device=device)
    if audit:
        vec[n_scalars - 1] = -1.0
    return vec


def field_names(audit: bool) -> Tuple[str, ...]:
    """The scalar fields of the telemetry vector, in order."""
    return TELEMETRY_FIELDS + (("audit_recall",) if audit else ())


def exact_recall(acc: torch.Tensor, k: int, selected: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hits bool[k], exact values f32[k]) of the exact top-k of |acc|
    (ties to the lowest index) against `selected`, a bool mask over acc of
    the production selection."""
    from gtopkssgd_tpu_torch.ops import topk_abs

    ev, ei = topk_abs(acc, k)
    return selected[ei.long()], ev


def selected_mask(n: int, idx: torch.Tensor) -> torch.Tensor:
    """bool[n]: the positions of the index set `idx` (padding >= n drops
    out)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out.index_fill_(0, idx.clamp(max=n).long(), True)
    return out[:n]
