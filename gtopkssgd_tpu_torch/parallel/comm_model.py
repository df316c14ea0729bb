"""The alpha-beta comm model the planner (``parallel.planner``) and the
bucketing DP (``parallel.bucketing``) price wires with, and the fit it
reads its constants from.

Counterpart of ``gtopkssgd_tpu/obs/ledger.py`` (``wire_mode_for``,
``predict_comm_ms``) with the formulas of ``benchmarks/scaling_model.py``
(``predict``, which the JAX package's ``predict_comm_ms`` calls), under
the port's own constants. A run prices with, in order:

* explicit arguments (tests, what-if scoring);
* a fit file given as ``fit_path`` (``--comm-model-fit PATH``), in the
  grammar of the JAX package's ``alpha_beta_fit`` artifacts, so one of
  those can be priced for the parity tests;
* the fit the port measured on the card and committed beside this module
  for the process group's backend (``committed_fit``: ``comm_fit.json``
  for gloo, two ranks sharing one card with the wires staged through the
  host; ``comm_fit_nccl.json`` for NCCL, one rank a card; both written
  by ``python -m gtopkssgd_tpu_torch.comm_probe``).

Where none is there, ``load_fit`` raises: the model never guesses a
link. One link class is measured, so the planner prices the in-slice hop
(``ici_gbps``) from the same fit as the cross-slice one.

The Top-k allgather modes (``topk | topkA | topk_allgather``) price as
``allgather``, whose wire they ship.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Sequence

from gtopkssgd_tpu_torch.modes import ALLGATHER_MODES, LAYERWISE_MODES
from gtopkssgd_tpu_torch.parallel.codec import get_codec
from gtopkssgd_tpu_torch.parallel.collectives import balanced_cap, tree_rounds

_HERE = os.path.dirname(os.path.abspath(__file__))
#: The fits ``comm_probe`` measured on the card, committed with the port,
#: by the backend of the process group they price.
COMMITTED_FITS = {"gloo": os.path.join(_HERE, "comm_fit.json"),
                  "nccl": os.path.join(_HERE, "comm_fit_nccl.json")}
COMMITTED_FIT = COMMITTED_FITS["gloo"]


def committed_fit(backend: str) -> str:
    """The committed fit's path for a process group's `backend`."""
    try:
        return COMMITTED_FITS[str(backend).lower()]
    except KeyError:
        raise ValueError(
            f"no committed comm-model fit for backend {backend!r} (have "
            f"{', '.join(COMMITTED_FITS)}): pass --comm-model-fit PATH"
        ) from None


def load_fit(fit_path: Optional[str] = None) -> Dict[str, Any]:
    """{alpha_ms, beta_gbps, source} from `fit_path`, or from the
    committed gloo fit when it is None. Raises ValueError on a file
    without a usable ``alpha_beta_fit`` (numeric alpha_ms, beta_gbps >
    0), and when there is no file."""
    path = fit_path or COMMITTED_FIT
    if not os.path.exists(path):
        raise ValueError(
            f"no comm-model fit at {path}: measure one on the card with "
            "python -m gtopkssgd_tpu_torch.comm_probe, or pass "
            "--comm-model-fit PATH")
    with open(path) as fh:
        fit = json.load(fh).get("alpha_beta_fit") or {}
    alpha, beta = fit.get("alpha_ms"), fit.get("beta_gbps")
    if not (_finite(alpha) and _finite(beta) and beta > 0):
        raise ValueError(f"{path}: no usable alpha_beta_fit (need numeric "
                         "alpha_ms and beta_gbps > 0)")
    return {"alpha_ms": float(alpha), "beta_gbps": float(beta),
            "source": os.path.basename(path)}


def _finite(x) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x))


def wire_mode_for(mode: str, schedule: Optional[str] = None) -> str:
    """The model's key for (mode, schedule): the layer-wise mode ships the
    flat tree's wire, the Top-k allgather modes the allgather's, and the
    'balanced' schedule maps the gtopk family onto the Ok-Topk branch.
    Bucketing changes how many merges run, not the key (callers pass the
    buckets' (n_b, k_b) pairs to ``predict_comm_ms``)."""
    if mode in LAYERWISE_MODES:
        wm = "gtopk"
    elif mode in ALLGATHER_MODES:
        wm = "allgather"
    else:
        wm = mode
    if schedule == "balanced" and wm in ("gtopk", "gtopk_hier"):
        return "gtopk_balanced"
    return wm


def _ring_allreduce_bytes(n_bytes: int, p: int) -> float:
    """A bandwidth-optimal dense all-reduce moves 2(p-1)/p x the buffer
    per rank."""
    return 2.0 * (p - 1) / p * n_bytes


def predict_comm_ms(mode: str, p: int, *, n: int, k: int, alpha_ms: float,
                    beta_gbps: float, ici_gbps: float, ici_size: int = 1,
                    codec: str = "fp32",
                    buckets: Optional[Sequence[Sequence[int]]] = None
                    ) -> float:
    """Predicted ms of one step's exchange for `mode` at P ranks in slices
    of `ici_size`: messages x alpha + bytes / bandwidth on the link each
    phase crosses (the in-slice link at `ici_gbps` with no alpha, the
    cross-slice one at `beta_gbps` and `alpha_ms`); the formulas of the
    JAX package's ``benchmarks/scaling_model.predict``. ``buckets`` --
    ((n_b, k_b), ...) of a ``BucketPlan`` -- prices the bucketed
    layer-wise wire: B merges, each over its bucket's own index space,
    summed."""
    if buckets:
        return sum(
            predict_comm_ms(mode, p, n=int(n_b), k=int(k_b),
                            alpha_ms=alpha_ms, beta_gbps=beta_gbps,
                            ici_gbps=ici_gbps, ici_size=ici_size,
                            codec=codec)
            for n_b, k_b in buckets)
    wire_mode = wire_mode_for(mode)
    set_bytes = get_codec(codec).wire_set_bytes(k, n)
    ici_bps = ici_gbps * 1e9 / 8
    dcn_bps = beta_gbps * 1e9 / 8
    s = min(ici_size, p)
    n_slices = max(1, math.ceil(p / s))
    if wire_mode == "dense":
        return (_ring_allreduce_bytes(4 * n, s) / ici_bps * 1e3
                + _ring_allreduce_bytes(4 * n, n_slices) / dcn_bps * 1e3
                + 2 * (n_slices - 1) * alpha_ms)
    if wire_mode == "gtopk":
        # The tree's rounds split by the link each crosses: hypercube bits
        # inside a slice ride the in-slice link; larger bits and the
        # ragged fold/unfold cross slices.
        total_rounds = tree_rounds(p)
        if n_slices == 1:
            ici_rounds, dcn_rounds = total_rounds, 0
        else:
            m = 1 << (p.bit_length() - 1)
            ici_rounds = min(m, s).bit_length() - 1
            dcn_rounds = total_rounds - ici_rounds
        return (ici_rounds * set_bytes / ici_bps * 1e3
                + dcn_rounds * (set_bytes / dcn_bps * 1e3 + alpha_ms))
    if wire_mode == "gtopk_balanced":
        # p-1 scatter rounds and a p-rank gather, each hop one cap-set;
        # s-1 of each phase's partners (and the own set) in the slice.
        cap_bytes = get_codec(codec).wire_set_bytes(balanced_cap(k, p, n),
                                                    n)
        ici_hops = 2 * (s - 1) + 1
        dcn_hops = 2 * (p - s)
        return (ici_hops * cap_bytes / ici_bps * 1e3
                + dcn_hops * (cap_bytes / dcn_bps * 1e3 + alpha_ms))
    if wire_mode == "allgather":
        return ((set_bytes * s) / ici_bps * 1e3
                + (set_bytes * (p - s)) / dcn_bps * 1e3
                + (n_slices - 1) * alpha_ms)
    if wire_mode == "gtopk_hier":
        return (_ring_allreduce_bytes(4 * n, s) / ici_bps * 1e3
                + tree_rounds(n_slices) * (set_bytes / dcn_bps * 1e3
                                           + alpha_ms))
    raise ValueError(mode)
