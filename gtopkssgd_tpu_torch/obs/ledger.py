"""The comm-model ledger, the port of ``gtopkssgd_tpu/obs/ledger.py``:
measured comm time and wire bytes joined against the alpha-beta model.

For every measured observation the ledger emits one predicted-vs-measured
ratio row: ``attr`` records (``obs.trace_attr``) carry the measured comm
time of a profiled dispatch, ``obs`` records (``obs.counters``) the wire
bytes a rank shipped.

Reading a ratio:
  ~1       the model explains the wire;
  >>1      measured comm far above the model: congestion, a straggling
           rank serializing the tree rounds, or a fit that flatters the
           link (measure it again with ``comm_probe`` or let ``obs.calib``
           refit it in the run);
  <1       the model too pessimistic (overlap the model ignores, or work
           of another class that leaked into comm).

The model is the one the planner prices with: ``parallel.comm_model``'s
``predict_comm_ms`` and ``wire_mode_for``, so the planner, the bucket DP,
the critical path's wait split and this ledger never disagree on it. Its
constants come from, in order: explicit arguments; a
``calib_fit_{P}proc.json`` that ``obs.calib`` wrote into the run's out
dir (``load_alpha_beta``'s `search_dir`); the fit measured on the card and
committed with the port for the run's backend (``comm_model.
COMMITTED_FITS``: gloo or NCCL). There is no default link speed: where no
fit is found the ledger prices nothing. One link class is measured, so
the in-slice hop is priced from the same fit.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

from gtopkssgd_tpu_torch.parallel import comm_model
from gtopkssgd_tpu_torch.parallel.codec import get_codec
from gtopkssgd_tpu_torch.parallel.collectives import balanced_cap, tree_rounds

# A fit artifact of the in-run calibrator: calib_fit_{P}proc.json.
_FIT_ARTIFACT_RE = re.compile(r"^calib_fit_(\d+)proc\.json$")


def wire_mode_for(mode: str, schedule: Optional[str] = None,
                  bucketing: Optional[str] = None) -> str:
    """The model's key for (mode, schedule): ``comm_model.wire_mode_for``.
    ``bucketing`` changes how many merges run, not the key; it is taken so
    every call site names the whole wire decision in one place."""
    return comm_model.wire_mode_for(mode, schedule)


def predict_comm_ms(mode: str, p: int, *, n: int, k: int,
                    alpha_ms: float, beta_gbps: float,
                    ici_gbps: Optional[float] = None, ici_size: int = 1,
                    codec: str = "fp32",
                    buckets: Optional[Sequence[Sequence[int]]] = None
                    ) -> float:
    """Predicted ms of one step's exchange: ``comm_model.predict_comm_ms``
    (the planner's). The in-slice link defaults to `beta_gbps` (one link
    class measured)."""
    return comm_model.predict_comm_ms(
        mode, p, n=n, k=k, alpha_ms=alpha_ms, beta_gbps=beta_gbps,
        ici_gbps=beta_gbps if ici_gbps is None else ici_gbps,
        ici_size=ici_size, codec=codec, buckets=buckets)


def _codec_set_bytes(codec: str, k: int, n: int) -> int:
    """On-wire bytes of one encoded k-of-n sparse set under `codec`."""
    return get_codec(codec).wire_set_bytes(k, n)


def _parse_fit_artifact(path: str) -> Optional[Dict[str, Any]]:
    """{alpha_ms, beta_gbps, source[, resid_ms][, axes]} of one fit file,
    or None when it is unreadable or unusable (the JAX parser's rules)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    fit = doc.get("alpha_beta_fit") or {}
    alpha, beta = fit.get("alpha_ms"), fit.get("beta_gbps")
    if not (isinstance(alpha, (int, float))
            and isinstance(beta, (int, float)) and beta > 0):
        return None
    out: Dict[str, Any] = {"alpha_ms": float(alpha),
                           "beta_gbps": float(beta),
                           "source": os.path.basename(path)}
    if isinstance(fit.get("resid_ms"), (int, float)) \
            and fit["resid_ms"] >= 0:
        out["resid_ms"] = float(fit["resid_ms"])
    axes = doc.get("axes")
    if isinstance(axes, dict):
        clean: Dict[str, Dict[str, float]] = {}
        for name, ax in axes.items():
            if (isinstance(ax, dict)
                    and isinstance(ax.get("alpha_ms"), (int, float))
                    and isinstance(ax.get("beta_gbps"), (int, float))
                    and ax["beta_gbps"] > 0):
                clean[str(name)] = {"alpha_ms": float(ax["alpha_ms"]),
                                    "beta_gbps": float(ax["beta_gbps"])}
                if isinstance(ax.get("resid_ms"), (int, float)) \
                        and ax["resid_ms"] >= 0:
                    clean[str(name)]["resid_ms"] = float(ax["resid_ms"])
        if clean:
            out["axes"] = clean
    return out


def load_alpha_beta(search_dir: Optional[str] = None,
                    nprocs: Optional[int] = None,
                    backend: Optional[str] = "gloo"
                    ) -> Optional[Dict[str, Any]]:
    """The {alpha_ms, beta_gbps, source} to price with: a
    ``calib_fit_{P}proc.json`` in `search_dir` first (`nprocs` picks P,
    else the largest P there, compared as numbers; at equal P a file with
    a per-axis ``axes`` section wins), then the committed card fit for
    `backend` (None: no fallback). None when neither is there."""
    if search_dir:
        if nprocs is not None:
            paths = [os.path.join(search_dir, f"calib_fit_{nprocs}proc.json")]
        else:
            paths = glob.glob(os.path.join(search_dir, "calib_fit_*proc.json"))
        best_key, best = None, None
        for path in paths:
            m = _FIT_ARTIFACT_RE.match(os.path.basename(path))
            parsed = _parse_fit_artifact(path)
            if m is None or parsed is None:
                continue
            key = (int(m.group(1)), 1 if "axes" in parsed else 0)
            if best_key is None or key > best_key:
                best_key, best = key, parsed
        if best is not None:
            return best
    if backend is None:
        return None
    try:
        return _parse_fit_artifact(comm_model.committed_fit(backend))
    except ValueError:
        return None


def _manifest_params(manifest: Optional[Mapping[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """(mode, p, n, k, codec, schedule, buckets) from a run manifest (the
    trainer adds the plan's ``comm_plan_schedule`` and the bucket plan's
    ``bucket_sizes``/``bucket_ks`` to the one it prices with); None when
    it lacks what the model needs."""
    if not manifest:
        return None
    mode = manifest.get("compression")
    p = manifest.get("nworkers")
    n = manifest.get("num_params")
    if not mode or not isinstance(p, int) or not isinstance(n, int):
        return None
    rho = manifest.get("density")
    k = (max(1, math.ceil(rho * n))
         if isinstance(rho, (int, float)) and rho > 0 else n)
    if mode == "dense":
        k = n
    codec = manifest.get("wire_codec")
    schedule = manifest.get("comm_plan_schedule")
    sizes, ks = manifest.get("bucket_sizes"), manifest.get("bucket_ks")
    buckets = None
    if (isinstance(sizes, (list, tuple)) and isinstance(ks, (list, tuple))
            and sizes and len(sizes) == len(ks)):
        buckets = tuple(
            (int(n_b), int(k_b)) for n_b, k_b in zip(sizes, ks))
    return {"mode": str(mode), "p": p, "n": n, "k": k,
            "codec": str(codec) if codec else "fp32",
            "schedule": str(schedule) if schedule else None,
            "bucketing": str(manifest.get("buckets") or "concat"),
            "buckets": buckets}


def ledger_rows(records: Sequence[Mapping[str, Any]],
                manifest: Optional[Mapping[str, Any]] = None,
                alpha_ms: Optional[float] = None,
                beta_gbps: Optional[float] = None,
                ici_gbps: Optional[float] = None,
                ici_size: Optional[int] = None,
                probe_dir: Optional[str] = None,
                backend: Optional[str] = None,
                fit: Optional[Mapping[str, Any]] = None) -> List[dict]:
    """The join: one ratio row per measured observation (the JAX
    function's rows). The manifest (explicit, or the stream's first)
    parameterizes the model; ``attr`` records give measured comm time
    (per step with their ``n_steps``), ``obs`` records wire bytes. The
    constants not passed come from `fit` (``load_alpha_beta``'s dict),
    else from ``load_alpha_beta(probe_dir, backend=backend or the
    manifest's)``; [] when the manifest cannot parameterize the model or
    no fit is found."""
    if manifest is None:
        for rec in records:
            if rec.get("kind") == "manifest":
                manifest = rec
                break
    params = _manifest_params(manifest)
    if params is None:
        return []

    fit_source = "arg"
    if alpha_ms is None or beta_gbps is None:
        fit = fit or load_alpha_beta(
            search_dir=probe_dir,
            backend=backend or (manifest or {}).get("backend") or "gloo")
        if fit is None:
            return []
        alpha_ms = fit["alpha_ms"] if alpha_ms is None else alpha_ms
        beta_gbps = fit["beta_gbps"] if beta_gbps is None else beta_gbps
        fit_source = fit["source"]
    alpha_ms, beta_gbps = float(alpha_ms), float(beta_gbps)
    ici_gbps = beta_gbps if ici_gbps is None else float(ici_gbps)
    if ici_size is None:
        hier = (manifest or {}).get("hier_ici")
        ici_size = (int(hier) if params["mode"] == "gtopk_hier"
                    and isinstance(hier, int) and hier > 0
                    and params["p"] % hier == 0 else 1)

    wm = wire_mode_for(params["mode"], params.get("schedule"),
                       bucketing=params.get("bucketing"))
    buckets = params.get("buckets")
    predicted_ms = predict_comm_ms(
        wm, params["p"], n=params["n"], k=params["k"],
        alpha_ms=alpha_ms, beta_gbps=beta_gbps, ici_gbps=ici_gbps,
        ici_size=ici_size, codec=params["codec"], buckets=buckets)

    base = {
        "mode": params["mode"], "p": params["p"],
        "n": params["n"], "k": params["k"], "codec": params["codec"],
        "schedule": params.get("schedule"),
        "bucketing": params.get("bucketing", "concat"),
        "n_buckets": len(buckets) if buckets else None,
        "alpha_ms": round(alpha_ms, 6), "beta_gbps": round(beta_gbps, 6),
        "ici_size": ici_size, "fit_source": fit_source,
        "predicted_comm_ms": round(predicted_ms, 6),
    }
    rows: List[dict] = []
    for rec in records:
        kind = rec.get("kind")
        rank = rec.get("rank", 0)
        if kind == "attr":
            t_comm_us = rec.get("t_comm_us")
            if not isinstance(t_comm_us, (int, float)):
                continue
            measured_ms = float(t_comm_us) / 1e3
            n_steps = rec.get("n_steps")
            if isinstance(n_steps, (int, float)) and n_steps > 0:
                measured_ms /= float(n_steps)
            rows.append({
                **base, "source": "attr", "rank": rank,
                "step": rec.get("step"),
                "measured_comm_ms": round(measured_ms, 6),
                "ratio": (round(measured_ms / predicted_ms, 6)
                          if predicted_ms > 0 else None),
            })
        elif kind == "obs":
            wire = rec.get("wire_bytes")
            if not isinstance(wire, (int, float)) or wire <= 0:
                continue
            # Bytes-side row: achieved wire bytes against the model's
            # volume a rank a step (a sparse round ships one encoded set;
            # the dense ring 2(p-1)/p x 4n). No timing.
            p = params["p"]

            def _sparse_pred_bytes(k, nn):
                set_bytes = _codec_set_bytes(params["codec"], k, nn)
                if wm == "gtopk_balanced":
                    return max(1, 2 * p - 1) * _codec_set_bytes(
                        params["codec"], balanced_cap(k, p, nn), nn)
                if wm in ("gtopk", "gtopk_hier"):
                    return tree_rounds(
                        p if wm == "gtopk"
                        else max(1, p // ici_size)) * set_bytes
                if wm == "allgather":
                    return set_bytes * (p - 1)
                return 0.0

            if wm == "dense":
                nn = params["n"]
                pred_bytes = 2.0 * (p - 1) / p * 4 * nn if p > 1 else 0.0
            elif buckets:
                pred_bytes = sum(
                    _sparse_pred_bytes(k_b, n_b) for n_b, k_b in buckets)
            else:
                pred_bytes = _sparse_pred_bytes(params["k"], params["n"])
            rows.append({
                **base, "source": "wire_bytes", "rank": rank,
                "step": rec.get("step"),
                "measured_wire_bytes": float(wire),
                "predicted_wire_bytes": round(pred_bytes, 1),
                "ratio": (round(float(wire) / pred_bytes, 6)
                          if pred_bytes > 0 else None),
            })
    return rows


def summarize_ledger(rows: Sequence[Mapping[str, Any]]
                     ) -> Dict[str, Dict[str, Any]]:
    """{source: {count, mean_ratio, min_ratio, max_ratio, worst_ranks}}:
    worst_ranks are the (at most two) ranks whose mean ratio is highest."""
    by_source: Dict[str, List[Mapping[str, Any]]] = {}
    for row in rows:
        if isinstance(row.get("ratio"), (int, float)):
            by_source.setdefault(str(row.get("source")), []).append(row)
    out: Dict[str, Dict[str, Any]] = {}
    for source, rws in by_source.items():
        ratios = [float(r["ratio"]) for r in rws]
        by_rank: Dict[Any, List[float]] = {}
        for r in rws:
            by_rank.setdefault(r.get("rank", 0), []).append(
                float(r["ratio"]))
        rank_means = {rk: sum(v) / len(v) for rk, v in by_rank.items()}
        worst = sorted(rank_means, key=rank_means.get, reverse=True)[:2]
        out[source] = {
            "count": len(ratios),
            "mean_ratio": round(sum(ratios) / len(ratios), 4),
            "min_ratio": round(min(ratios), 4),
            "max_ratio": round(max(ratios), 4),
            "worst_ranks": {str(rk): round(rank_means[rk], 4)
                            for rk in worst},
        }
    return out
