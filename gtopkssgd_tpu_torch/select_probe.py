"""The selection stage's cost on the card, fitted for the pipeline model.

    python -m gtopkssgd_tpu_torch.select_probe [--out PATH] [--reps R]

Times the port's own selection stage, ``GTopKSGD._select`` (accumulate,
local top-k at density 0.001, zero-out; the fp32 wire, no codec fold),
for each method (``exact | threshold | pallas | twostage``) at every
distinct leaf size of ResNet-20 and ResNet-50 (``leaf_sizes``, 10 to
2,359,296) and at ResNet-50's ``--buckets 4`` bucket sizes
(``bucket_sizes``). Each call is bracketed by CUDA events on an idle card
and the median of `reps` calls is kept, so a time holds the host's
launches as a step sees them. Per method, the fit is the JAX package's
form through the origin, ms = gamma * n / 1e6 (least squares), with its
largest relative error over the sizes; a launch floor dominates at small
n, and the linear form has no term for it.

Before timing, each method's stage runs once under
``torch.cuda.set_sync_debug_mode("error")``: a host sync in the selection
would raise (it would also keep the ``overlap`` pipeline from running a
selection under a merge).

Writes ``parallel/select_fit.json`` (or `--out`): the card's name and
power limit as nvidia-smi reports them, and per method the sizes, times,
gamma and the fit's error. ``parallel.bucketing.find_select_gamma`` reads
it by the card's name and the method. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from gtopkssgd_tpu_torch.parallel import bucketing

METHODS = ("exact", "threshold", "pallas", "twostage")
LEAF_MODELS = ("resnet20", "resnet50")
DENSITY = 0.001
REPS = 20


def layout_sizes(dnn: str) -> Tuple[int, ...]:
    """`dnn`'s leaf sizes in flat order (the model built on the meta
    device)."""
    from gtopkssgd_tpu_torch.convert import flat_layout
    from gtopkssgd_tpu_torch.models import get_model

    with torch.device("meta"):
        model, _ = get_model(dnn)
    return tuple(flat_layout(model).sizes)


def leaf_sizes(models: Sequence[str] = LEAF_MODELS) -> List[int]:
    """Every distinct leaf size of `models`, ascending."""
    return sorted({n for dnn in models for n in layout_sizes(dnn)})


def bucket_sizes(dnn: str = "resnet50", buckets: int = 4, p: int = 4,
                 fit_path: str = None) -> List[int]:
    """The bucket sizes of `dnn` under ``--buckets B`` at P ranks, priced
    with the committed gloo fit (or `fit_path`) in the 'serial' order."""
    plan = bucketing.plan_buckets(layout_sizes(dnn), DENSITY,
                                  buckets=buckets, p=p, fit_path=fit_path)
    return list(plan.sizes)


def _stage(method: str, n: int, device: torch.device):
    """A call of the selection stage over fresh n-element operands."""
    from gtopkssgd_tpu_torch.optimizer import GTopKSGD

    gen = torch.Generator(device=device).manual_seed(n)
    buf = torch.randn(2 * n, device=device, generator=gen)
    grad, residual = buf[:n], 0.3 * buf[n:]
    opt = GTopKSGD([torch.nn.Parameter(torch.zeros(n, device=device))], 0.1,
                   compression="gtopk_layerwise", density=DENSITY,
                   topk_method=method)
    return lambda: opt._select(grad, residual, None)


def stage_ms(method: str, n: int, reps: int = REPS,
             device: str = "cuda") -> float:
    """Median ms of one selection-stage call at size n, CUDA events around
    the call on an idle card."""
    call = _stage(method, n, torch.device(device))
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_no_host_sync(method: str, n: int, device: str = "cuda") -> None:
    """One call of the stage with host syncs made errors."""
    call = _stage(method, n, torch.device(device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def fit(sizes: Sequence[int], ms: Sequence[float]) -> Dict[str, float]:
    """gamma of ms = gamma * n / 1e6 by least squares through the origin,
    and the largest relative error of the fit over the sizes."""
    x = [n / 1e6 for n in sizes]
    gamma = sum(a * t for a, t in zip(x, ms)) / sum(a * a for a in x)
    err = max(abs(gamma * a - t) / t for a, t in zip(x, ms))
    return {"gamma_ms_per_melem": gamma, "max_rel_err": err}


def probe(sizes: Sequence[int], methods: Sequence[str] = METHODS,
          reps: int = REPS) -> List[dict]:
    """Per method: the sizes, their stage ms and the fit."""
    out = []
    for method in methods:
        check_no_host_sync(method, max(sizes))
        ms = [stage_ms(method, n, reps) for n in sizes]
        out.append({"method": method, "sizes": list(sizes), "ms": ms,
                    **fit(sizes, ms)})
    return out


def write_fit(doc: dict, fh) -> None:
    """`doc` as JSON, one line a key and one a fit."""
    head = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in doc.items()
            if k != "fits"]
    fits = ",\n".join("  " + json.dumps(f) for f in doc["fits"])
    fh.write("{\n" + ",\n".join(head) + ',\n "fits": [\n' + fits
             + "\n ]\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=bucketing.SELECT_FIT)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_probe: no CUDA device", file=sys.stderr)
        return 2
    from gtopkssgd_tpu_torch.profile_step import card_identity

    card = card_identity()
    device = torch.cuda.get_device_name(0)
    power_limit = card.split(",")[-1].strip()
    sizes = sorted(set(leaf_sizes()) | set(bucket_sizes()))
    fits = [{"device": device, "power_limit": power_limit, **f}
            for f in probe(sizes, reps=args.reps)]
    for f in fits:
        print(f"select {f['method']}: gamma {f['gamma_ms_per_melem']:.5f} "
              f"ms per 1e6 elements, largest relative error "
              f"{f['max_rel_err']:.3f}; ms at n = "
              + ", ".join(f"{n}: {t:.4f}" for n, t in zip(f["sizes"],
                                                         f["ms"])))
    doc = {"script": bucketing.SELECT_PROBE,
           "form": "ms = gamma_ms_per_melem * n / 1e6, least squares "
                   "through the origin",
           "stage": "GTopKSGD._select, density 0.001, fp32 wire; median "
                    f"of {args.reps} calls, CUDA events on an idle card",
           "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "fits": fits}
    with open(args.out, "w") as fh:
        write_fit(doc, fh)
    print(card)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
