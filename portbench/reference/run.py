"""The reference's first steps of a cell, from the seed and the
harness's batches: what the comparison in ``portbench.check`` reads.

``reference_steps`` returns a ``Record`` of the steps: each step's loss
(the mean over the workers), the flat parameters before the first step
and after the last, and per worker the first step's kept mask and the
first gradient as the optimizer gets it (the residual after the step plus
the update it applied), with each leaf's gradient norm at every step,
summed over the workers. Matrix products and convolutions run in float32
with TF32 off (``precision="float32"``), or with operands rounded to fp8
for the precision control (``precision="fp8"``).

The model is the configuration's kind (``portbench/kinds/``); the
exchange is the module of ``portbench.reference`` named by the traffic's
``compression`` (``gtopk.py``, ``dense.py``), whose ``step`` turns the
workers' gradients and residuals into the update; SGD is ``gtopk.sgd``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import spec
from portbench.reference import gtopk, lowp, models


def dropout_seed(seed: int, rank: int) -> int:
    """Worker `rank`'s dropout stream: the first word of the seed
    sequence (seed, rank)."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def exchange(traffic: Dict):
    """The reference's exchange for the traffic's ``compression`` (None
    is the port's dense default)."""
    name = traffic["train_config"].get("compression") or "dense"
    return spec.module("portbench.reference", name)


def reference_steps(config: Dict, traffic: Dict, seed: int, workers: int,
                    batches: List[List[Dict[str, np.ndarray]]], steps: int,
                    device, precision: str = "float32") -> Dict:
    """`batches[r][s]`: worker r's host batch of step s, as the kind's
    ``pool`` makes it."""
    _set_tf32(False)
    tc = traffic["train_config"]
    density = float(tc.get("density", 1.0))
    lr = float(np.float32(config["lr"]))
    momentum, wd = float(config["momentum"]), float(config["weight_decay"])
    quant = lowp.QUANT[precision] or models.identity
    step = exchange(traffic).step
    host = models.init(config, seed)
    order = models.flat_order(host, config)
    leaves = models.leaves(host, order)
    flat = models.ravel(host, order).to(device)
    n = flat.shape[0]
    k = max(1, int(np.ceil(density * n)))
    template = {key: torch.empty(t.shape, device="meta")
                for key, t in host.items()}
    del host
    gens = [None] * workers
    if float(config["arch"].get("dropout", 0.0)) > 0:
        gens = [torch.Generator(device=device).manual_seed(
            dropout_seed(seed, r)) for r in range(workers)]
    residuals = [torch.zeros(n, device=device) for _ in range(workers)]
    velocity = None
    p0 = flat.clone()
    rec = {"losses": [], "leaves": leaves, "grad_norms": []}
    for s in range(steps):
        grads, losses = [], []
        for r in range(workers):
            params = models.unravel(flat, template, order)
            params = {key: t.detach().clone().requires_grad_(True)
                      for key, t in params.items()}
            b = {key: torch.from_numpy(v).to(device)
                 for key, v in batches[r][s].items()}
            loss = models.loss(config, params, b, quant, gens[r])
            loss.backward()
            grads.append(models.ravel({key: t.grad for key, t in
                                       params.items()}, order))
            losses.append(loss.detach())
            del params, b, loss
        rec["losses"].append(float(torch.stack(losses).mean()))
        gsum = torch.stack([_leaf_norms(g, leaves) for g in grads]).sum(0)
        rec["grad_norms"].append(gsum.cpu())
        update, residuals, kept = step(grads, residuals, k)
        if s == 0:
            rec["h1"] = [(e + update).cpu() for e in residuals]
            rec["keep1"] = [m.cpu() for m in kept]
        flat, velocity = gtopk.sgd(flat, update, velocity, lr, momentum, wd)
        del grads
    rec["p0"] = p0.cpu()
    rec["p3"] = flat.cpu()
    rec["k"] = k
    return rec


def _leaf_norms(flat: torch.Tensor, leaves) -> torch.Tensor:
    return torch.stack([flat[o:o + s].double().norm()
                        for _, o, s in leaves])
