"""The reference's models as plain functions of a parameter dict, and the
flat gradient's layout.

Each kind of model is a module of ``portbench.kinds``, found by the
configuration's ``arch["kind"]``; ``init`` and ``loss`` here go through
it. The parameters are kept by their flax paths (``("BottleneckBlock_3",
"Conv_1", "kernel")``), the names of the model as the JAX package defines
it, in PyTorch's layouts (conv OIHW, dense (out, in)). ``flat_order``
lays them out as the paper's flat gradient: paths sorted as strings at
each level, each leaf permuted into the flax layout, the order in which
``ravel_pytree`` flattens a flax tree. The two-stage selection buckets
positions of that vector, so the order is part of the selection's
definition. A kind may give its own ``flat_perm``; the default is
``flat_perm`` below.

Kernels are initialised as flax does, LeCun normal truncated at two
standard deviations (variance 1/fan_in; ``lecun_normal``), drawn from
one CPU ``torch.Generator`` seeded with the seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from portbench import spec

Path = Tuple[str, ...]
Params = Dict[Path, torch.Tensor]
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def lecun_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """A kernel of `shape` (out first): truncated normal, variance
    1/fan_in."""
    fan_in = int(np.prod(shape[1:]))
    std = math.sqrt(1.0 / fan_in) / TRUNC
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=gen)
    return w


def init(config: Dict, seed: int) -> Params:
    return spec.kind(config).init(config, seed)


def loss(config: Dict, p: Params, batch: Dict[str, torch.Tensor],
         quant: Callable = identity, gen=None) -> torch.Tensor:
    return spec.kind(config).loss(config, p, batch, quant, gen)


def flat_perm(path: Path, dims: int) -> Tuple[int, ...]:
    """The default rule: conv OIHW -> HWIO, dense (out, in) -> (in, out),
    any other leaf as it is."""
    if dims == 4:
        return (2, 3, 1, 0)
    if dims == 2:
        return (1, 0)
    return tuple(range(dims))


Order = List[Tuple[Path, Tuple[int, ...]]]


def flat_order(p: Params, config: Dict) -> Order:
    """The leaves in the flat vector's order, paths sorted, each with the
    permutation that lays it out there: the kind's ``flat_perm``, or the
    default rule."""
    rule = getattr(spec.kind(config), "flat_perm", flat_perm)
    return [(k, tuple(rule(k, p[k].dim()))) for k in sorted(p)]


def ravel(p: Params, order: Order) -> torch.Tensor:
    return torch.cat([p[k].permute(perm).reshape(-1) for k, perm in order])


def unravel(flat: torch.Tensor, like: Params, order: Order) -> Params:
    out, off = {}, 0
    for k, perm in order:
        t = like[k]
        n = t.numel()
        shape = [t.shape[d] for d in perm]
        inverse = sorted(range(len(perm)), key=perm.__getitem__)
        out[k] = flat[off:off + n].view(shape).permute(inverse)
        off += n
    return out


def leaves(p: Params, order: Order) -> List[Tuple[str, int, int]]:
    """(name, offset, size) of each leaf in the flat vector."""
    out, off = [], 0
    for k, _ in order:
        n = p[k].numel()
        out.append(("/".join(k), off, n))
        off += n
    return out
