"""Carry weights between the JAX package's flax ResNets and the port's, and
fix the flat gradient order.

* ``from_jax_params(params, batch_stats)`` turns flax's nested numpy trees
  into a ``state_dict`` for ``models.ResNetCIFAR``: conv kernels HWIO ->
  OIHW, Dense (in, out) -> (out, in), BatchNorm scale/bias/mean/var ->
  weight/bias/running_mean/running_var.
* ``load_jax_state(trainer, ...)`` carries a JAX trainer's whole state
  into a port ``Trainer``: weights and BatchNorm statistics, the SGD
  momentum, this rank's row of the per-rank ``[P, N]`` residual (or of
  its {"v", "u"} pair under momentum correction), and the step count.
* ``flat_layout(model)`` orders the model's parameters as the JAX package's
  ``ravel_pytree`` does -- flax's sorted module paths (``BasicBlock_0`` ..
  ``BasicBlock_8``, ``BatchNorm_0``, ``Conv_0``, ``Dense_0``; in a block
  ``BatchNorm_0..2`` before ``Conv_0..2``; ``bias`` before ``scale``),
  each kernel in the reference's layout. The two-stage top-k buckets are
  positions in that flat vector, so this order decides what is selected.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gtopkssgd_tpu_torch.optimizer import FlatLayout

Path = Tuple[str, ...]

# The port's module names -> flax's auto-generated ones.
_TOP = {"conv": "Conv_0", "bn": "BatchNorm_0", "fc": "Dense_0"}
_BLOCK = {"conv1": "Conv_0", "bn1": "BatchNorm_0", "conv2": "Conv_1",
          "bn2": "BatchNorm_1", "shortcut.0": "Conv_2",
          "shortcut.1": "BatchNorm_2"}
_LEAF = {
    "Conv": {"weight": "kernel"},
    "Dense": {"weight": "kernel", "bias": "bias"},
    "BatchNorm": {"weight": "scale", "bias": "bias",
                  "running_mean": "mean", "running_var": "var"},
}
# Port layout -> reference layout, by tensor rank: conv OIHW -> HWIO,
# Linear (out, in) -> (in, out), vectors unchanged.
_TO_REF = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}
_FROM_REF = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}


def flax_path(name: str) -> Path:
    """'blocks.3.shortcut.1.weight' -> ('BasicBlock_3', 'BatchNorm_2',
    'scale'); parameters and BatchNorm buffers alike."""
    parts = name.split(".")
    module, leaf = ".".join(parts[:-1]), parts[-1]
    if parts[0] == "blocks":
        inner = ".".join(parts[2:-1])
        prefix = (f"BasicBlock_{parts[1]}", _BLOCK[inner])
    else:
        prefix = (_TOP[module],)
    kind = prefix[-1].split("_")[0]
    return prefix + (_LEAF[kind][leaf],)


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def from_jax_params(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``ResNetCIFAR`` from flax's params and
    batch_stats trees (numpy or jax arrays)."""
    by_path = {**_flatten(params), **_flatten(batch_stats)}
    names = _torch_names(by_path)
    out = {}
    for path, value in by_path.items():
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        out[names[path]] = t.permute(_FROM_REF[t.dim()]).contiguous()
    return out


def load_jax_state(trainer, params: Mapping[str, Any],
                   batch_stats: Mapping[str, Any],
                   momentum: Optional[Mapping[str, Any]], residual,
                   count: int) -> None:
    """Load a JAX trainer's state, as numpy trees, into `trainer` (one
    rank): ``momentum`` is optax's SGD trace, a tree like ``params``, or
    None where there is none (under momentum correction the SGD step has
    no momentum); ``residual`` is f32[N] at P = 1 and the per-rank
    f32[P, N] above it, of which this rank takes row ``trainer.rank`` --
    under momentum correction a mapping {"v": ..., "u": ...} of two such
    arrays, the accumulated and the local velocity."""
    trainer.model.load_state_dict(from_jax_params(params, batch_stats))
    named = dict(trainer.model.named_parameters())
    opt = trainer.optimizer
    device = trainer.device

    def row(x) -> torch.Tensor:
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 2:
            x = x[trainer.rank]
        return torch.from_numpy(x.copy()).to(device)

    if momentum is not None:
        for name, buf in from_jax_params(momentum, {}).items():
            opt.state[named[name]]["momentum_buffer"] = buf.to(device)
    if isinstance(residual, Mapping):
        opt.state["residual"] = {key: row(residual[key]) for key in "vu"}
    else:
        opt.state["residual"] = row(residual)
    opt.state["count"] = int(count)


def _torch_names(paths) -> Dict[Path, str]:
    """flax path -> port name, for every path of a ResNetCIFAR tree."""
    nblocks = len({p[0] for p in paths if p[0].startswith("BasicBlock_")})
    model_names = []
    for i in range(nblocks):
        for mod in _BLOCK:
            model_names.append(f"blocks.{i}.{mod}")
    model_names += list(_TOP)
    names = {}
    for mod in model_names:
        kind = flax_path(mod + ".weight")[-2].split("_")[0]
        for leaf in _LEAF[kind]:
            names[flax_path(f"{mod}.{leaf}")] = f"{mod}.{leaf}"
    missing = set(paths) - set(names)
    if missing:
        raise ValueError(f"no port name for flax paths {sorted(missing)}")
    return names


def flat_layout(model: nn.Module) -> FlatLayout:
    """The model's parameters in ``ravel_pytree`` order and layout."""
    named = sorted(model.named_parameters(),
                   key=lambda item: flax_path(item[0]))
    return FlatLayout([(p, _TO_REF[p.dim()]) for _, p in named])
