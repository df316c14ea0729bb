"""Carry weights between the JAX package's flax models and the port's, and
fix the flat gradient order, for every model of the zoo.

* ``from_jax_params(params, batch_stats)`` turns flax's nested numpy trees
  into a ``state_dict`` for the port's model: conv kernels HWIO -> OIHW,
  Dense (in, out) -> (out, in), BatchNorm scale/bias/mean/var ->
  weight/bias/running_mean/running_var.
* ``load_jax_state(trainer, ...)`` carries a JAX trainer's whole state
  into a port ``Trainer``: weights and BatchNorm statistics (none for
  AlexNet and the PTB model), the SGD momentum, this rank's row of the
  per-rank ``[P, N]`` residual (or of its {"v", "u"} pair under momentum
  correction), the step count, and for the PTB model this rank's row of
  the BPTT carry.
* ``flat_layout(model)`` orders the model's parameters as the JAX package's
  ``ravel_pytree`` does -- flax's module paths sorted as strings at each
  level (``BasicBlock_10`` before ``BasicBlock_2``, ``BatchNorm_0`` before
  ``Conv_0``; ``bias`` before ``kernel`` and ``scale``), each kernel in the
  reference's layout. The two-stage top-k buckets are positions in that
  flat vector, so this order decides what is selected.

The port's module names map onto flax's auto-generated ones:

* the ResNets: ``conv``, ``bn``, ``fc`` are ``Conv_0``, ``BatchNorm_0``,
  ``Dense_0``; ``blocks.i`` is ``BasicBlock_i`` and ``bottlenecks.i`` is
  ``BottleneckBlock_i``, whose layers are named in ``_BLOCKS``;
* VGG-16, AlexNet and the AN4 model: ``convs.i``, ``bns.i``, ``fcs.i`` are
  ``Conv_i``, ``BatchNorm_i``, ``Dense_i``;
* the recurrent models: ``cells.i.kernel.<gate>`` and
  ``cells.i.bias.<gate>`` are ``OptimizedLSTMCell_i/<gate>/kernel`` and
  ``.../bias`` (gates ``ii if ig io hi hf hg ho``, biases on the ``h``
  ones only), ``embed`` is ``Embed_0`` (its table is (vocab, features)
  in both layouts) and ``fc`` is ``Dense_0``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gtopkssgd_tpu_torch.optimizer import FlatLayout

Path = Tuple[str, ...]

_TOP = {"conv": "Conv_0", "bn": "BatchNorm_0", "fc": "Dense_0",
        "embed": "Embed_0"}
_CELL = "OptimizedLSTMCell"
_LISTS = {"convs": "Conv", "bns": "BatchNorm", "fcs": "Dense"}
# Block lists: port list name -> (flax block class, port layer -> flax).
_BLOCKS = {
    "blocks": ("BasicBlock", {
        "conv1": "Conv_0", "bn1": "BatchNorm_0", "conv2": "Conv_1",
        "bn2": "BatchNorm_1", "shortcut.0": "Conv_2",
        "shortcut.1": "BatchNorm_2"}),
    "bottlenecks": ("BottleneckBlock", {
        "conv1": "Conv_0", "bn1": "BatchNorm_0", "conv2": "Conv_1",
        "bn2": "BatchNorm_1", "conv3": "Conv_2", "bn3": "BatchNorm_2",
        "shortcut.0": "Conv_3", "shortcut.1": "BatchNorm_3"}),
}
_LEAF = {
    "Conv": {"weight": "kernel", "bias": "bias"},
    "Dense": {"weight": "kernel", "bias": "bias"},
    "BatchNorm": {"weight": "scale", "bias": "bias",
                  "running_mean": "mean", "running_var": "var"},
    "Embed": {"weight": "embedding"},
}
# Port layout -> reference layout, by tensor rank: conv OIHW -> HWIO,
# Linear (out, in) -> (in, out), vectors unchanged.
_TO_REF = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}
_FROM_REF = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}


def flax_path(name: str) -> Path:
    """'blocks.3.shortcut.1.weight' -> ('BasicBlock_3', 'BatchNorm_2',
    'scale'), 'convs.4.bias' -> ('Conv_4', 'bias'), 'cells.1.kernel.if'
    -> ('OptimizedLSTMCell_1', 'if', 'kernel'); parameters and BatchNorm
    buffers alike."""
    parts = name.split(".")
    head, leaf = parts[0], parts[-1]
    if head == "cells":
        return (f"{_CELL}_{parts[1]}", parts[3], parts[2])
    if head in _BLOCKS:
        cls, layers = _BLOCKS[head]
        prefix = (f"{cls}_{parts[1]}", layers[".".join(parts[2:-1])])
    elif head in _LISTS:
        prefix = (f"{_LISTS[head]}_{parts[1]}",)
    else:
        prefix = (_TOP[".".join(parts[:-1])],)
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


def _perm(path: Path, dim: int, table) -> Tuple[int, ...]:
    """`table`'s permutation (``_TO_REF`` or ``_FROM_REF``) for the tensor
    of rank `dim` at flax path `path`; an embedding table is (vocab,
    features) in both layouts."""
    return (0, 1) if path[0].startswith("Embed_") else table[dim]


def from_jax_params(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from flax's params and
    batch_stats trees (numpy or jax arrays; no batch_stats for AlexNet
    and the PTB model)."""
    by_path = {**_flatten(params), **_flatten(batch_stats or {})}
    names = _port_names(by_path)
    out = {}
    for path, value in by_path.items():
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        perm = _perm(path, t.dim(), _FROM_REF)
        out[names[path]] = t.permute(perm).contiguous()
    return out


def load_jax_state(trainer, params: Mapping[str, Any],
                   batch_stats: Optional[Mapping[str, Any]],
                   momentum: Optional[Mapping[str, Any]], residual,
                   count: int, carry: Sequence = ()) -> None:
    """Load a JAX trainer's state, as numpy trees, into `trainer` (one
    rank): ``momentum`` is optax's SGD trace, a tree like ``params``, or
    None where there is none (under momentum correction the SGD step has
    no momentum); ``residual`` is f32[N] at P = 1 and the per-rank
    f32[P, N] above it, of which this rank takes row ``trainer.rank`` --
    under momentum correction a mapping {"v": ..., "u": ...} of two such
    arrays, the accumulated and the local velocity; ``carry`` is the JAX
    trainer's BPTT carry, one (c, h) pair of f32[P, B, H] per layer (empty
    for the other models), of which this rank takes row
    ``trainer.rank``."""
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
    if len(carry):
        trainer.carry = tuple(
            tuple(torch.from_numpy(np.array(x, dtype=np.float32)[
                trainer.rank]).to(device) for x in pair)
            for pair in carry)


def _inverse(mapping: Mapping[str, str]) -> Dict[str, str]:
    return {v: k for k, v in mapping.items()}


def _port_name(path: Path, resnet: bool, recurrent: bool) -> str:
    """The inverse of ``flax_path``; `resnet`: the tree holds blocks, so
    its top-level ``Conv_0``, ``BatchNorm_0``, ``Dense_0`` are ``conv``,
    ``bn``, ``fc`` rather than ``convs.0``, ``bns.0``, ``fcs.0``;
    `recurrent`: the tree holds LSTM cells, so ``Embed_0`` and ``Dense_0``
    are ``embed`` and ``fc``."""
    *mods, leaf = path
    cls, _, idx = mods[0].rpartition("_")
    if cls == _CELL:
        return f"cells.{idx}.{leaf}.{mods[1]}"
    if recurrent and cls in ("Embed", "Dense"):
        mod = _inverse(_TOP)[mods[0]]
    elif len(mods) == 2:
        head = next(h for h, (c, _) in _BLOCKS.items() if c == cls)
        mod = f"{head}.{idx}.{_inverse(_BLOCKS[head][1])[mods[1]]}"
    elif resnet:
        mod = _inverse(_TOP)[mods[0]]
    else:
        mod = f"{_inverse(_LISTS)[cls]}.{idx}"
    return f"{mod}.{_inverse(_LEAF[mods[-1].split('_')[0]])[leaf]}"


def _port_names(paths) -> Dict[Path, str]:
    """flax path -> port name, for every path of a zoo model's tree."""
    recurrent = any(p[0].startswith(_CELL) for p in paths)
    resnet = not recurrent and any(len(p) > 2 for p in paths)
    names = {}
    for path in paths:
        try:
            names[path] = _port_name(path, resnet, recurrent)
        except (KeyError, StopIteration):
            raise ValueError(f"no port name for flax path {path}") from None
    return names


def flat_layout(model: nn.Module) -> FlatLayout:
    """The model's parameters in ``ravel_pytree`` order and layout."""
    named = sorted((flax_path(name), p)
                   for name, p in model.named_parameters())
    return FlatLayout([(p, _perm(path, p.dim(), _TO_REF))
                       for path, p in named])
