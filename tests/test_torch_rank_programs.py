"""Rank programs for the port's distributed tests; this file holds no test.

``tests/test_torch_collectives.py`` and ``tests/test_torch_dist.py`` run
these on spawned ranks through ``gtopkssgd_tpu_torch.parallel.dist.spawn``.
A rank process imports this module afresh, so it imports torch, numpy and
the port only -- never jax or the JAX package.
"""

import dataclasses
import functools

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch import data, models
from gtopkssgd_tpu_torch.convert import load_jax_state
from gtopkssgd_tpu_torch.optimizer import GTopKSGD
from gtopkssgd_tpu_torch.parallel import collectives
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer


def gtopk_over_groups(device, sets, k, n):
    """For each P of `sets` ({P: (vals f32[P, k], idx i32[P, k])}), the
    first P ranks run ``gtopk_allreduce`` over a group of their own; this
    rank's global set and wire counters, by P."""
    rank = dist.get_rank()
    out = {}
    for p in sorted(sets):
        group = dist.new_group(list(range(p)))  # every rank must call it
        if rank >= p:
            continue
        vals, idx = sets[p]
        collectives.reset_wire()
        gvals, gidx = collectives.gtopk_allreduce(
            torch.from_numpy(vals[rank]).to(device),
            torch.from_numpy(idx[rank]).to(device), k=k, n=n, group=group)
        out[p] = {"vals": gvals, "idx": gidx, **collectives.wire}
    return out


def codec_collectives(device, tree_sets, gather_sets, k, n):
    """For each (codec, P) of `tree_sets` ({(codec, P): (vals f32[P, k],
    idx i32[P, k])}), the first P ranks run ``gtopk_allreduce`` with that
    codec over a group of their own; likewise ``topk_allgather`` for
    `gather_sets`. This rank's results and wire counters, by (kind,
    codec, P)."""
    rank = dist.get_rank()
    cases = [("tree", c, p, s) for (c, p), s in sorted(tree_sets.items())]
    cases += [("gather", c, p, s)
              for (c, p), s in sorted(gather_sets.items())]
    groups = {p: dist.new_group(list(range(p)))  # every rank calls it
              for p in sorted({case[2] for case in cases})}
    out = {}
    for kind, codec, p, (vals, idx) in cases:
        if rank >= p:
            continue
        v = torch.from_numpy(vals[rank]).to(device)
        i = torch.from_numpy(idx[rank]).to(device)
        collectives.reset_wire()
        if kind == "tree":
            gv, gi = collectives.gtopk_allreduce(v, i, k=k, n=n,
                                                 group=groups[p], codec=codec)
            res = {"vals": gv, "idx": gi}
        else:
            res = {"dense": collectives.topk_allgather(
                v, i, k=k, n=n, group=groups[p], codec=codec)}
        out[(kind, codec, p)] = {**res, **collectives.wire}
    return out


def _residual_copy(residual):
    if isinstance(residual, dict):
        return {key: t.clone() for key, t in residual.items()}
    return residual.clone()


def optimizer_steps(device, p0, grads, opt_kwargs):
    """``GTopKSGD`` over the whole world on one flat parameter from `p0`,
    one step per entry of `grads` (f32[P, N] each, row = rank); after each
    step the parameter, the residual (a {"v", "u"} dict under momentum
    correction), and the global set (gtopk) or the dense union (the
    allgather modes), None after a dense warm-up step."""
    rank = dist.get_rank()
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(device))
    opt = GTopKSGD([param], process_group=dist.group.WORLD, **opt_kwargs)
    out = []
    for g in grads:
        param.grad = torch.from_numpy(g[rank].copy()).to(device)
        opt.step()
        gvals, gidx = opt.last_global or (None, None)
        out.append({"params": param.detach().clone(),
                    "residual": _residual_copy(opt.state["residual"]),
                    "gvals": gvals, "gidx": gidx, "union": opt.last_union})
    return out


def optimizer_cases(device, p0, grads, cases):
    """``optimizer_steps`` for each {name: opt_kwargs} of `cases`, in one
    world; the results by name."""
    return {name: optimizer_steps(device, p0, grads, kw)
            for name, kw in cases.items()}


def trainer_steps_from_states(device, cfg_kwargs, states):
    """One trainer step from each of `states` (``load_jax_state``'s
    arguments); after each step the loss, this rank's residual, the global
    index set and the BatchNorm buffers."""
    trainer = Trainer(TrainConfig(device=str(device), **cfg_kwargs))
    opt = trainer.optimizer
    out = []
    for state in states:
        load_jax_state(trainer, **state)
        loss = trainer.train(1)["loss"]
        out.append({"loss": loss, "residual": opt.state["residual"].clone(),
                    "gidx": opt.last_global[1],
                    "buffers": {name: b.clone() for name, b
                                in trainer.model.named_buffers()}})
    return out


def small_alexnet_steps_and_test(device, cfg_kwargs, steps):
    """AlexNet at 64x64 with 10 classes on a synthetic ImageNet of that
    size (the zoo's and the dataset registry's entries replaced in this
    rank process only): `steps` trainer steps at P ranks, then
    ``test()``; also the ``test()`` of a P = 1 trainer holding the same
    weights. This rank's flat parameters, losses, both metrics and the
    number of validation batches it synthesized."""
    models._ZOO["alexnet"] = dataclasses.replace(
        models._ZOO["alexnet"],
        build=functools.partial(models.AlexNet, num_classes=10,
                                image_size=64))
    data._DATASETS["imagenet"] = functools.partial(
        data.ImageNetDataset, image_size=64, num_classes=10)
    trainer = Trainer(TrainConfig(device=str(device), **cfg_kwargs))
    losses = trainer.train(steps)["losses"]
    made = []
    synth = trainer.val_data._synth_batch
    trainer.val_data._synth_batch = lambda sel: made.append(1) or synth(sel)
    metrics = trainer.test()
    one = Trainer(TrainConfig(device=str(device),
                              **{**cfg_kwargs, "nworkers": 1}))
    one.model.load_state_dict(trainer.model.state_dict())
    flat = trainer.layout.ravel([p.detach() for p in trainer.layout.params])
    return {"params": flat, "losses": losses, "metrics": metrics,
            "p1_metrics": one.test(), "val_batches_made": len(made)}


def small_ptb_steps_and_test(device, cfg_kwargs, steps):
    """The PTB LSTM at hidden 64 (the zoo's entry replaced in this rank
    process only): `steps` trainer steps at P ranks, then ``test()``; also
    the ``test()`` of a P = 1 trainer holding the same weights. This
    rank's global index set of each step, its final carry, flat
    parameters, losses and both metrics."""
    models._ZOO["lstm"] = dataclasses.replace(
        models._ZOO["lstm"],
        build=functools.partial(models.PTBLSTM, hidden_size=64))
    trainer = Trainer(TrainConfig(device=str(device), **cfg_kwargs))
    gidx, losses = [], []
    for _ in range(steps):
        losses.append(trainer.train(1)["loss"])
        gidx.append(trainer.optimizer.last_global[1].clone())
    metrics = trainer.test()
    one = Trainer(TrainConfig(device=str(device),
                              **{**cfg_kwargs, "nworkers": 1}))
    one.model.load_state_dict(trainer.model.state_dict())
    flat = trainer.layout.ravel([p.detach() for p in trainer.layout.params])
    return {"gidx": gidx, "carry": trainer.carry, "params": flat,
            "losses": losses, "metrics": metrics, "p1_metrics": one.test()}
