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
import torch.nn.functional as F

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


def hier_and_balanced_over_groups(device, psum_cases, hier_cases,
                                  balanced_cases, k, n):
    """The first P ranks of the world, in a group of their own, run
    ``ici_dense_psum`` on each of `psum_cases` ({(P, ici): f32[P, m]}),
    ``ici_dense_psum`` then ``hier_gtopk_allreduce`` on each of
    `hier_cases` ({(P, ici, codec): (vals f32[P, k], idx i32[P, k])}) and
    ``balanced_gtopk_allreduce`` on each of `balanced_cases` ({(P,
    codec): (vals, idx)}); this rank's results and wire counters by
    case."""
    rank = dist.get_rank()
    ps = {key[0] for cases in (psum_cases, hier_cases, balanced_cases)
          for key in cases}
    groups = {p: dist.new_group(list(range(p)))  # every rank calls it
              for p in sorted(ps)}
    out = {}

    def row(x):
        return torch.from_numpy(x[rank]).to(device)

    for (p, ici), x in sorted(psum_cases.items()):
        if rank < p:
            collectives.reset_wire()
            got = collectives.ici_dense_psum(row(x), ici_size=ici,
                                             group=groups[p])
            out[("psum", p, ici)] = {"sum": got, **collectives.wire}
    for (p, ici, codec), (vals, idx) in sorted(hier_cases.items()):
        if rank < p:
            collectives.reset_wire()
            gv, gi = collectives.hier_gtopk_allreduce(
                row(vals), row(idx), k=k, n=n, ici_size=ici,
                group=groups[p], codec=codec)
            out[("hier", p, ici, codec)] = {"vals": gv, "idx": gi,
                                            **collectives.wire}
    for (p, codec), (vals, idx) in sorted(balanced_cases.items()):
        if rank < p:
            collectives.reset_wire()
            gv, gi = collectives.balanced_gtopk_allreduce(
                row(vals), row(idx), k=k, n=n, group=groups[p],
                codec=codec)
            out[("balanced", p, codec)] = {"vals": gv, "idx": gi,
                                           **collectives.wire}
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


def _cpu(x):
    """Tensors, sets and lists of sets, cloned (the optimizer reuses
    nothing, but the caller keeps them past the next step)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {key: _cpu(v) for key, v in x.items()}
    return type(x)(_cpu(v) for v in x)


def leaf_optimizer_steps(device, leaves0, grads, opt_kwargs):
    """``GTopKSGD`` over the whole world on one parameter a leaf (from
    `leaves0`, in layout order), one step per entry of `grads` (a list of
    f32[P, n_l] a leaf, row = rank); after each step the flat parameters,
    the residual, the local and global sets (a list of one a bucket
    under a bucketed gtopk_layerwise), the gradient bytes this rank has
    shipped since the first step, and whether the optimizer ran a merge
    thread (the ``overlap`` order's)."""
    rank = dist.get_rank()
    params = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(device))
              for x in leaves0]
    opt = GTopKSGD(params, process_group=dist.group.WORLD, **opt_kwargs)
    collectives.reset_wire()
    out = []
    for step_grads in grads:
        for prm, g in zip(params, step_grads):
            prm.grad = torch.from_numpy(g[rank].copy()).to(device)
        opt.step()
        out.append({"params": torch.cat([prm.detach().reshape(-1)
                                         for prm in params]),
                    "residual": _cpu(opt.state["residual"]),
                    "local": _cpu(opt.last_local),
                    "global": _cpu(opt.last_global),
                    "plan": None if opt.plan is None else opt.plan.name,
                    "wire": collectives.wire["bytes"],
                    "merge_thread": opt._pool is not None})
    opt.close()
    return out


def leaf_optimizer_cases(device, leaves0, grads, cases):
    """``leaf_optimizer_steps`` for each {name: opt_kwargs} of `cases`, in
    one world; the results by name."""
    return {name: leaf_optimizer_steps(device, leaves0, grads, kw)
            for name, kw in cases.items()}


def trainer_steps_from_states(device, cfg_kwargs, states):
    """One trainer step from each of `states` (``load_jax_state``'s
    arguments); after each step the loss, this rank's residual, the global
    index set (a list of one a bucket under a bucketed gtopk_layerwise)
    and the BatchNorm buffers."""
    trainer = Trainer(TrainConfig(device=str(device), **cfg_kwargs))
    opt = trainer.optimizer
    out = []
    for state in states:
        load_jax_state(trainer, **state)
        loss = trainer.train(1)["loss"]
        sets = opt.last_global
        out.append({"loss": loss, "residual": opt.state["residual"].clone(),
                    "gidx": (sets[1] if isinstance(sets, tuple)
                             else [gidx for _, gidx in sets]),
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


def bench_gradients(device, cfg, mode, density):
    """The benchmark harness's fixed batch on this rank and the gradient
    one forward and backward gives it, flat."""
    from gtopkssgd_tpu_torch import benchmark

    bench = benchmark._Bench(cfg, mode, density, device, dist.group.WORLD)
    try:
        bench.forward_backward()
        grad = bench.layout.ravel([q.grad for q in bench.layout.params])
        return {"x": bench.x.clone(), "y": bench.y.clone(),
                "grad": grad.detach().clone()}
    finally:
        bench.close()


def _state_cpu(trainer):
    return {name: t.detach().cpu().clone()
            for name, t in trainer.checkpoint_state().items()}


def resume_run(device, cfg_kwargs, out_dir, total, split, other_p_dir=None):
    """Rank program (and the P = 1 body of the lifecycle tests): `total`
    steps of one trainer, then the same run split at step `split`:
    `split` steps, ``save()`` into `out_dir`, a new trainer with
    ``resume=True``, the remaining steps. Returns both runs' final
    ``checkpoint_state`` (on the CPU), the resumed trainer's step and
    losses, and, given `other_p_dir` (a checkpoint saved at another P),
    the error a resume from it raises."""
    cfg = dict(cfg_kwargs, device=str(device))
    with Trainer(TrainConfig(**cfg)) as full:
        full_losses = full.train(total)["losses"]
        full_state = _state_cpu(full)
    with Trainer(TrainConfig(out_dir=out_dir, **cfg)) as first:
        first_losses = first.train(split)["losses"]
        first.save()
    with Trainer(TrainConfig(out_dir=out_dir, resume=True, **cfg)) as again:
        restored_step = again.step
        rest = again.train(total - split)["losses"]
        out = {"full": full_state, "resumed": _state_cpu(again),
               "restored_step": restored_step, "step": again.step,
               "full_losses": full_losses,
               "resumed_losses": first_losses + rest}
    if other_p_dir is not None:
        try:
            Trainer(TrainConfig(out_dir=other_p_dir, resume=True, **cfg))
            out["other_p_error"] = None
        except ValueError as e:
            out["other_p_error"] = str(e)
    return out


def dispatch_runs(device, cfg_kwargs, steps, ks):
    """Rank program: `steps` steps of a fresh trainer at each
    ``steps_per_dispatch`` of `ks`; each run's losses, dispatch and final
    ``checkpoint_state`` (on the CPU), by K."""
    out = {}
    for k in ks:
        with Trainer(TrainConfig(device=str(device), steps_per_dispatch=k,
                                 **cfg_kwargs)) as t:
            stats = t.train(steps)
            out[k] = {"losses": stats["losses"], "dispatch": t.dispatch,
                      "state": _state_cpu(t)}
    return out


def elastic_restore(device, cfg_kwargs, out_dir):
    """Rank program: a trainer restoring `out_dir`'s newest checkpoint
    under ``elastic`` (saved at another P); this rank's step, restored
    world size and residual buffers (on the CPU)."""
    with Trainer(TrainConfig(device=str(device), out_dir=out_dir,
                             resume=True, elastic=True,
                             **cfg_kwargs)) as t:
        res = t.optimizer.state["residual"]
        res = res if isinstance(res, dict) else {"residual": res}
        return {"rank": t.rank, "step": t.step,
                "world": t._ckpt.last_restored_world,
                "residual": {k: v.detach().cpu() for k, v in res.items()},
                "manifest": dict(t.manifest)}


def telemetry_cases(device, leaves0, grads, cases):
    """For each {name: opt_kwargs} of `cases`, ``GTopKSGD`` with the
    counters on over the whole world on the 1-D parameters `leaves0` (one
    leaf each), one step per entry of `grads` (a list of f32[P, n_l] a
    leaf, row = rank); after each step this rank's telemetry vector and
    residual age (None without layers), by name."""
    rank = dist.get_rank()
    out = {}
    for name, kw in cases.items():
        params = [torch.nn.Parameter(torch.from_numpy(x.copy()).to(device))
                  for x in leaves0]
        opt = GTopKSGD(params, process_group=dist.group.WORLD, **kw)
        steps = []
        for g in grads:
            for p, gl in zip(params, g):
                p.grad = torch.from_numpy(gl[rank].copy()).to(device)
            opt.step()
            age = opt.state.get("age")
            steps.append({"telemetry": opt.state["telemetry"].clone(),
                          "age": None if age is None else age.clone()})
        out[name] = {"fields": opt.telemetry_fields, "steps": steps}
        opt.close()
    return out


def skip_runs(device, cfg_kwargs, chaos_kwargs):
    """One step of a trainer from `cfg_kwargs`, then two of one with
    `chaos_kwargs` added (an injected NaN at step 2 claimed by a skip
    policy, a metrics exporter); each's final ``checkpoint_state`` (on
    the CPU), the second's step, recoveries and exporter port."""
    cfg = dict(cfg_kwargs, device=str(device))
    with Trainer(TrainConfig(**cfg)) as clean:
        clean.train(1)
        clean_state = _state_cpu(clean)
    with Trainer(TrainConfig(**cfg, **chaos_kwargs)) as chaos:
        chaos.train(2)
        return {"clean": clean_state, "chaos": _state_cpu(chaos),
                "step": chaos.step,
                "recoveries": chaos.recovery.n_recoveries,
                "port": chaos.exporter.port}


def trace_plane_run(device, cfg_kwargs, out_dir, steps):
    """`steps` steps of a trainer from `cfg_kwargs` with its metrics in
    `out_dir` (the trace planes profile its dispatches); this rank's
    records and the calibrator's samples (wire bytes, comm ms)."""
    import json
    import os

    cfg = dict(cfg_kwargs, device=str(device), out_dir=out_dir)
    with Trainer(TrainConfig(**cfg)) as t:
        t.train(steps)
        samples = [(b, ms) for _, b, ms in t.calib.samples]
    name = f"metrics.rank{dist.get_rank()}.jsonl"
    with open(os.path.join(out_dir, name)) as fh:
        records = [json.loads(line) for line in fh]
    return {"records": records, "samples": samples}


def eviction_run(device, cfg_kwargs, num_iters):
    """Rank program: ``dist_trainer.run`` of `cfg_kwargs` (an elastic run
    whose rank 0 may evict a rank) for `num_iters` steps; this rank's
    exit code and step, and the "resize" records of its shard."""
    import json
    import os

    from gtopkssgd_tpu_torch import dist_trainer

    cfg = TrainConfig(**dict(cfg_kwargs, device=str(device)))
    out = dist_trainer.run(cfg, num_iters)
    name = f"metrics.rank{dist.get_rank()}.jsonl"
    with open(os.path.join(cfg.out_dir, name)) as fh:
        records = [json.loads(line) for line in fh]
    return {"rc": out["rc"], "step": out["step"], "rank": dist.get_rank(),
            "records": records}


def convergence_arms(device, state, x, y, arms):
    """The convergence gate's problem on this rank, for each {name:
    (TrainConfig kwargs, steps)} of `arms`, one after another in one
    world: a ResNet-20 trainer loaded with `state` (flax's params and
    batch_stats as numpy trees, through ``load_jax_state``; no momentum,
    a zero residual) trains free on row `rank` of the fixed batch (x
    f32[P, B, 32, 32, 3], y i32[P, B]), as the reference's gate does: the
    mean cross-entropy of the train-mode forward, backward, the
    optimizer's step, then one all-reduce averages the BatchNorm
    statistics and the loss over the ranks. The losses by arm name, each
    the mean over the ranks at that step."""
    rank, p = dist.get_rank(), dist.get_world_size()
    xb = torch.from_numpy(x[rank]).to(device)
    yb = torch.from_numpy(y[rank]).long().to(device)
    out = {}
    for name, (cfg_kwargs, steps) in arms.items():
        cfg = TrainConfig(dnn="resnet20", device=str(device), nworkers=p,
                          prefetch=0, obs_counters=False, obs_goodput=False,
                          **cfg_kwargs)
        with Trainer(cfg) as t:
            opt = t.optimizer
            load_jax_state(t, **state, momentum=None,
                           residual=opt.state["residual"].cpu().numpy(),
                           count=0)
            losses = []
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = F.cross_entropy(t.model(xb), yb)
                loss.backward()
                opt.step()
                mean, = t._average_over_ranks([loss.detach()])
                losses.append(float(mean))
        out[name] = losses
    return out
