"""Process groups and rank processes.

* ``init_process_group(rank, world_size, init_method, backend, device)``
  joins one rank and returns the device it computes on. Under NCCL rank r
  runs on ``cuda:r``, and a world larger than the visible cards is an
  error. Under gloo the ranks run on the CPU, or share the visible cards
  (``cuda:{r % cards}``) when the caller asks for CUDA.
* ``spawn(fn, nworkers, *args, backend=, device=)`` starts ``nworkers``
  rank processes (start method ``spawn``), joins them through a
  ``file://`` rendezvous in a fresh temporary directory, runs
  ``fn(device, *args)`` on each and returns their results in rank order,
  tensors turned into numpy arrays. ``fn`` must be importable without jax.
  A rank that raises or a run that outlasts ``timeout`` fails the call;
  every rank process is stopped before it returns. ``setup`` runs in
  each rank process before it joins the group (a fork there sees none of
  the group's threads) and returns the function run after ``fn``;
  ``forward_signals`` passes a SIGTERM or SIGINT the parent receives on
  to every rank process while they run.
* ``init_from_env(backend, device)`` joins the group of a job launched
  from outside (``--multihost``): rank, world size and local rank from
  ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, the rendezvous from
  ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_method="env://"``), retried
  as the JAX CLI retries its ``jax.distributed.initialize``; the device
  is ``cuda:LOCAL_RANK`` or the CPU.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, world_size: int, backend: str,
                device: str) -> torch.device:
    """The device rank `rank` computes on (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    kind = torch.device(device).type
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError(f"backend nccl needs CUDA tensors, not {device}")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl with {world_size} ranks needs {world_size} cards, "
                f"{cards} visible; ask for gloo to share them")
        return torch.device("cuda", rank)
    if kind == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_process_group(rank: int, world_size: int, init_method: str,
                       backend: str, device: str) -> torch.device:
    """Join the default process group as `rank` and return its device.
    One all-reduce warms the group up, so every rank has joined its
    communicator before the first point-to-point round (which involves
    only some ranks)."""
    dev = rank_device(rank, world_size, backend, device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _warm_up(dev, backend, world_size)
    return dev


def _warm_up(dev: torch.device, backend: str, world_size: int) -> None:
    probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if float(probe) != world_size:
        raise RuntimeError(f"warm-up all-reduce gave {float(probe)}")


ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_from_env(backend: str, device: str, retries: int = 3,
                  delay: float = 2.0, logger=None
                  ) -> Tuple[int, int, torch.device]:
    """Join the default process group of an externally launched job as
    the environment says (module docstring); (rank, world size,
    device). One thread, as a spawned rank computes."""
    from gtopkssgd_tpu_torch.resilience.preempt import retry_call

    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise ValueError(f"--multihost needs {', '.join(ENV_VARS)} in the "
                         f"environment; missing {', '.join(missing)}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    torch.set_num_threads(1)
    kw = {}
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    elif backend == "nccl":
        raise ValueError(f"backend nccl needs CUDA tensors, not {device}")
    else:
        dev = torch.device("cpu")
    retry_call(lambda: dist.init_process_group(
        backend, init_method="env://", world_size=world, rank=rank, **kw),
        retries=retries, delay=delay, logger=logger,
        desc="torch.distributed.init_process_group")
    _warm_up(dev, backend, world)
    return rank, world, dev


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn: Callable, rank: int, world_size: int, init_method: str,
               backend: str, device: str, args: tuple, results,
               setup: Optional[Callable]) -> None:
    torch.set_num_threads(1)
    try:
        teardown = setup() if setup is not None else None
        try:
            dev = init_process_group(rank, world_size, init_method, backend,
                                     device)
            try:
                out = fn(dev, *args)
            finally:
                dist.destroy_process_group()
        finally:
            if teardown is not None:
                teardown()
        results.put((rank, True, _to_host(out)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def _forward(procs, signals) -> dict:
    """Install handlers passing `signals` on to the live `procs`; the old
    handlers, to restore (none off the main thread)."""
    def handler(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    old = {}
    try:
        for sig in signals:
            old[sig] = signal.signal(sig, handler)
    except ValueError:  # not the main thread
        pass
    return old


def spawn(fn: Callable, nworkers: int, *args, backend: str, device: str,
          timeout: float = 600.0, setup: Optional[Callable] = None,
          forward_signals: bool = False) -> List[Any]:
    """``fn(device, *args)`` on each of `nworkers` rank processes; the
    results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="gtopk-rendezvous-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, nworkers, init_method, backend, device, args,
            results, setup)) for rank in range(nworkers)]
        for p in procs:
            p.start()
        old = (_forward(procs, (signal.SIGTERM, signal.SIGINT))
               if forward_signals else {})
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < nworkers:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{nworkers} ranks: {nworkers - len(out)} gave "
                            f"no result in {timeout:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for sig, handler in old.items():
                signal.signal(sig, handler)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(nworkers)]
