"""What the observability costs a training step on the card.

    python -m gtopkssgd_tpu_torch.obs_probe [--steps 40] [--out PATH]

For ResNet-20 (synthetic CIFAR-10) and ResNet-50 (synthetic ImageNet),
gTop-k ``twostage`` at density 0.001, batch 32, P = 1, float32 with TF32
off: the median host-clock step ms (every dispatch ends in a device sync;
a step of a K-step dispatch is given 1/K of it) with the on-device
counters on (the default, an "obs" read every step) and off
(``--no-obs-counters``), eager (K = 1) and replayed from a CUDA graph (K =
8), measured in turns on, off, off, on, on, off on one trainer a (model,
K): the optimizer's ``telemetry`` switched, the graph captured anew at
each switch (the host's step times wander by tens of percent from one
window to the next, hence three of each). On the ResNet-50 eager trainer,
the device ms of the optimizer's compression (``GTopKSGD.compress`` on
the step's flat gradient: the selection, the residual and, when on, the
counters) with the counters off and on, in the same turns. Then a
ResNet-50 trainer with ``--obs-layers``: its step, its compression's
device ms, the recall audit's device ms (``obs.counters``'s exact top-k
of the accumulator and the recall) and the snapshot a
``--recover-policy`` run takes before each dispatch
(``Trainer._snapshot``: device ms, and host ms by the clock). Device ms
are CUDA events around the call with the card kept busy ahead of it,
median of REPS. One JSON line a measurement, after the card's name and
power limit (``nvidia-smi``); ``--out`` also writes them as one JSON
list. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List

import torch

REPS = 10
MODELS = ("resnet20", "resnet50")
GRAPH_K = 8
ORDER = (True, False, False, True, True, False)  # counters on / off


def _trainer(dnn: str, k: int, **kw):
    from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

    return Trainer(TrainConfig(
        dnn=dnn, batch_size=32, compression="gtopk", density=0.001,
        topk_method="twostage", steps_per_dispatch=k, log_interval=10**9,
        eval_batches=1, device="cuda", **kw))


def _switch(trainer, on: bool) -> None:
    """Counters on or off in the optimizer's step (and the trainer's
    read); a captured graph holds the old step, so it goes."""
    trainer.optimizer.telemetry = on
    if trainer._graph:
        trainer._reset_graphs()


def _median_step_ms(trainer, steps: int) -> float:
    trainer.train(2 * trainer.cfg.steps_per_dispatch)  # warm, capture
    return 1e3 * statistics.median(trainer.train(steps)["step_times"])


def _device_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compress_ms(opt) -> float:
    """Device ms of one compression of the last step's flat gradient."""
    return _device_ms(lambda: opt.compress(opt.flat_grad.clone()))


def measure(steps: int) -> List[Dict[str, object]]:
    from gtopkssgd_tpu_torch.obs import counters

    out: List[Dict[str, object]] = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        out.append(rec)

    for dnn in MODELS:
        for k in (1, GRAPH_K):
            with _trainer(dnn, k) as t:
                ms = {True: [], False: []}
                for on in ORDER:
                    _switch(t, on)
                    ms[on].append(_median_step_ms(t, steps))
                emit({"what": "step_ms", "dnn": dnn, "k": k,
                      "dispatch": t.dispatch, "on": ms[True],
                      "off": ms[False]})
                if dnn == "resnet50" and k == 1:
                    dev = {True: [], False: []}
                    for on in ORDER:
                        t.optimizer.telemetry = on
                        dev[on].append(_compress_ms(t.optimizer))
                    emit({"what": "compress_device_ms", "dnn": dnn,
                          "on": dev[True], "off": dev[False]})
    with _trainer("resnet50", 1, obs_layers=True) as t:
        step = [_median_step_ms(t, steps) for _ in range(2)]
        opt = t.optimizer
        emit({"what": "layers", "dnn": "resnet50",
              "layers": len(t.layer_names), "step_ms": step,
              "compress_device_ms": [_compress_ms(opt) for _ in range(3)]})
        acc = opt.flat_grad + opt.state["residual"]
        k = opt.compressor.k(acc.shape[0])
        keep = opt.last_keep
        audit = _device_ms(lambda: counters.topk_recall(
            *counters.exact_recall(acc, k, keep)))
        host = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._snapshot()
            host.append(1e3 * (time.perf_counter() - t0))
        emit({"what": "audit_and_snapshot", "dnn": "resnet50",
              "n": acc.shape[0], "k": k, "audit_device_ms": audit,
              "snapshot_device_ms": _device_ms(t._snapshot),
              "snapshot_host_ms": statistics.median(host),
              "snapshot_bytes": sum(x.numel() * x.element_size()
                                    for x in t._snap_bufs)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40,
                    help="timed steps a measurement (a multiple of 8)")
    ap.add_argument("--out", default=None, help="also write the list here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("obs_probe: needs a CUDA card", file=sys.stderr)
        return 2
    if args.steps % GRAPH_K:
        ap.error(f"--steps must be a multiple of {GRAPH_K}")
    from gtopkssgd_tpu_torch.utils.manifest import card_identity

    print(card_identity(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = measure(args.steps)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
