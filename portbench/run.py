"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``, from the process's start to the window's opening):
the cell's files, the seeded batch pool, the port's ``Trainer`` from a
``TrainConfig`` of the cell's settings (its weights from the seed through
its own ``reset_parameters``), its first three steps, which ``correct``
judges, and a warm-up of the cell's own shapes. At P > 1,
``parallel.dist.spawn`` starts one rank a card over NCCL. The window
calls ``Trainer.train(1)`` for the step count the warm-up's rate gives
``--seconds``. ``--trace 1`` profiles a short stretch in the middle of
the window and reports the per-layer metrics; ``--trace 0`` the
end-to-end ones. After the window the program's state is freed and the
plain reference follows the same three steps (``portbench.check``).

The last line of standard output is one JSON object; the numbers
compared for ``correct`` are the last lines of standard error and the
result's last key, ``checks``. A run that finds fewer cards than the cell
asks for, or JAX or the JAX package loaded, exits non-zero and prints no
result.
"""

from __future__ import annotations

import os
import sys
import time

_STARTED = time.time()
_HERE = os.path.dirname(os.path.abspath(__file__))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(_HERE, ".cache", _sub)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import check, spec  # noqa: E402
from portbench.rank import forbidden_modules, rank_main  # noqa: E402

GIB = float(1 << 30)


def process_start() -> float:
    """This process's start on the wall clock (from /proc where there is
    one, else the module's import)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _STARTED


def power_limit() -> Optional[str]:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = got.stdout.strip().splitlines()
    return lines[0].strip() if got.returncode == 0 and lines else None


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20)[18]


def end_to_end(cell: spec.Cell, ranks: List[Dict]) -> Dict[str, Dict]:
    r0 = ranks[0]
    batch = int(cell.traffic["train_config"]["batch_size"])
    n = len(r0["steps"])
    values = {
        "samples_per_s": (cell.chips * batch * n / r0["window_s"],
                          "samples/s"),
        "step_ms_p95": (1e3 * p95(r0["steps"]), "ms"),
        "peak_mem_gib": (max(r["peak_bytes"] for r in ranks) / GIB, "GiB"),
        "setup_s": (r0["setup_s"], "s"),
    }
    return {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell: spec.Cell, ranks: List[Dict]) -> Dict[str, Dict]:
    """Each per-layer metric, the mean over the ranks that read one; a
    metric no rank reads is left out."""
    out = {}
    for m in cell.per_layer:
        vals = [r["per_layer"][m["name"]] for r in ranks
                if r["per_layer"].get(m["name"]) is not None]
        if vals:
            out[m["name"]] = {"value": sum(vals) / len(vals),
                              "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        root: str) -> List[Dict]:
    start = process_start()
    if cell.chips == 1:
        # One thread of CPU ops, as the port's rank processes run at P > 1.
        torch.set_num_threads(1)
        return [rank_main("cuda:0", cell.name, seed, seconds, traced, start,
                          root)]
    from gtopkssgd_tpu_torch.parallel.dist import spawn

    return spawn(rank_main, cell.chips, cell.name, seed, seconds, traced,
                 start, root, backend="nccl", device="cuda", timeout=900.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec.ROOT
    cell = spec.Cell(args.workload, root)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    ranks = run(cell, args.seed, args.seconds, bool(args.trace), root)
    found = sorted(set(forbidden_modules()).union(
        *[r["forbidden"] for r in ranks]))
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    numbers = {}
    for r in ranks:  # the worst rank counts
        for key, v in r["numbers"].items():
            numbers[key] = max(numbers.get(key, v), v)
    checks = check.verdict(numbers, cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": max(int(r["peak_bytes"]) for r in ranks),
              "power_limit": power_limit()}
    result = {"correct": check.passed(checks),
              "attempted": len(ranks[0]["steps"]), "failed": 0}
    if args.trace:
        result["metrics"] = per_layer(cell, ranks)
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = (sum(r["trace_window_s"] for r in ranks)
                              / len(ranks))
        result["device"] = device
        result["breakdown"] = ranks[0]["breakdown"]
    else:
        result["metrics"] = end_to_end(cell, ranks)
        result["device"] = device
    result["checks"] = checks
    q = statistics.quantiles(ranks[0]["steps"], n=20)
    print("steps n=%d ms min %.3f p25 %.3f p50 %.3f p75 %.3f p95 %.3f max "
          "%.3f" % (len(ranks[0]["steps"]), 1e3 * min(ranks[0]["steps"]),
                    1e3 * q[4], 1e3 * q[9], 1e3 * q[14], 1e3 * q[18],
                    1e3 * max(ranks[0]["steps"])), file=sys.stderr)
    if args.trace:
        print("graph " + json.dumps(ranks[0].get("graph")), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
