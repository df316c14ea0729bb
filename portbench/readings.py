"""The readings a cell's correctness limits are set from, on the card at
the cell's own size:

* ``--seeds``: sound runs of the program (its first three steps, no
  window) against the reference: the lower readings;
* ``--control-seeds``: the precision control, the reference with its
  operands rounded to fp8 put in the program's place, against the
  float32 reference: the upper readings;
* ``--faults`` on ``--fault-seeds``: the program with a fault of
  ``portbench.faults`` planted under it.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --faults frozen,half_batch \\
        --fault-seeds 7,8,9 [--out readings.jsonl]

One JSON line a reading on standard output (and appended to ``--out``):
{"cell", "kind": "program" | "control" | <fault>, "seed", "numbers"},
the numbers the worst rank's. At P > 1 the ranks run in one spawn.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from portbench import check, spec
from portbench.rank import CHECK_STEPS, _pool, rank_main
from portbench.reference.run import reference_steps


def control_numbers(cell: spec.Cell, seed: int, rank: int,
                    dev) -> Dict[str, float]:
    batches = [_pool(cell, seed, r)[:CHECK_STEPS] for r in range(cell.chips)]
    runs = {p: reference_steps(cell.config, cell.traffic, seed, cell.chips,
                               batches, CHECK_STEPS, dev, precision=p)
            for p in ("float32", "fp8")}
    ctl = runs["fp8"]
    cand = SimpleNamespace(leaves=ctl["leaves"], losses=ctl["losses"],
                           h1=ctl["h1"][rank], keep1=ctl["keep1"][rank],
                           p0=ctl["p0"], p3=ctl["p3"])
    return check.compare(cand, runs["float32"], rank, dev)


def readings_rank(device, cell_name: str, seeds: List[int],
                  control_seeds: List[int], fault_list: List[str],
                  fault_seeds: List[int], root: str) -> List[Dict]:
    import torch.distributed as dist

    cell = spec.Cell(cell_name, root)
    rank = dist.get_rank() if cell.chips > 1 else 0
    out = []
    plan = ([("program", s) for s in seeds]
            + [("control", s) for s in control_seeds]
            + [(f, s) for f in fault_list for s in fault_seeds])
    for kind, seed in plan:
        t0 = time.perf_counter()
        if kind == "control":
            numbers = control_numbers(cell, seed, rank, torch.device(device))
        else:
            got = rank_main(device, cell_name, seed, 0.0, False,
                            time.time(), root,
                            fault=None if kind == "program" else kind,
                            window=False)
            numbers, detail = got["numbers"], got["detail"]
        out.append({"cell": cell_name, "kind": kind, "seed": seed,
                    "rank": rank, "numbers": numbers,
                    "seconds": time.perf_counter() - t0})
        if kind != "control":
            out[-1]["detail"] = detail
        if rank == 0:
            print(json.dumps(out[-1]), flush=True)
    return out


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = spec.ROOT
    cell = spec.Cell(args.workload, root)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.readings: no CUDA device")
    job = (args.workload, _ints(args.seeds), _ints(args.control_seeds),
           [f for f in args.faults.split(",") if f],
           _ints(args.fault_seeds), root)
    if cell.chips == 1:
        ranks = [readings_rank("cuda:0", *job)]
    else:
        from gtopkssgd_tpu_torch.parallel.dist import spawn

        ranks = spawn(readings_rank, cell.chips, *job, backend="nccl",
                      device="cuda", timeout=3000.0)
    rows = []
    for i, first in enumerate(ranks[0]):
        worst = {}
        for r in ranks:
            for key, v in r[i]["numbers"].items():
                worst[key] = max(worst.get(key, v), v)
        rows.append(dict(first, rank="worst", numbers=worst))
    if args.out:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    for row in rows:
        print("worst " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
