"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json`` (the cell's correctness limits). A per-layer
metric is the module ``portbench.metrics.<name>``, whose ``read(ctx)``
returns the metric's value or None where it finds nothing to read. No
list of cells, configurations or metrics lives in code.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Any, Callable, Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, root: str) -> Dict[str, Any]:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return load_json(os.path.join(root, "portbench", kind, name + ".json"))


class Cell:
    """One entry of ``workloads`` with its three files, and the metrics
    ``BENCHMARK.json`` has this cell report."""

    def __init__(self, name: str, root: str = ROOT):
        bench = benchmark(root)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = _named("configs", self.entry["config"], root)
        self.traffic = _named("traffic", self.entry["traffic"], root)
        self.limits = _named("workloads", name, root)["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def train_config(self, seed: int, device: str) -> Dict[str, Any]:
        """The ``TrainConfig`` fields of this cell: the configuration's
        model and job, the traffic's batch and exchange, the seed, the
        device and one rank a chip; the trainer's defaults for the
        rest."""
        c, t = self.config, self.traffic
        kw = dict(dnn=c["dnn"], dataset=c["dataset"], dtype=c["dtype"],
                  lr=c["lr"], momentum=c["momentum"],
                  weight_decay=c["weight_decay"])
        kw.update(t["train_config"])
        kw.update(nworkers=self.chips, seed=seed, device=device)
        return kw


def reader(metric: str) -> Callable[[Any], Optional[float]]:
    """The per-layer metric's reader, ``portbench.metrics.<metric>.read``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    return importlib.import_module(f"portbench.metrics.{metric}").read
