"""Finding a cell's files, kinds and metrics by the names in
``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json`` (the cell's correctness limits). A
configuration's model kind is the module ``portbench.kinds.<kind>``,
found by its ``arch["kind"]`` (``portbench/kinds/__init__.py`` says what
a kind gives). A per-layer metric is the module
``portbench.metrics.<name>``, whose ``read(ctx)`` returns the metric's
value or None where it finds nothing to read. No list of cells,
configurations, kinds or metrics lives in code.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from types import ModuleType
from typing import Any, Callable, Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z0-9_]+(\.[A-Za-z0-9_]+)*$")


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


def module(package: str, name: str) -> ModuleType:
    """The module ``<package>.<name>``; `name` is a name as
    ``BENCHMARK.json`` allows one, whose dots name subpackages."""
    if not (NAME.match(name) and MODULE.match(name)):
        raise ValueError(f"bad module name {name!r} in {package}")
    return importlib.import_module(f"{package}.{name}")


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
        model and job, with its own ``train_config`` fields (a model's
        sequence length, say), then the traffic's batch and exchange, the
        seed, the device and one rank a chip; the trainer's defaults for
        the rest."""
        c, t = self.config, self.traffic
        kw = dict(dnn=c["dnn"], dataset=c["dataset"], dtype=c["dtype"],
                  lr=c["lr"], momentum=c["momentum"],
                  weight_decay=c["weight_decay"])
        kw.update(c.get("train_config", {}))
        kw.update(t["train_config"])
        kw.update(nworkers=self.chips, seed=seed, device=device)
        return kw


def kind(config: Dict[str, Any]) -> ModuleType:
    """The configuration's model kind, ``portbench.kinds.<arch.kind>``."""
    return module("portbench.kinds", config["arch"]["kind"])


def metric(name: str) -> ModuleType:
    """The per-layer metric's module, ``portbench.metrics.<name>``."""
    return module("portbench.metrics", name)


def reader(name: str) -> Callable[[Any], Optional[float]]:
    """The per-layer metric's reader, ``portbench.metrics.<name>.read``."""
    return metric(name).read
