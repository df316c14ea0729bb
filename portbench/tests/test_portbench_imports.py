"""Nothing the harness runs loads JAX or the JAX package: top-level module
names compared whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench import rank, spec


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gtopkssgd_tpu_torch_fake", object())
    assert "gtopkssgd_tpu" not in rank.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gtopkssgd_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "benchmarks", object())
    found = rank.forbidden_modules()
    assert "gtopkssgd_tpu" in found and "benchmarks" in found


def test_the_harness_loads_none_of_them():
    metrics = [m["name"] for m in spec.benchmark()["per_layer"]]
    code = ("import sys; import portbench.run, portbench.readings, "
            "portbench.faults; import gtopkssgd_tpu_torch.trainer; "
            + "".join(f"import portbench.metrics.{m}; " for m in metrics)
            + "from portbench.rank import forbidden_modules; "
              "print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                top = mod.split(".")[0]
                assert top in ("__future__", "math", "typing", "numpy",
                               "torch", "portbench"), (f, mod)
                if top == "portbench":
                    assert mod.startswith("portbench.reference"), (f, mod)
