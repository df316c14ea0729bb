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
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_the_reference_imports_nothing_of_the_program():
    """The reference, the model kinds and the frozen arithmetic they
    use import plain PyTorch and NumPy and the harness's own plain
    modules, nothing of the port."""
    plain = ("portbench.reference", "portbench.kinds", "portbench.spec",
             "portbench.yardstick")
    files = [os.path.join(spec.HERE, "spec.py"),
             os.path.join(spec.HERE, "yardstick.py")]
    for sub in ("reference", "kinds"):
        d = os.path.join(spec.HERE, sub)
        files += [os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in ("__future__", "math", "typing", "types", "re",
                           "os", "json", "importlib", "numpy", "torch",
                           "portbench"), (path, mod)
            if top == "portbench":
                assert mod.startswith(plain), (path, mod)
