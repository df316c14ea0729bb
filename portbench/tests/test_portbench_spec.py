"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of files by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_every_named_file_loads():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cell = spec.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.limits


def test_every_cell_has_its_configuration():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert spec.reader(m["name"]) is not None
        layers.setdefault(m["name"], m["layer"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_a_cell_config_and_metric_are_added_as_files(tmp_path, monkeypatch):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as new files and new entries, are found by name; no file that
    the repository has is edited."""
    root = str(tmp_path)
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(spec.HERE, kind),
                        os.path.join(root, "portbench", kind))
    before = {p: open(os.path.join(root, p)).read() for p in
              ["BENCHMARK.json"] + [os.path.join("portbench", k, f)
                                    for k in ("configs", "traffic",
                                              "workloads")
                                    for f in os.listdir(os.path.join(
                                        root, "portbench", k))]}
    cfg = spec.load_json(os.path.join(root, "portbench", "configs",
                                      "alexnet-imagenet-bf16.json"))
    cfg["name"] = "alexnet-throwaway"
    with open(os.path.join(root, "portbench", "configs",
                           "alexnet-throwaway.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "portbench", "traffic",
                           "throwaway.b64.p1.json"), "w") as fh:
        json.dump({"name": "throwaway.b64.p1", "why": "t",
                   "train_config": {"batch_size": 64,
                                    "compression": "dense"},
                   "pool_batches": 8, "warmup_steps": 40,
                   "capture_seconds": 1.0}, fh)
    with open(os.path.join(root, "portbench", "workloads",
                           "alexnet.throwaway.b64.p1.json"), "w") as fh:
        json.dump({"name": "alexnet.throwaway.b64.p1",
                   "limits": {"loss": 0.01}}, fh)
    metric_dir = tmp_path / "metrics"
    metric_dir.mkdir()
    (metric_dir / "throwaway_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    import portbench.metrics as metrics

    monkeypatch.setattr(metrics, "__path__",
                        list(metrics.__path__) + [str(metric_dir)])
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "alexnet-throwaway", "source": "x",
                             "file": "portbench/configs/"
                                     "alexnet-throwaway.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "alexnet.throwaway.b64.p1",
                               "config": "alexnet-throwaway",
                               "traffic": "throwaway.b64.p1", "chips": 1,
                               "why": "t"})
    bench["per_layer"].append({"name": "throwaway_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "model", "moves": "samples_per_s",
                               "workloads": ["alexnet.throwaway.b64.p1"]})
    # The new entries go into a copy; the copy of the repository's
    # files is compared below.
    new_root = tmp_path / "new"
    shutil.copytree(os.path.join(root, "portbench"),
                    new_root / "portbench")
    (new_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("alexnet.throwaway.b64.p1", str(new_root))
    assert cell.config["name"] == "alexnet-throwaway"
    assert cell.train_config(1, "cpu")["compression"] == "dense"
    assert [m["name"] for m in cell.per_layer] == ["throwaway_ms"]
    assert spec.reader("throwaway_ms")(None) == 1.5
    sys.modules.pop("portbench.metrics.throwaway_ms", None)
    for p, text in before.items():
        assert open(os.path.join(root, p)).read() == text


def test_bad_names_are_refused():
    with pytest.raises(ValueError):
        spec.reader("../run")
    with pytest.raises(ValueError):
        spec._named("configs", "a/b", spec.ROOT)
