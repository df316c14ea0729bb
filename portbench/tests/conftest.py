"""Fixtures of the benchmark's CPU tests: a throwaway checkout root that
holds the repository's ``BENCHMARK.json`` and data files plus tiny cells
(ResNet-50 at 64x64, 4 images, float32, lr 0.01; under gTop-k or the
dense exchange) held to the limits of the real cells; and the ``cuda``
tests' card."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench import spec

TINY_CONFIG = "tiny-resnet"


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_root(root: str, cells) -> str:
    """A checkout root at `root` with the repository's benchmark files
    and, for each (cell name, chips, limits cell[, "dense"]), a tiny cell
    whose limits are those of the named real cell, under gTop-k or, where
    "dense" follows, the dense exchange."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(spec.HERE, kind),
                        os.path.join(root, "portbench", kind))
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    cfg = spec.load_json(os.path.join(
        spec.HERE, "configs", "resnet50-imagenet-bf16.json"))
    cfg.update(name=TINY_CONFIG, image_size=64, dtype="float32", lr=0.01)
    _write(os.path.join(root, "portbench", "configs", TINY_CONFIG + ".json"),
           cfg)
    bench["configs"].append({"name": TINY_CONFIG, "source": cfg["source"],
                             "file": f"portbench/configs/{TINY_CONFIG}.json",
                             "reduced": ["image_size"], "why": "a test"})
    for name, chips, like, *dense in cells:
        traffic = f"tiny-b4-p{chips}"
        train = {"batch_size": 4, "compression": "gtopk", "density": 0.001,
                 "topk_method": "auto", "wire_codec": "fp32",
                 "comm_plan": "auto"}
        if dense:
            traffic = f"tiny-dense-b4-p{chips}"
            train = {"batch_size": 4, "compression": "dense"}
        _write(os.path.join(root, "portbench", "traffic", traffic + ".json"),
               {"name": traffic, "why": "a test", "train_config": train,
                "pool_batches": 4, "warmup_steps": 2,
                "capture_seconds": 0.1})
        limits = spec.load_json(os.path.join(
            spec.HERE, "workloads", like + ".json"))["limits"]
        _write(os.path.join(root, "portbench", "workloads", name + ".json"),
               {"name": name, "limits": limits})
        bench["workloads"].append({"name": name, "config": TINY_CONFIG,
                                   "traffic": traffic, "chips": chips,
                                   "why": "a test"})
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("root")), [
        ("tiny.p1", 1, "resnet50.gtopk.b32.p1"),
        ("tiny.p4", 4, "resnet50.gtopk.b32.p1"),
        ("tiny.dense.p1", 1, "alexnet.dense.b64.p1", "dense"),
        ("tiny.dense.p2", 2, "alexnet.dense.b64.p1", "dense")])


@pytest.fixture
def card():
    """The CUDA card the ``cuda`` tests run on; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
