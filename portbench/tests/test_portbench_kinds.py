"""Model kinds found by name: the two image kinds give the readings the
harness gave before it had kinds (pinned, bit for bit on the CPU), and a
kind with token batches and a 3-D leaf runs through the harness as new
files alone."""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from portbench import rank, spec, yardstick
from portbench.reference import models
from portbench.reference.run import reference_steps

# Read from the harness before model kinds existed (ResNet and AlexNet
# inside ``reference/models.py``, the image pool in ``source.py``, the
# counts in ``yardstick.py``), with PyTorch's CPU kernels on one thread.
POOL_SHA = {
    "resnet50-imagenet-bf16":
        "1a52b1cb4ddd9f12f84b076fecea3fa2ca9c23c4ab8cf82b72c3d12ebf651cfa",
    "alexnet-imagenet-bf16":
        "1a52b1cb4ddd9f12f84b076fecea3fa2ca9c23c4ab8cf82b72c3d12ebf651cfa",
    "tiny.p1":
        "17442b214ee8d0b1fd33b4e7b31062a10604384d44d2e5bb41bfa0c88867f56b",
}
MACS = {"resnet50-imagenet-bf16": 4089184256,
        "alexnet-imagenet-bf16": 714188480}
SEED = 2 ** 31 + 9
STEPS = {
    "resnet": ([6.829838275909424, 6.965121269226074, 7.123700141906738],
               "182d0b2c56445b7f65f17ce1adafd4dcbece2f76df94afdbf0eb75de31f577a6",
               25558),
    "alexnet": ([6.859930038452148, 6.887368679046631, 8.863655090332031],
                "5ac9a23eb06ece2a7588c81e5a2671915e0aa1d959fa0d2e6b808a5625002f6d",
                24401),
}


def _digest(pool) -> str:
    h = hashlib.sha256()
    for b in pool:
        for key in sorted(b):
            h.update(key.encode())
            h.update(np.ascontiguousarray(b[key]).tobytes())
    return h.hexdigest()


def _config(name):
    return spec.load_json(f"{spec.HERE}/configs/{name}.json")


@pytest.mark.parametrize("name", sorted(MACS))
def test_pool_and_count_are_the_parents(name):
    cfg = _config(name)
    assert _digest(spec.kind(cfg).pool(cfg, 2 ** 31 + 77, 1, 2, 3)) == \
        POOL_SHA[name]
    assert yardstick.forward_macs(cfg) == MACS[name]
    assert yardstick.step_flops(cfg, 64) == 6.0 * MACS[name] * 64


def test_the_cells_pool_is_the_parents(tiny_root):
    cell = spec.Cell("tiny.p1", tiny_root)
    pool = rank._pool(cell, SEED, 0)
    assert _digest(pool) == POOL_SHA["tiny.p1"]
    assert [sorted(b) for b in pool] == [["image", "label"]] * 4


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_reference_steps_are_the_parents_bit_for_bit(tiny_root, one_thread,
                                                     kind):
    """The tiny configuration's three reference steps (ResNet-50 as the
    tiny cells run it; AlexNet at 64x64), losses and parameters."""
    cell = spec.Cell("tiny.p1", tiny_root)
    if kind == "resnet":
        cfg, batches = cell.config, [rank._pool(cell, SEED, 0)[:3]]
    else:
        cfg = dict(_config("alexnet-imagenet-bf16"), image_size=64,
                   dtype="float32")
        batches = [spec.kind(cfg).pool(cfg, SEED, 0, 3, 4)]
    ref = reference_steps(cfg, cell.traffic, SEED, 1, batches, 3,
                          torch.device("cpu"))
    losses, p3_sha, k = STEPS[kind]
    assert ref["losses"] == losses
    assert hashlib.sha256(ref["p3"].numpy().tobytes()).hexdigest() == p3_sha
    assert ref["k"] == k


TOY_KIND = '''
"""A toy language model: token embedding, a mixture of experts held as
one 3-D kernel (expert, out, in), an output head; next-token loss."""
import numpy as np
import torch
import torch.nn.functional as F


def pool(config, seed, rank, count, batch):
    a = config["arch"]
    rng = np.random.default_rng([int(seed), int(rank), 7])
    toks = rng.integers(0, a["vocab"], (count, batch, a["seq_len"] + 1))
    return [{"tokens": t[:, :-1].astype(np.int64),
             "targets": t[:, 1:].astype(np.int64)} for t in toks]


def init(config, seed):
    a = config["arch"]
    g = torch.Generator().manual_seed(int(seed))
    v, d, e = a["vocab"], a["width"], a["experts"]
    return {("Embed_0", "embedding"): torch.randn(v, d, generator=g),
            ("Router_0", "kernel"): torch.randn(e, d, generator=g) / d,
            ("Experts_0", "kernel"): torch.randn(e, d, d, generator=g)
            / d ** 0.5,
            ("Head_0", "kernel"): torch.randn(v, d, generator=g) / d ** 0.5}


def loss(config, params, batch, quant, gen):
    x = params[("Embed_0", "embedding")][batch["tokens"]]
    gate = torch.softmax(F.linear(x, params[("Router_0", "kernel")]), -1)
    w = params[("Experts_0", "kernel")]
    h = sum(gate[..., i:i + 1] * F.linear(quant(x), quant(w[i]))
            for i in range(w.shape[0]))
    logits = F.linear(quant(torch.relu(h)), quant(params[("Head_0",
                                                          "kernel")]))
    return F.cross_entropy(logits.flatten(0, 1), batch["targets"].flatten())


def forward_macs(config):
    a = config["arch"]
    d, e = a["width"], a["experts"]
    return a["seq_len"] * (e * d + e * d * d + a["vocab"] * d)


def flat_perm(path, dims):
    if path[-1] == "embedding":
        return (0, 1)
    if dims == 3:
        return (0, 2, 1)
    return tuple(reversed(range(dims)))
'''

TOY_METRIC = '''
"""experts_ms: device ms a step in the program's "experts" range."""
from portbench.metrics._common import device_ms

RANGES = ("experts",)


def read(ctx):
    return device_ms(ctx, "experts")
'''


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A checkout root with a toy token kind, its configuration, two
    traffic mixes and cells, and a metric that declares a range, added
    as new files and entries; the kind and the metric are found on an
    extra path of their packages."""
    import portbench.kinds as kinds
    import portbench.metrics as metrics

    root = tmp_path / "root"
    shutil.copytree(os.path.join(spec.HERE), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    bench = spec.benchmark()
    code = tmp_path / "code"
    (code / "kinds").mkdir(parents=True)
    (code / "metrics").mkdir()
    (code / "kinds" / "toytokens.py").write_text(TOY_KIND)
    (code / "metrics" / "experts_ms.py").write_text(TOY_METRIC)
    monkeypatch.setattr(kinds, "__path__",
                        list(kinds.__path__) + [str(code / "kinds")])
    monkeypatch.setattr(metrics, "__path__",
                        list(metrics.__path__) + [str(code / "metrics")])
    cfg = {"name": "toy-lm", "dnn": "toylm", "dataset": "toy",
           "arch": {"kind": "toytokens", "vocab": 40, "width": 12,
                    "experts": 3, "seq_len": 6},
           "num_params": 40 * 12 * 2 + 3 * 12 + 3 * 144,
           "epoch_samples": 1000, "dtype": "float32", "lr": 0.1,
           "momentum": 0.9, "weight_decay": 0.0001,
           "train_config": {"batch_size": 1, "seq_len": 6}}
    files = {"configs/toy-lm.json": cfg}
    bench["configs"].append({"name": "toy-lm", "source": "a test",
                             "file": "portbench/configs/toy-lm.json",
                             "reduced": [], "why": "a test"})
    for mode in ("gtopk", "dense"):
        train = {"batch_size": 4, "compression": mode}
        if mode == "gtopk":
            train["density"] = 0.01
        files[f"traffic/toy.{mode}.json"] = {
            "name": f"toy.{mode}", "why": "a test", "train_config": train,
            "pool_batches": 3, "warmup_steps": 2, "capture_seconds": 0.1}
        files[f"workloads/toy.{mode}.p1.json"] = {
            "name": f"toy.{mode}.p1", "limits": {"loss": 0.01}}
        bench["workloads"].append({"name": f"toy.{mode}.p1",
                                   "config": "toy-lm",
                                   "traffic": f"toy.{mode}", "chips": 1,
                                   "why": "a test"})
    bench["per_layer"].append({"name": "experts_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "experts", "moves": "samples_per_s",
                               "workloads": ["toy.gtopk.p1"]})
    for rel, obj in files.items():
        (root / "portbench" / rel).write_text(json.dumps(obj))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    yield str(root)
    for name in ("portbench.kinds.toytokens", "portbench.metrics.experts_ms"):
        sys.modules.pop(name, None)


@pytest.mark.parametrize("mode", ["gtopk", "dense"])
def test_a_token_kind_runs_as_new_files(toy_root, mode):
    before = {p: open(os.path.join(spec.HERE, p)).read()
              for p in ("spec.py", "rank.py", "yardstick.py", "trace.py",
                        "reference/run.py", "reference/models.py")}
    cell = spec.Cell(f"toy.{mode}.p1", toy_root)
    tc = cell.train_config(1, "cpu")
    assert tc["seq_len"] == 6 and tc["batch_size"] == 4
    assert tc["compression"] == mode
    pool = rank._pool(cell, 5, 0)
    assert len(pool) == 3 and sorted(pool[0]) == ["targets", "tokens"]
    assert pool[0]["tokens"].shape == (4, 6)
    assert _digest(rank._pool(cell, 5, 0)) == _digest(pool)
    assert _digest(rank._pool(cell, 5, 1)) != _digest(pool)
    ref = reference_steps(cell.config, cell.traffic, 5, 1, [pool], 3,
                          torch.device("cpu"))
    assert len(ref["losses"]) == 3
    assert abs(ref["losses"][0] - math.log(40)) < 1.5
    names = [name for name, _, _ in ref["leaves"]]
    assert names == ["Embed_0/embedding", "Experts_0/kernel",
                     "Head_0/kernel", "Router_0/kernel"]
    assert ref["p0"].numel() == cell.config["num_params"]
    assert bool((ref["p3"] != ref["p0"]).any())
    assert yardstick.step_flops(cell.config, 4) == \
        6.0 * 6 * (3 * 12 + 3 * 144 + 40 * 12) * 4
    for p, text in before.items():
        assert open(os.path.join(spec.HERE, p)).read() == text


def test_a_kinds_flat_rule_lays_out_its_3d_leaf(toy_root):
    cell = spec.Cell("toy.dense.p1", toy_root)
    p = models.init(cell.config, 3)
    order = models.flat_order(p, cell.config)
    flat = models.ravel(p, order)
    off = dict((name, (o, n)) for name, o, n in models.leaves(p, order))
    o, n = off["Experts_0/kernel"]
    w = p[("Experts_0", "kernel")]
    assert torch.equal(flat[o:o + n], w.permute(0, 2, 1).reshape(-1))
    o, n = off["Embed_0/embedding"]
    assert torch.equal(flat[o:o + n], p[("Embed_0", "embedding")].reshape(-1))
    back = models.unravel(flat, p, order)
    assert all(torch.equal(back[k], p[k]) for k in p)


def test_a_metrics_declared_range_is_read(toy_root):
    from portbench import trace
    from portbench.tests.test_portbench_run import _ev

    cell = spec.Cell("toy.gtopk.p1", toy_root)
    ranges = trace.cell_ranges(cell)
    assert ranges == trace.RANGES + ("experts",)
    assert trace.cell_ranges(spec.Cell("toy.dense.p1", toy_root)) == \
        trace.RANGES
    evs = [_ev("user_annotation", trace.STEP_RANGE, 0, 100),
           _ev("user_annotation", "forward_backward", 0, 60),
           _ev("user_annotation", "experts", 20, 30),
           _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, 1),
           _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, 2),
           _ev("kernel", "expert_gemm", 25, 20, 1),
           _ev("kernel", "attn", 6, 10, 2)]
    got = trace.summarize(evs, 1, None, ranges)
    assert got["device_ms"]["experts"] == pytest.approx(0.020)
    assert got["device_ms"]["forward_backward"] == pytest.approx(0.030)
    ctx = type("Ctx", (), {"trace": got})()
    assert spec.reader("experts_ms")(ctx) == pytest.approx(0.020)
    assert "experts" not in trace.summarize(evs)["device_ms"]
    capture = [_ev("user_annotation", "experts", 0, 10),
               _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, 1)]
    assert trace.graph_nodes(capture, ranges) == [frozenset({"experts"})]
    assert trace.graph_nodes(capture) == [frozenset()]
