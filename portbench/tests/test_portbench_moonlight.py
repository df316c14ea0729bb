"""The Moonlight cell's files: the configuration against the catalog's
published keys and the cut, its N, the kind's pool and hand-counted
FLOPs, the new metrics' ranges and the experts' FLOP count, and a tiny
cell of the same kind through the harness's judge on the CPU."""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import check, spec, trace, yardstick
from portbench.kinds import moonlight
from portbench.rank import rank_main

CELL = "moonlight.gtopk.s8k.b4.p1"
CONFIG = "moonlight-16b-a3b-ep8-bf16"
# The catalog's config of Moonlight-16B-A3B (its source_url's
# config.json), as the model-configs guide lists it.
CATALOG = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "max_position_embeddings": 8192,
    "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "num_nextn_predict_layers": 0, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "noaux_tc", "v_head_dim": 128,
    "vocab_size": 163840}
CUT = {"n_routed_experts": 8, "vocab_size": 20480, "num_hidden_layers": 9}
SELECT_BLOCK = 2048 * 128  # the selection kernels' tile (n < 2^31 - it)


def _config():
    return spec.load_json(os.path.join(spec.HERE, "configs",
                                       CONFIG + ".json"))


def test_the_configuration_is_the_catalogs_cut_to_one_chip():
    cfg = _config()
    entry = next(c for c in spec.benchmark()["configs"]
                 if c["name"] == CONFIG)
    assert entry["source"] == cfg["source"]
    assert sorted(entry["reduced"]) == sorted(list(CUT) + ["workers"])
    for key, value in CATALOG.items():
        assert cfg[key] == CUT.get(key, value), key
    dep = cfg["deployment"]
    assert (dep["chips_per_layer"], dep["n_routed_experts"],
            dep["vocab_size"], dep["num_hidden_layers"]) == (
        8, 64, 163840, 27)
    assert set(cfg["reduced"]) == set(entry["reduced"])
    assert cfg["train_config"]["model_config"] == (
        f"portbench/configs/{CONFIG}.json")


def test_n_and_its_parts():
    cfg = _config()
    shapes = moonlight.shapes(cfg)
    size = {k: math.prod(s) for k, s in shapes.items()}

    def part(prefix):
        return sum(v for k, v in size.items() if k[:len(prefix)] == prefix)

    assert part(("embed",)) == part(("head",)) == 41_943_040
    assert part(("norm",)) == 2048
    assert part(("layers", "0")) == 82_973_184
    for i in range(1, 9):
        moe = ("layers", str(i), "mlp")
        assert part(("layers", str(i))) == 100_405_760
        assert part(moe + ("experts",)) == 69_206_016
        assert part(moe + ("shared",)) == 17_301_504
        assert part(moe + ("router",)) == 131_072
        assert part(("layers", str(i), "attn")) == 13_763_072
    n = sum(size.values())
    assert n == cfg["num_params"] == 970_107_392
    assert n < 2 ** 31 - SELECT_BLOCK
    assert yardstick.k_for_density(n, 0.001) == 970_108


def test_forward_macs_and_step_flops_match_a_hand_count():
    cfg = _config()
    per_token = (9 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
                 + 3 * 2048 * 11264
                 + 8 * (2048 * 64 + 3 * 2048 * 2816 + 6 * 3 * 2048 * 1408
                        * 8 // 64)
                 + 2048 * 20480)
    assert per_token == 426_377_216
    attention = 9 * 16 * (192 + 128) * 8192 * 8192 // 2
    assert moonlight.forward_macs(cfg) == 8192 * per_token + attention
    assert yardstick.step_flops(cfg, 4) == pytest.approx(
        6.0 * (8192 * per_token + attention) * 4)
    assert 1.2e14 < yardstick.step_flops(cfg, 4) < 1.22e14


def test_the_pool_is_seeded_token_pairs_from_the_slice():
    cfg = _config()
    a = moonlight.pool(cfg, 2 ** 31 + 77, 0, 2, 4)
    b = moonlight.pool(cfg, 2 ** 31 + 77, 0, 2, 4)
    c = moonlight.pool(cfg, 2 ** 31 + 77, 1, 2, 4)
    assert [sorted(x) for x in a] == [["targets", "tokens"]] * 2
    t = a[0]["tokens"]
    assert t.shape == (4, 8192) and t.dtype == np.int32
    assert np.array_equal(t, b[0]["tokens"])
    assert not np.array_equal(t, c[0]["tokens"])
    assert np.array_equal(t[:, 1:], a[0]["targets"][:, :-1])
    assert 0 <= t.min() and t.max() < 20480
    assert 0.05 < float(np.mean(t == 0)) < 0.15  # Zipf(1.1): 1 / zeta(1.1)


def test_the_cell_reads_its_ranges_and_metrics():
    cell = spec.Cell(CELL)
    assert cell.chips == 1
    tc = cell.train_config(5, "cuda:0")
    assert (tc["dnn"], tc["dataset"], tc["batch_size"],
            tc["steps_per_dispatch"], tc["compression"]) == (
        "moonlight", "tokens", 4, 4, "gtopk")
    assert tc["clip_grad_norm"] == 1.0
    names = [m["name"] for m in cell.per_layer]
    assert names == ["data_host_ms", "fb_ms", "mfu", "optimizer_ms",
                     "select_roofline", "device_idle_frac", "idle_data_ms",
                     "idle_tail_ms", "attention_ms", "router_ms",
                     "experts_ms", "experts_mfu"]
    assert trace.cell_ranges(cell) == trace.RANGES + (
        "attention", "router", "experts")
    assert trace.cell_ranges(spec.Cell("resnet50.gtopk.b32.p1")) == \
        trace.RANGES
    assert spec.kind(cell.config) is moonlight


def test_experts_mfu_counts_18_hidden_width_a_pair(monkeypatch):
    from gtopkssgd_tpu_torch.obs import tracing

    mod = spec.metric("experts_mfu")
    assert mod.expert_flops(2048, 1408, 1) == 18 * 2048 * 1408 == 51_904_512
    # The set-up's profiled dispatch, the unprofiled window, then the
    # stretch of 2 steps: the pairs are the stretch's.
    monkeypatch.setattr(tracing, "routing", [(90.0, 2.0, 0.0, True),
                                             (70.0, 2.0, 0.0, False),
                                             (10.0, 2.0, 0.0, True),
                                             (30.0, 3.0, 0.0, True),
                                             (50.0, 1.0, 0.0, False)])
    ctx = SimpleNamespace(
        trace={"steps": 2, "device_ms": {"experts": 2.0}},
        config=_config(), peak_flops=989.4e12)
    want = 100.0 * 18 * 2048 * 1408 * 20.0 / 2e-3 / 989.4e12
    assert mod.read(ctx) == pytest.approx(want)
    ctx.trace["steps"] = 4
    assert mod.read(ctx) is None
    ctx.trace["steps"] = 2
    monkeypatch.setattr(tracing, "routing", [])
    assert mod.read(ctx) is None
    for name in ("attention_ms", "router_ms", "experts_ms"):
        assert spec.reader(name)(ctx) == (2.0 if name == "experts_ms"
                                          else None)


TINY = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 96, "moe_intermediate_size": 16,
        "n_routed_experts": 4, "num_experts_per_tok": 2, "vocab_size": 128,
        "num_hidden_layers": 3, "seq_len": 16}


@pytest.fixture(scope="module")
def tiny_moon(tmp_path_factory):
    """A checkout root with a tiny cell of the Moonlight kind: the real
    configuration at tiny widths (8 router experts, 4 held) and the real
    traffic at batch 2, K = 2, density 0.01."""
    root = str(tmp_path_factory.mktemp("moonroot"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(spec.HERE, kind),
                        os.path.join(root, "portbench", kind))
    cfg = dict(_config(), **TINY, name="tiny-moon")
    cfg["deployment"] = dict(cfg["deployment"], n_routed_experts=8)
    path = os.path.join(root, "portbench", "configs", "tiny-moon.json")
    cfg["train_config"] = dict(cfg["train_config"], model_config=path)
    cfg["num_params"] = sum(math.prod(s)
                            for s in moonlight.shapes(cfg).values())
    cfg["epoch_samples"] = 1000
    traffic = spec.load_json(os.path.join(spec.HERE, "traffic",
                                          "gtopk.s8k.b4.p1.json"))
    traffic["train_config"].update(batch_size=2, steps_per_dispatch=2,
                                   density=0.01)
    traffic.update(name="tiny-moon", pool_batches=4, warmup_steps=2,
                   capture_seconds=0.1)
    # A tiny selection (rho 0.01 of 124k entries, 32 tokens a step)
    # misses and moves more than the real cell's: its own limits, about
    # 3x over its readings on the CPU (loss 2.4e-3, grad_leaf 0.011,
    # change_all 0.030, select_miss 0.21), which frozen exceeds.
    limits = {"layout": 0, "loss": 0.01, "grad_leaf": 0.05,
              "change_all": 0.1, "select_miss": 0.6}
    bench = spec.benchmark()
    bench["configs"].append({"name": "tiny-moon", "source": cfg["source"],
                             "file": "portbench/configs/tiny-moon.json",
                             "reduced": ["hidden_size"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.moon", "config": "tiny-moon",
                               "traffic": "tiny-moon", "chips": 1,
                               "why": "a test"})
    files = {path: cfg,
             os.path.join(root, "portbench", "traffic", "tiny-moon.json"):
                 traffic,
             os.path.join(root, "portbench", "workloads", "tiny.moon.json"):
                 {"name": "tiny.moon", "limits": limits},
             os.path.join(root, "BENCHMARK.json"): bench}
    for p, obj in files.items():
        with open(p, "w") as fh:
            json.dump(obj, fh)
    return root


@pytest.mark.parametrize("fault", [None, "frozen"])
def test_a_tiny_cell_of_the_kind_is_judged(tiny_moon, fault):
    """Through ``rank_main`` on the CPU (the port's ``Trainer.train`` at
    K = 2, then the reference's three steps): correct, and not correct
    with the optimizer frozen."""
    got = rank_main("cpu", "tiny.moon", 2 ** 31 + 11, 0.0, False,
                    time.time(), tiny_moon, fault=fault, window=False)
    limits = spec.Cell("tiny.moon", tiny_moon).limits
    ok = check.passed(check.verdict(got["numbers"], limits))
    assert ok == (fault is None), got["numbers"]
    assert got["numbers"]["layout"] == 0.0
