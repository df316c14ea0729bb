"""The port's wire model, planner and bucket DP against the JAX package's,
on the CPU, in one process (no ranks).

Held equal, at the same explicit constants (alpha, beta, the in-slice
bandwidth): ``comm_bytes_per_step`` (integers); ``comm_model.predict_comm_ms``
against ``gtopkssgd_tpu.obs.ledger.predict_comm_ms`` (which calls
``benchmarks/scaling_model.predict``) to the last bit, the same float
expressions in the same order; ``build_decision``'s record (candidates,
scores, choice, inputs, and the ``span_serial_ms`` / ``span_overlap_ms``
columns at the JAX package's selection cost, gamma 1.0 ms per 1e6
elements, passed explicitly); the pin errors' messages; ``plan_buckets``'s
boundaries, ks and pairs on ResNet-20's and ResNet-50's real leaf sizes;
each bucket's modeled merge cost. Also: the port's own fit files and
which one a run's backend reads, what the model refuses, and the
planner's choice of ``tree`` at P = 4 whatever the constants.
"""

import json
import math

import numpy as np
import pytest
import torch

from gtopkssgd_tpu.obs import ledger as jledger
from gtopkssgd_tpu.parallel import bucketing as jbucketing
from gtopkssgd_tpu.parallel import collectives as jcoll
from gtopkssgd_tpu.parallel import planner as jplanner
from gtopkssgd_tpu_torch.convert import flat_layout
from gtopkssgd_tpu_torch.models import get_model
from gtopkssgd_tpu_torch.parallel import bucketing, collectives, comm_model
from gtopkssgd_tpu_torch.parallel import planner

CODECS = ("fp32", "int8", "fp8:32")
N, K = 272_474, 273
# (alpha ms, beta Gbit/s, in-slice Gbit/s): the port's card fit, the
# JAX package's 4-process probe, a fast link that favours volume.
CONSTANTS = ((0.7318748333323318, 4.9251396574396304, 4.9251396574396304),
             (21.8594, 0.6, 1600.0), (0.001, 100.0, 400.0))


def _leaf_sizes(dnn):
    with torch.device("meta"):
        model, _ = get_model(dnn)
    return tuple(flat_layout(model).sizes)


RESNET20 = _leaf_sizes("resnet20")
RESNET50 = _leaf_sizes("resnet50")


def test_leaf_sizes_are_the_models():
    assert len(RESNET20) == 65 and sum(RESNET20) == 272_474
    assert len(RESNET50) == 161 and sum(RESNET50) == 25_557_032


@pytest.mark.parametrize("codec", CODECS)
def test_comm_bytes_per_step_matches_jax(codec):
    for p in range(1, 9):
        for mode in ("dense", "gtopk", "gtopk_layerwise", "allgather",
                     "topk"):
            for schedule in ((None, "tree", "balanced")
                             if mode in ("gtopk", "gtopk_layerwise")
                             else (None,)):
                assert (collectives.comm_bytes_per_step(
                    mode, N, K, p, codec=codec, schedule=schedule)
                    == jcoll.comm_bytes_per_step(
                        mode, N, K, p, codec=codec, schedule=schedule)), (
                    mode, p, schedule)
        for ici in (1, 2, 3, 4):
            if p % ici == 0:
                assert (collectives.comm_bytes_per_step(
                    "gtopk_hier", N, K, p, ici_size=ici, codec=codec)
                    == jcoll.comm_bytes_per_step(
                        "gtopk_hier", N, K, p, ici_size=ici, codec=codec))


@pytest.mark.parametrize("constants", range(len(CONSTANTS)))
def test_predict_comm_ms_is_bitwise_jax(constants):
    alpha, beta, ici_gbps = CONSTANTS[constants]
    pairs = ((84_480, 85), (76_032, 77), (111_962, 112))
    for wm in ("dense", "gtopk", "gtopk_balanced", "allgather",
               "gtopk_hier"):
        for p in (2, 3, 4, 6, 8):
            for ici in (1, 2, 4):
                for codec in CODECS:
                    for buckets in (None, pairs):
                        kw = dict(n=N, k=K, alpha_ms=alpha, beta_gbps=beta,
                                  ici_gbps=ici_gbps, ici_size=ici,
                                  codec=codec, buckets=buckets)
                        got = comm_model.predict_comm_ms(wm, p, **kw)
                        want = jledger.predict_comm_ms(wm, p, **kw)
                        assert got == want, (wm, p, ici, codec, buckets)


def test_wire_modes_and_the_allgather_names():
    for mode, schedule in (("gtopk", None), ("gtopk", "tree"),
                           ("gtopk", "balanced"),
                           ("gtopk_layerwise", "balanced"),
                           ("gtopk_hier", None), ("allgather", None),
                           ("dense", None)):
        assert (comm_model.wire_mode_for(mode, schedule)
                == jledger.wire_mode_for(mode, schedule))
    # The JAX model cannot price these (ValueError: topk); the port prices
    # them as the allgather wire they ship.
    for mode in ("topk", "topkA", "topk_allgather"):
        assert comm_model.wire_mode_for(mode) == "allgather"
        d = planner.build_decision(mode, p=4, n=N, k=K, alpha_ms=1.0,
                                   beta_gbps=1.0, ici_gbps=1.0)
        assert d.plan.name == "allgather"
        assert d.candidates[0]["comm_ms"] == round(
            comm_model.predict_comm_ms("allgather", 4, n=N, k=K,
                                       alpha_ms=1.0, beta_gbps=1.0,
                                       ici_gbps=1.0), 6)


def _jax_record(decision):
    return decision.record()


DECISION_MODES = (("gtopk", 1), ("gtopk_layerwise", 1), ("gtopk_hier", 1),
                  ("gtopk_hier", 2), ("allgather", 1), ("dense", 1))


@pytest.mark.parametrize("mode,ici", DECISION_MODES)
def test_build_decision_matches_jax(mode, ici):
    for alpha, beta, ici_gbps in CONSTANTS:
        for p in (2, 3, 4, 5, 8):
            if p % ici:
                continue
            for codec in CODECS:
                pins = ["auto"] + [c.name for c in planner.candidate_plans(
                    mode, ici_size=ici)]
                for pin in pins:
                    kw = dict(p=p, n=N, k=K, codec=codec, ici_size=ici,
                              pin=pin, alpha_ms=alpha, beta_gbps=beta,
                              ici_gbps=ici_gbps)
                    got = planner.build_decision(mode, select_gamma=1.0,
                                                 **kw)
                    want = jplanner.build_decision(mode, **kw)
                    assert got.record() == _jax_record(want), (mode, p, pin)
                    if pin != "auto":
                        assert got.plan.name == pin


def test_build_decision_prices_buckets_as_jax():
    pairs = bucketing.plan_buckets(RESNET20, 0.001, buckets=3, p=4,
                                   alpha_ms=1.0, beta_gbps=1.0).pairs()
    for alpha, beta, ici_gbps in CONSTANTS:
        for p in (2, 3, 4):
            kw = dict(p=p, n=N, k=sum(k for _, k in pairs), codec="int8",
                      alpha_ms=alpha, beta_gbps=beta, ici_gbps=ici_gbps,
                      bucketing="b3", buckets=pairs)
            got = planner.build_decision("gtopk_layerwise",
                                         select_gamma=1.0, **kw)
            want = jplanner.build_decision("gtopk_layerwise", **kw)
            assert got.record() == _jax_record(want)


@pytest.mark.parametrize("mode", ["gtopk", "gtopk_layerwise"])
def test_auto_keeps_the_tree_at_p4_and_may_balance_at_p3(mode):
    """At P = 4 the model prices tree at 16k/beta + 2 alpha against
    balanced's 18k/beta + 6 alpha (and a share on the in-slice link), so
    'auto' keeps the tree whatever the fit; at P = 3 balanced wins once
    alpha is small enough against k/beta, as JAX decides it too."""
    chose_balanced = False
    for alpha in (0.0, 1e-6, 1e-3, 0.1, 1.0, 30.0):
        for beta in (0.1, 1.0, 10.0, 400.0):
            for k in (273, 25_558, 100_000):
                kw = dict(n=25_557_032, k=k, alpha_ms=alpha, beta_gbps=beta,
                          ici_gbps=beta)
                assert planner.build_decision(
                    mode, p=4, **kw).plan.name == "tree"
                got = planner.build_decision(mode, p=3, **kw)
                want = jplanner.build_decision(mode, p=3, **kw)
                assert got.plan.name == want.plan.name
                chose_balanced |= got.plan.name == "balanced"
    assert chose_balanced


BAD_PINS = (("balanced", "gtopk_hier"), ("tree", "allgather"),
            ("hier", "gtopk"), ("nope", "gtopk_layerwise"),
            ("tree", "dense"))


@pytest.mark.parametrize("pin,mode", BAD_PINS)
def test_pin_errors_match_jax(pin, mode):
    with pytest.raises(ValueError) as want:
        jplanner.validate_pin(pin, mode)
    with pytest.raises(ValueError) as got:
        planner.validate_pin(pin, mode)
    assert str(got.value) == str(want.value)
    assert planner.validate_pin(None, mode) == "auto"


@pytest.mark.parametrize("dnn", ["resnet20", "resnet50"])
@pytest.mark.parametrize("codec", CODECS)
def test_plan_buckets_matches_jax_on_real_leaves(dnn, codec):
    sizes = RESNET20 if dnn == "resnet20" else RESNET50
    for alpha, beta, _ in CONSTANTS:
        for p in (2, 4, 8):
            for spec in ("leaf", 1, 4, "auto"):
                kw = dict(buckets=spec, p=p, codec=codec, alpha_ms=alpha,
                          beta_gbps=beta)
                got = bucketing.plan_buckets(sizes, 0.001, **kw)
                want = jbucketing.plan_buckets(sizes, 0.001, **kw)
                assert got.boundaries == want.boundaries, (spec, p, alpha)
                assert got.ks == want.ks and got.pairs() == want.pairs()
                assert got.spec == want.spec
                assert got.to_manifest() == want.to_manifest()
                assert math.isclose(
                    bucketing.partition_cost_ms(got, p=p, codec=codec,
                                                alpha_ms=alpha,
                                                beta_gbps=beta),
                    jbucketing.partition_cost_ms(want, p=p, codec=codec,
                                                 alpha_ms=alpha,
                                                 beta_gbps=beta),
                    rel_tol=0, abs_tol=0)


def test_bucket_spec_grammar_and_plan_round_trip():
    for spec, key in (("concat", "concat"), ("LEAF", "leaf"), (" auto ",
                      "auto"), ("3", "b3"), (5, "b5")):
        assert bucketing.buckets_key(spec) == jbucketing.buckets_key(spec)
        assert bucketing.buckets_key(spec) == key
    for bad in ("0", -1, True, "two", 2.0):
        with pytest.raises(ValueError) as want:
            jbucketing.parse_buckets(bad)
        with pytest.raises(ValueError) as got:
            bucketing.parse_buckets(bad)
        assert str(got.value) == str(want.value)
    assert bucketing.plan_buckets(RESNET20, 0.001, buckets="concat") is None
    plan = bucketing.plan_buckets(RESNET20, 0.001, buckets=3, p=2,
                                  alpha_ms=1.0, beta_gbps=1.0)
    back = bucketing.BucketPlan.from_manifest(plan.to_manifest())
    assert back.pairs() == plan.pairs() and back.n_buckets == 3
    assert bucketing.BucketPlan.from_manifest({}) is None
    with pytest.raises(ValueError, match="partition"):
        bucketing.BucketPlan((0, 2, 2), (1, 1), (1, 1))


def test_pipeline_overlap_and_auto_are_refused_by_the_roadmap_item():
    """The pipelines are in the port now: the grammar is the JAX
    package's, and what it refuses, it refuses with JAX's message."""
    for word in (" Serial ", "overlap", "AUTO"):
        assert (bucketing.parse_pipeline(word)
                == jbucketing.parse_pipeline(word))
    for bad in ("fast", "", None, 1):
        with pytest.raises(ValueError) as got:
            bucketing.parse_pipeline(bad)
        with pytest.raises(ValueError) as want:
            jbucketing.parse_pipeline(bad)
        assert str(got.value) == str(want.value)


def test_the_committed_fit_and_explicit_fit_files(tmp_path):
    fit = comm_model.load_fit()
    doc = json.load(open(comm_model.COMMITTED_FIT))
    assert fit["alpha_ms"] > 0 and fit["beta_gbps"] > 0
    assert "H100" in doc["card"] and doc["backend"] in ("gloo", "nccl")
    assert "one measured" in doc["link_classes"]
    inputs = planner.planner_inputs()
    assert inputs["ici_gbps"] == inputs["beta_gbps"]  # one link class
    assert inputs["fit_source"] == "comm_fit.json"
    # A JAX probe artifact prices the planner when named.
    path = tmp_path / "probe.json"
    path.write_text(json.dumps({
        "alpha_beta_fit": {"alpha_ms": 2.0, "beta_gbps": 3.0}}))
    got = planner.planner_inputs(str(path))
    assert (got["alpha_ms"], got["beta_gbps"], got["ici_gbps"]) == (2.0, 3.0,
                                                                    3.0)
    assert got["fit_source"] == "probe.json"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"alpha_beta_fit": {"alpha_ms": 1.0}}))
    with pytest.raises(ValueError, match="no usable alpha_beta_fit"):
        comm_model.load_fit(str(bad))
    with pytest.raises(ValueError, match="comm_probe"):
        comm_model.load_fit(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("schedule", ["tree", "balanced"])
def test_bucket_costs_and_rounds_match_jax(schedule):
    """Each bucket's modeled merge cost, bitwise, and the rounds."""
    plan = bucketing.plan_buckets(RESNET50, 0.001, buckets=4, p=4,
                                  alpha_ms=0.7, beta_gbps=4.9)
    for p in range(1, 9):
        assert bucketing.merge_rounds(p, schedule) == (
            jbucketing.merge_rounds(p, schedule))
        for codec in CODECS:
            kw = dict(p=p, codec=codec, schedule=schedule, alpha_ms=0.7,
                      beta_gbps=4.9)
            for n_b, k_b in plan.pairs():
                assert bucketing.bucket_cost_ms(n_b, k_b, **kw) == (
                    jbucketing.bucket_cost_ms(n_b, k_b, **kw))


def test_the_committed_fit_follows_the_backend(monkeypatch):
    """Without --comm-model-fit, a run prices with the fit measured over
    its process group's backend."""
    from gtopkssgd_tpu_torch import optimizer as topt

    assert comm_model.committed_fit("gloo") == comm_model.COMMITTED_FIT
    for backend in ("nccl", "gloo"):
        doc = json.load(open(comm_model.committed_fit(backend)))
        assert doc["backend"] == backend and "H100" in doc["card"]
    with pytest.raises(ValueError, match="--comm-model-fit"):
        comm_model.committed_fit("mpi")
    group = object()
    monkeypatch.setattr(topt.dist, "get_world_size", lambda g: 4)
    for backend, fit in (("nccl", "comm_fit_nccl.json"),
                         ("gloo", "comm_fit.json")):
        monkeypatch.setattr(topt.dist, "get_backend", lambda g: backend)
        opt = topt.GTopKSGD([torch.nn.Parameter(torch.zeros(64))], 0.1,
                            compression="gtopk_layerwise", buckets="auto",
                            process_group=group)
        assert opt.plan_decision.inputs["fit_source"] == fit
        want = planner.planner_inputs(comm_model.committed_fit(backend))
        assert opt.plan_decision.inputs["alpha_ms"] == want["alpha_ms"]
