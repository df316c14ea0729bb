"""The plain reference against the port's model and optimizer step on
the CPU at a tiny size, float32 on both sides."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import check, spec
from portbench.rank import rank_main
from portbench.reference import gtopk, models


@pytest.mark.parametrize("config", ["resnet50-imagenet-bf16",
                                    "alexnet-imagenet-bf16"])
def test_init_and_flat_order_are_the_ports(config):
    from gtopkssgd_tpu_torch.convert import flat_layout, layer_names
    from gtopkssgd_tpu_torch.models import get_model

    cfg = spec.load_json(f"{spec.HERE}/configs/{config}.json")
    model, _ = get_model(cfg["dnn"])
    model.reset_parameters(torch.Generator().manual_seed(5))
    lay = flat_layout(model)
    ref = models.init(cfg, 5)
    order = models.flat_order(ref, cfg)
    assert [name for name, _, _ in models.leaves(ref, order)] == \
        layer_names(model)
    assert sum(p.numel() for p in ref.values()) == cfg["num_params"]
    assert torch.equal(models.ravel(ref, order),
                       lay.ravel([p.detach() for p in lay.params]))


def test_three_steps_match_the_port(tiny_root):
    got = rank_main("cpu", "tiny.p1", 2 ** 31 + 9, 0.0, False, time.time(),
                    tiny_root, window=False)
    n = got["numbers"]
    assert n["layout"] == 0
    assert n["loss"] < 1e-5
    assert n["grad_leaf"] < 1e-4
    assert n["change_all"] < 1e-4
    assert n["select_miss"] < 1e-3


def _acc(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g) * torch.rand(n, generator=g) ** 4


def test_selection_is_the_ports():
    from gtopkssgd_tpu_torch.compression import get_compressor
    from gtopkssgd_tpu_torch.ops.topk import twostage_topk_abs

    n = 3 * (1 << 21) + 12345
    k = max(1, int(np.ceil(0.001 * n)))
    acc = _acc(n, 1)
    comp = get_compressor("gtopk", 0.001, "twostage")
    keep, _, _ = comp.compress_by_threshold(acc)
    assert torch.equal(gtopk.threshold_keep(acc, k), keep)
    vals, idx = twostage_topk_abs(acc, k)
    rv, ri = gtopk.local_set(acc, k)
    assert torch.equal(ri, idx.long()) and torch.equal(rv, vals)


def test_tree_is_the_ports():
    from gtopkssgd_tpu_torch.parallel.collectives import merge_tree_ref

    n, k = 50000, 64
    sets = []
    for r in range(4):
        v, i = gtopk.local_set(_acc(n, 10 + r), k)
        sets.append((v, i))
    want = merge_tree_ref([(v, i.to(torch.int32)) for v, i in sets], k, n)
    gv, gi = gtopk.tree(sets, k, n)
    order = torch.argsort(gi)
    worder = torch.argsort(want[0][1].long())
    assert torch.equal(gi[order], want[0][1].long()[worder])
    assert torch.equal(gv[order], want[0][0][worder])


def test_compare_reads_a_frozen_leaf_as_one():
    leaves = [("a", 0, 2), ("b", 2, 2)]
    ref = {"leaves": leaves, "losses": [1.0, 1.0, 1.0],
           "grad_norms": [torch.ones(2, dtype=torch.float64)] * 3,
           "h1": [torch.tensor([1.0, 1.0, 1.0, 1.0])],
           "keep1": [torch.tensor([True, False, False, True])],
           "p0": torch.zeros(4), "p3": torch.tensor([1.0, 0.0, 1.0, 0.0])}

    class Cand:
        pass

    c = Cand()
    c.leaves, c.losses = leaves, [1.0, 1.0, 1.0]
    c.h1, c.keep1 = ref["h1"][0].clone(), ref["keep1"][0].clone()
    c.p0, c.p3 = torch.zeros(4), torch.tensor([1.0, 0.0, 0.0, 0.0])
    got = check.compare(c, ref, 0)
    assert got["change_leaf"] == 1.0 and got["grad_leaf"] == 0.0
    assert got["select_miss"] == 0.0 and got["loss"] == 0.0
    assert got["grad_err"] == 0.0


def test_grad_err_is_the_first_gradients_relative_error():
    """Leaf b's first gradient has a sign flipped: its norm is the
    reference's, so grad_leaf reads 0, and grad_err reads the norm of
    the difference over the reference's."""
    leaves = [("a", 0, 2), ("b", 2, 2)]
    ref = {"leaves": leaves, "losses": [1.0] * 3,
           "grad_norms": [torch.ones(2, dtype=torch.float64)] * 3,
           "h1": [torch.tensor([3.0, 0.0, 0.0, 4.0])],
           "keep1": [torch.ones(4, dtype=torch.bool)],
           "p0": torch.zeros(4), "p3": torch.ones(4)}
    c = SimpleNamespace(leaves=leaves, losses=[1.0] * 3,
                        h1=torch.tensor([3.0, 0.0, 0.0, -4.0]),
                        keep1=torch.ones(4, dtype=torch.bool),
                        p0=torch.zeros(4), p3=torch.ones(4))
    got = check.compare(c, ref, 0)
    assert got["grad_leaf"] == 0.0
    assert got["grad_err"] == pytest.approx(8.0 / 5.0)
