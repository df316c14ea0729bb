"""Traffic without selection (``compression`` "dense"): the reference's
step is plain mean-gradient SGD, the program's record reads a missing
residual as zeros, and ``correct`` holds for the port's dense step and
fails for the faults planted under it (a tiny cell on the CPU, held to
the dense cell's limits)."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import check, spec
from portbench.rank import rank_main
from portbench.reference import models
from portbench.reference.run import reference_steps

SEED = 2 ** 31 + 41


@pytest.mark.parametrize("workers", [1, 2])
def test_dense_reference_is_mean_gradient_sgd(tiny_root, workers):
    """torch.optim.SGD on the mean of the workers' gradients, leaf by
    leaf, against the reference's flat dense step, three steps of a small
    AlexNet without dropout (no BatchNorm over a handful of values to
    amplify the two sides' rounding from step to step)."""
    cell = spec.Cell(f"tiny.dense.p{workers}", tiny_root)
    cfg = spec.load_json(f"{spec.HERE}/configs/alexnet-imagenet-bf16.json")
    cfg.update(image_size=64, num_classes=10, dtype="float32")
    cfg["arch"] = dict(cfg["arch"], fcs=[128, 128], dropout=0.0)
    batches = [spec.kind(cfg).pool(cfg, SEED, r, 3, 4)
               for r in range(workers)]
    ref = reference_steps(cfg, cell.traffic, SEED, workers, batches, 3,
                          torch.device("cpu"))
    kind = spec.kind(cfg)
    params = {k: t.clone().requires_grad_(True)
              for k, t in kind.init(cfg, SEED).items()}
    opt = torch.optim.SGD(list(params.values()),
                          lr=float(np.float32(cfg["lr"])),
                          momentum=cfg["momentum"],
                          weight_decay=cfg["weight_decay"])
    order = models.flat_order(params, cfg)
    losses = []
    for s in range(3):
        opt.zero_grad()
        step_losses = []
        for r in range(workers):
            b = {k: torch.from_numpy(v) for k, v in batches[r][s].items()}
            loss = kind.loss(cfg, params, b, models.identity, None)
            (loss / workers).backward()
            step_losses.append(float(loss.detach()))
        if s == 0:
            g1 = models.ravel({k: t.grad for k, t in params.items()}, order)
        losses.append(sum(step_losses) / workers)
        opt.step()
    p3 = models.ravel({k: t.detach() for k, t in params.items()}, order)
    # The two sides differ by float32 rounding alone (the order of the
    # sums, the layout the convolutions' backward reads): a few 1e-7.
    assert ref["losses"] == pytest.approx(losses, rel=1e-6)
    for h1 in ref["h1"]:
        assert float((h1 - g1).norm() / g1.norm()) < 1e-5
    assert all(bool(m.all()) for m in ref["keep1"])
    change = p3 - ref["p0"]
    assert float((ref["p3"] - p3).norm() / change.norm()) < 1e-5


def test_a_missing_residual_reads_as_zeros():
    """An optimizer whose state keeps no residual (absent, or the dense
    step's empty one): the first gradient is the velocity less the weight
    decay, and every entry it moved is kept."""
    from gtopkssgd_tpu_torch.optimizer import FlatLayout

    w = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    b = torch.tensor([0.5, -0.5])
    lay = FlatLayout.identity([w, b])
    vel = {w: {"momentum_buffer": torch.tensor([[0.1, 0.0], [0.3, 0.4]])},
           b: {"momentum_buffer": torch.tensor([0.2, 0.0])}}
    for residual in ({}, {"residual": torch.zeros(0)}):
        opt = SimpleNamespace(state=dict(vel, **residual))
        trainer = SimpleNamespace(optimizer=opt, layout=lay,
                                  layer_names=["w", "b"])
        rec = check.ProgramRecord(trainer, 0.01)
        rec.before()
        rec.after_first()
        p0 = torch.tensor([1.0, 2.0, 3.0, 4.0, 0.5, -0.5])
        want = torch.tensor([0.1, 0.0, 0.3, 0.4, 0.2, 0.0]) - 0.01 * p0
        assert torch.equal(rec.h1, want)
        assert torch.equal(rec.keep1, want != 0)


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch"])
def test_correct_at_p1_dense(tiny_root, fault):
    got = rank_main("cpu", "tiny.dense.p1", SEED, 0.0, False, time.time(),
                    tiny_root, fault=fault, window=False)
    cell = spec.Cell("tiny.dense.p1", tiny_root)
    assert "select_miss" not in cell.limits
    checks = check.verdict(got["numbers"], cell.limits)
    assert set(checks) == set(cell.limits)
    assert check.passed(checks) is (fault is None)
