"""The threshold apply (``ops.cuda_topk.threshold_apply``): the P = 1 step
after tau in one pass. How the optimizer calls it (once a unit, acc only
under telemetry), here on the CPU through the twin; on the card (skipped
here) the kernel bitwise to its twin on ``kernel_cases.apply_cases``,
captured and replayed in a CUDA graph, and counted once a unit of a P = 1
sparse step. JAX-free: the twin is held to the JAX package in
``test_torch_ops.py`` and ``test_torch_optimizer.py``.
"""

import pytest
import torch

from gtopkssgd_tpu_torch import compression
from gtopkssgd_tpu_torch.ops import cuda_topk, kernel_cases
from gtopkssgd_tpu_torch.optimizer import GTopKSGD

torch.set_num_threads(2)
SHAPES = ((1000,), (300, 7), (5,))


def _params(device):
    gen = torch.Generator(device=device).manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(s, device=device,
                                             generator=gen))
              for s in SHAPES]
    for p in params:
        p.grad = torch.randn(p.shape, device=device, generator=gen)
    return params


def _counted(monkeypatch):
    """The optimizer's calls of the apply, as their want_acc flags."""
    calls = []
    real = compression.threshold_apply

    def spy(src, res_in, tau, want_acc=False):
        calls.append(want_acc)
        return real(src, res_in, tau, want_acc)

    monkeypatch.setattr(compression, "threshold_apply", spy)
    return calls


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("mode,units", [("gtopk", 1),
                                        ("gtopk_layerwise", len(SHAPES))])
def test_p1_step_applies_once_a_unit(mode, units, telemetry, monkeypatch):
    """A P = 1 sparse step calls the apply once a unit (the whole vector,
    or each leaf under gtopk_layerwise), asking for acc only when the
    counters read it; its update is acc - residual of the step's own
    accumulator."""
    calls = _counted(monkeypatch)
    params = _params("cpu")
    opt = GTopKSGD(params, 0.1, compression=mode, density=0.05,
                   topk_method="exact", telemetry=telemetry)
    res_in = opt.state["residual"].clone()
    flat = opt.layout.ravel([p.grad for p in params])
    update = opt.compress(flat)
    assert calls == [telemetry] * units
    residual = opt.state["residual"]
    assert torch.equal(update + residual, flat + res_in)
    assert torch.equal(opt.last_keep, update != 0)


@pytest.mark.cuda
def test_threshold_apply_on_card(monkeypatch):
    """On a CUDA card: the kernel bitwise equal to its twin on every
    ``apply_cases`` case (NaNs as bits), with acc and without (then no acc
    is written: none is returned); a captured launch replays with the same
    bits as an eager launch on new inputs; a P = 1 sparse step adds one
    launch a unit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")
    for label, src, res_in, tau in kernel_cases.apply_cases("cuda"):
        bad = kernel_cases.apply_mismatch(src, res_in, tau)
        assert bad is None, f"{label}: {bad}"
    assert cuda_topk.threshold_apply(src, res_in, tau, False)[4] is None

    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 2_359_299
    buf = torch.randn(2 * n + 1, device="cuda", generator=gen)
    src, res_in = buf[1:n + 1], 0.3 * buf[n + 1:]  # src at an odd offset
    tau = (src + res_in).abs().quantile(0.999)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_topk.threshold_apply(src, res_in, tau, True)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    cuda_topk.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_topk.threshold_apply(src, res_in, tau, True)
    assert cuda_topk.launches["threshold_apply"] == 1
    for scale in (1.0, 0.5):
        buf.copy_(torch.randn(2 * n + 1, device="cuda", generator=gen))
        tau.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        want = cuda_topk.threshold_apply(src, res_in, tau, True)
        for a, b in zip(out, want):
            assert kernel_cases.same_bits(a, b)
        assert kernel_cases.apply_mismatch(src, res_in, tau) is None

    for mode, units in (("gtopk", 1), ("gtopk_layerwise", len(SHAPES))):
        for telemetry in (False, True):
            calls = _counted(monkeypatch)
            params = _params("cuda")
            opt = GTopKSGD(params, 0.1, compression=mode, density=0.05,
                           topk_method="twostage", telemetry=telemetry)
            cuda_topk.reset_launches()
            opt.step()
            torch.cuda.synchronize()
            assert cuda_topk.launches["threshold_apply"] == units
            assert calls == [telemetry] * units
