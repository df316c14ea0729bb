"""The SGD apply (``ops.cuda_topk.sgd_apply``): ``torch.optim.SGD``'s step
of every leaf read from the flat update, each parameter and momentum
buffer written in place, one launch a step on a CUDA card.

On the CPU the twin runs: held bitwise to the path it replaced (the update
copied into each ``.grad`` by ``FlatLayout.unravel_into``, then
``torch.optim.SGD.step()``) on every leaf kind, hyperparameter set and
buffer state of ``kernel_cases.sgd_cases``, and through ``GTopKSGD``'s
step (p.grad untouched, state_dict round trip, a dropped buffer). On the
card (skipped here) the kernel against that path at the cells' layouts
and on the edge cases, captured and replayed in a CUDA graph, launched
once a step, and its leaf table rebuilt after a checkpoint load.
JAX-free: ``GTopKSGD`` is held to the JAX optimizer in
``test_torch_optimizer.py`` and ``test_torch_options.py``.
"""

import io
import json
import os

import pytest
import torch

from gtopkssgd_tpu_torch.ops import cuda_topk
from gtopkssgd_tpu_torch.ops import kernel_cases as kc
from gtopkssgd_tpu_torch.optimizer import FlatLayout, GTopKSGD

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = kc.sgd_case_specs()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on one")


@pytest.mark.parametrize("spec", SPECS, ids=[f"case{i}"
                                             for i in range(len(SPECS))])
def test_twin_bitwise_the_parent_path(spec):
    """The twin gives the parameters and buffers of the unravel + SGD
    step bitwise, NaNs as bits, on the edge layout (every leaf kind, odd
    offsets, 1-element leaves) under each hyperparameter set with all,
    no and some buffers, with and without special values."""
    (label, case, hyper), = kc.sgd_cases("cpu", specs=[spec])
    assert kc.sgd_mismatch(case, hyper) is None, label


@pytest.mark.parametrize("shape,perm,kind,arg", [
    ((64, 3, 11, 11), (2, 3, 1, 0), cuda_topk.SGD_TILED, (64, 3, 121)),
    ((4096, 9216), (1, 0), cuda_topk.SGD_TILED, (4096, 9216, 1)),
    ((48, 33, 1, 1), (2, 3, 1, 0), cuda_topk.SGD_TILED, (48, 33, 1)),
    ((6, 4, 5), (2, 0, 1), cuda_topk.SGD_TILED, (24, 5, 1)),
    ((5, 1, 3), (2, 1, 0), cuda_topk.SGD_TILED, (5, 3, 1)),
    ((2048,), (0,), cuda_topk.SGD_IDENTITY, ()),
    ((20480, 2048), (0, 1), cuda_topk.SGD_IDENTITY, ()),
    ((1, 1), (1, 0), cuda_topk.SGD_IDENTITY, ()),
    ((1,), (0,), cuda_topk.SGD_IDENTITY, ()),
    ((2, 3, 4), (1, 0, 2), cuda_topk.SGD_STRIDED, ((2, 3, 4), (4, 8, 1))),
    ((2, 3, 4), (0, 2, 1), cuda_topk.SGD_STRIDED, ((2, 3, 4), (12, 1, 3))),
])
def test_leaf_kind_is_read_off_the_layout(shape, perm, kind, arg):
    """Size-1 axes dropped and adjacent axes merged, a leaf is an
    identity stream, a tile transpose [A][I][S] -> [S][I][A] or strided;
    the strided strides place every element where the permutation does."""
    assert cuda_topk.sgd_leaf_shape(shape, perm) == (kind, arg)
    if kind == cuda_topk.SGD_STRIDED:
        dims, strides = arg
        p = torch.arange(float(torch.Size(shape).numel())).view(shape)
        flat = p.permute(perm).reshape(-1)
        idx = torch.zeros(p.numel(), dtype=torch.long)
        for d, (size, stride) in enumerate(zip(dims, strides)):
            shape_d = [1] * len(dims)
            shape_d[d] = size
            idx = idx + (torch.arange(size) * stride).view(shape_d).expand(
                dims).reshape(-1)
        assert torch.equal(flat[idx], p.reshape(-1))


@pytest.mark.parametrize("dnn,identity,tiled", [("resnet50", 107, 54),
                                                ("alexnet", 8, 8)])
def test_model_layouts_take_no_strided_path(dnn, identity, tiled):
    """The cells' layouts: every leaf an identity stream or a tile
    transpose, and one work item a block covers them once."""
    leaves = kc.model_leaves(dnn)
    kinds = [cuda_topk.sgd_leaf_shape(s, p)[0] for s, p in leaves]
    assert kinds.count(cuda_topk.SGD_IDENTITY) == identity
    assert kinds.count(cuda_topk.SGD_TILED) == tiled
    params = [torch.empty(s, device="meta") for s, _ in leaves]
    lv = cuda_topk.SgdLeaves(params, [p for _, p in leaves],
                             kc.flat_offsets(params))
    assert lv.n == sum(p.numel() for p in params)
    assert len(lv.starts) == len(leaves) + 1
    assert all(b > a for a, b in zip(lv.starts, lv.starts[1:]))


def _params(device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ((6, 3, 3, 3), (10, 6), (6,), (4,))
    perms = ((2, 3, 1, 0), (1, 0), (0,), (0,))
    params = [torch.nn.Parameter(0.1 * torch.randn(s, device=device,
                                                   generator=gen))
              for s in shapes]
    return params, FlatLayout(list(zip(params, perms)))


def _grads(params, step, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(100 + step)
    for p in params:
        p.grad = torch.randn(p.shape, device=device, generator=gen)


def _parent_sgd(opt, update):
    """The step before the SGD apply: the update into each .grad, then
    torch.optim.SGD's step."""
    lay = opt.layout
    for p in lay.params:
        if p.grad is None:
            p.grad = torch.empty_like(p)
    lay.unravel_into(update, [p.grad for p in lay.params])
    torch.optim.SGD.step(opt)


OPTIONS = {
    "gtopk": dict(compression="gtopk", density=0.2, weight_decay=1e-4),
    "dense": dict(compression="dense", weight_decay=5e-4),
    "nesterov": dict(compression="gtopk", density=0.2, nesterov=True),
    "correction": dict(compression="gtopk", density=0.2,
                       momentum_correction=True, weight_decay=1e-4),
    "schedule": dict(compression="gtopk", density=0.2, weight_decay=1e-4,
                     lr=lambda c: 0.1 / (1 + c)),
}


def _pair(option, device="cpu"):
    kw = dict(OPTIONS[option])
    lr = kw.pop("lr", 0.1)
    out = []
    for _ in range(2):
        params, lay = _params(device)
        out.append(GTopKSGD(params, lr, topk_method="exact", layout=lay,
                            **kw))
    return out


@pytest.mark.parametrize("option", list(OPTIONS))
def test_step_bitwise_the_parent_step(option, monkeypatch):
    """Three GTopKSGD steps, the SGD apply against the unravel + SGD step
    on the same gradients: parameters and momentum buffers bitwise; the
    momentum buffers are SGD's state (none under momentum correction)."""
    new, old = _pair(option)
    monkeypatch.setattr(old, "_sgd", lambda u: _parent_sgd(old, u))
    for step in range(3):
        for opt in (new, old):
            _grads(opt.layout.params, step)
            opt.step()
        for a, b in zip(new.layout.params, old.layout.params):
            assert kc.same_bits(a.detach(), b.detach()), (option, step)
            ba = new.state.get(a, {}).get("momentum_buffer")
            bb = old.state.get(b, {}).get("momentum_buffer")
            assert (ba is None) == (bb is None)
            assert ba is None or kc.same_bits(ba, bb)
    correction = option == "correction"
    assert all(("momentum_buffer" in new.state.get(p, {})) != correction
               for p in new.layout.params)


def test_grad_is_untouched_by_step():
    """After step() each .grad holds the backward's gradient, the same
    tensor with the same values; a None grad stays None."""
    params, lay = _params()
    opt = GTopKSGD(params, 0.1, compression="gtopk", density=0.2,
                   topk_method="exact", layout=lay, weight_decay=1e-4,
                   nesterov=True)
    _grads(params, 0)
    params[2].grad = None
    grads = [p.grad for p in params]
    before = [None if g is None else g.clone() for g in grads]
    opt.step()
    for p, g, b in zip(params, grads, before):
        assert p.grad is g
        assert g is None or kc.same_bits(g, b)


def test_state_dict_round_trip_keeps_the_momentum():
    """state_dict holds the momentum buffers the apply writes; a second
    optimizer loaded from it steps on bitwise as the first does."""
    a, b = _pair("gtopk")
    for step in range(2):
        _grads(a.layout.params, step)
        a.step()
    for p, q in zip(a.layout.params, b.layout.params):
        q.data.copy_(p.data)
    b.load_state_dict(_reloaded(a.state_dict()))
    for p, q in zip(a.layout.params, b.layout.params):
        assert kc.same_bits(a.state[p]["momentum_buffer"],
                            b.state[q]["momentum_buffer"])
    for opt in (a, b):
        _grads(opt.layout.params, 2)
        opt.step()
    for p, q in zip(a.layout.params, b.layout.params):
        assert kc.same_bits(p.detach(), q.detach())
        assert kc.same_bits(a.state[p]["momentum_buffer"],
                            b.state[q]["momentum_buffer"])


def _reloaded(state_dict):
    """`state_dict` through a save and a load, as a checkpoint goes: new
    tensors."""
    buf = io.BytesIO()
    torch.save(state_dict, buf)
    buf.seek(0)
    return torch.load(buf)


def test_dropped_buffer_starts_fresh(monkeypatch):
    """A leaf whose buffer was dropped (as a snapshot's restore drops one
    SGD made in between) takes b = g again, as SGD's clone does, while the
    other leaves go on: bitwise the parent step."""
    new, old = _pair("gtopk")
    monkeypatch.setattr(old, "_sgd", lambda u: _parent_sgd(old, u))
    for step in range(3):
        for opt in (new, old):
            if step == 2:
                opt.state[opt.layout.params[1]].pop("momentum_buffer")
            _grads(opt.layout.params, step)
            opt.step()
    for a, b in zip(new.layout.params, old.layout.params):
        assert kc.same_bits(a.detach(), b.detach())
        assert kc.same_bits(new.state[a]["momentum_buffer"],
                            old.state[b]["momentum_buffer"])


@pytest.mark.parametrize("key,value", [("dampening", 0.1),
                                       ("maximize", True)])
def test_options_sgd_has_and_the_port_never_sets_raise(key, value):
    params, lay = _params()
    opt = GTopKSGD(params, 0.1, compression="dense", layout=lay)
    opt.param_groups[0][key] = value
    _grads(params, 0)
    with pytest.raises(ValueError, match="dampening"):
        opt.step()


# ---------------------------------------------------------------- the card


def _moonlight_config(layers: int = 2) -> dict:
    path = os.path.join(REPO, "portbench", "configs",
                        "moonlight-16b-a3b-ep8-bf16.json")
    with open(path) as fh:
        return {**json.load(fh), "num_hidden_layers": layers}


@pytest.mark.cuda
def test_kernel_bitwise_on_card():
    """On a CUDA card: the kernel against the unravel + foreach SGD step,
    bitwise (NaNs as bits), on every edge case and at the layouts of
    ResNet-50, AlexNet and Moonlight (two of its layers)."""
    _card()
    for label, case, hyper in kc.sgd_cases("cuda"):
        assert kc.sgd_mismatch(case, hyper) is None, label
    hyper = dict(lr=0.01, momentum=0.9, weight_decay=1e-4, nesterov=False)
    for dnn, config in (("resnet50", None), ("alexnet", None),
                        ("moonlight", _moonlight_config())):
        case = kc.sgd_case(kc.model_leaves(dnn, config), "cuda", seed=3)
        assert kc.sgd_mismatch(case, hyper) is None, dnn
        del case
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_captured_and_replayed_on_card():
    """A captured launch (its table built by an eager launch first)
    replays bitwise as an eager launch on the same inputs, and capturing
    a launch whose table must change raises."""
    _card()
    hyper = dict(lr=0.05, momentum=0.9, weight_decay=5e-4, nesterov=True)
    case = kc.sgd_case(kc.SGD_EDGE_LEAVES, "cuda", seed=5)
    params = [p.clone() for p in case["params"]]
    bufs = [b.clone() for b in case["bufs"]]
    lv = cuda_topk.SgdLeaves(params, case["perms"],
                             kc.flat_offsets(params))
    cuda_topk.sgd_apply(case["update"], lv, bufs, **hyper)  # the table
    start = [t.clone() for t in params + bufs]
    graph = torch.cuda.CUDAGraph()
    cuda_topk.reset_launches()
    with torch.cuda.graph(graph):
        cuda_topk.sgd_apply(case["update"], lv, bufs, **hyper)
    assert cuda_topk.launches["sgd_apply"] == 1
    for t, s in zip(params + bufs, start):
        t.copy_(s)
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in params + bufs]
    for t, s in zip(params + bufs, start):
        t.copy_(s)
    cuda_topk.sgd_apply(case["update"], lv, bufs, **hyper)
    for a, b in zip(replayed, params + bufs):
        assert kc.same_bits(a, b)
    moved = [b.clone() for b in bufs]
    with pytest.raises(RuntimeError, match="leaf table"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            cuda_topk.sgd_apply(case["update"], lv, moved, **hyper)


@pytest.mark.cuda
def test_one_launch_a_step_and_table_after_load_on_card():
    """GTopKSGD launches the apply once a step, whatever the number of
    leaves, and writes no .grad; after a state_dict load (new buffers)
    the table is rebuilt, by ``prepare_capture`` before a capture, and
    the steps stay bitwise those of the parent step."""
    _card()
    new, old = _pair("gtopk", "cuda")
    old._sgd = lambda u: _parent_sgd(old, u)
    cuda_topk.reset_launches()
    for step in range(2):
        for opt in (new, old):
            _grads(opt.layout.params, step, "cuda")
            opt.step()
    assert cuda_topk.launches["sgd_apply"] == 2
    key = new._leaves._key
    new.load_state_dict(_reloaded(new.state_dict()))
    old.load_state_dict(_reloaded(old.state_dict()))
    new.prepare_capture()
    assert new._leaves._key != key
    for opt in (new, old):
        _grads(opt.layout.params, 2, "cuda")
        opt.step()
    assert cuda_topk.launches["sgd_apply"] == 3
    for a, b in zip(new.layout.params, old.layout.params):
        assert kc.same_bits(a.detach(), b.detach())
        assert kc.same_bits(new.state[a]["momentum_buffer"],
                            old.state[b]["momentum_buffer"])
