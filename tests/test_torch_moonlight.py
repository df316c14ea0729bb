"""The zoo's DeepSeek-V3 decoder (``moonlight``) against the benchmark's
plain reference (``portbench/kinds/moonlight.py``) at a tiny size on the
CPU: hidden 64, 4 heads of 16 + 8 (values 16), a latent of 32, 8 routed
experts of which 4 are held, top-2, 2 shared, vocabulary 128, sequences
of 16, one dense and two sparse layers.

* float64: the loss, every leaf's gradient and a 3-step parameter change
  (the selection bias moving between the steps) agree to round-off.
* bfloat16 compute: a block's attention and a sparse layer, fed the same
  bfloat16 input, so that both route alike, agree within bounds that an
  fp8 attention or fp8 expert products break; the whole model's loss and
  gradient within looser bounds, which routing flips set (below).
* the expert share: the parts of a layer that the two halves of the
  experts give, the shared experts and attention counted once, add up to
  the uncut layer.
* the routing's static shapes, the flat layout, the ranges in backward,
  the routing counts in the trainer's records.

The card's test (``cuda``): the K-step graph equals the eager steps,
bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gtopkssgd_tpu_torch.convert import flat_layout, layer_names
from gtopkssgd_tpu_torch.models import moe
from gtopkssgd_tpu_torch.models.deepseek_v3 import DeepSeekV3
from gtopkssgd_tpu_torch.obs import tracing
from gtopkssgd_tpu_torch.trainer import Trainer, TrainConfig
from portbench.kinds import moonlight as ref
from portbench.reference import lowp, models

TINY = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "q_lora_rank": None, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "rope_theta": 50000,
    "intermediate_size": 96, "moe_intermediate_size": 16,
    "n_routed_experts": 4, "n_shared_experts": 2, "num_experts_per_tok": 2,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "rms_norm_eps": 1e-5, "vocab_size": 128,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "num_hidden_layers": 3,
    "seq_aux": True, "tie_word_embeddings": False, "attention_bias": False,
    "hidden_act": "silu", "aux_loss_alpha": 0.0001,
    "bias_update_speed": 0.001, "seq_len": 16, "zipf_a": 1.1,
    "deployment": {"n_routed_experts": 8, "first_held_expert": 0},
    "arch": {"kind": "moonlight"},
}
SEED = 2 ** 31 + 21


def _port(cfg=TINY, dtype=torch.float32, seed=SEED):
    m = DeepSeekV3(cfg, dtype=dtype)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m


def _batch(seed=SEED, b=4, cfg=TINY):
    host = ref.pool(cfg, seed, 0, 1, b)[0]
    return {k: torch.from_numpy(v).long() for k, v in host.items()}


def _port_loss(m, batch):
    logits, aux = m(batch["tokens"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["targets"].reshape(-1)) + aux


def _ref_params(m, dtype):
    named = dict(m.named_parameters())
    return {k: named[".".join(k)].detach().to(dtype).clone()
            .requires_grad_(True) for k in ref.shapes(TINY)}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def test_init_and_flat_layout_mirror_the_reference():
    m = _port()
    p = ref.init(TINY, SEED)
    named = dict(m.named_parameters())
    assert sorted(named) == sorted(".".join(k) for k in p)
    for k, v in p.items():
        assert torch.equal(named[".".join(k)], v), k
    order = models.flat_order(p, TINY)
    lay = flat_layout(m)
    assert layer_names(m) == ["/".join(k) for k, _ in order]
    assert all(perm == tuple(range(len(perm))) for _, perm in order)
    assert all(perm == tuple(range(len(perm))) for perm in lay.perms)
    assert [(n, o, s) for n, o, s in models.leaves(p, order)] == list(
        zip(layer_names(m), lay.offsets, lay.sizes))
    assert torch.equal(lay.ravel([t.detach() for t in lay.params]),
                       models.ravel(p, order))
    assert lay.n == sum(math.prod(s) for s in ref.shapes(TINY).values())


def test_float64_loss_gradients_and_three_steps_match_the_reference():
    """Round-off apart, float64 against float64: the loss to 1e-12, each
    leaf's gradient and the 3-step change (plain SGD, lr 0.5, the bias
    moved after every step on both sides) to 1e-9 of its norm. The
    routing is the same on both sides, so nothing but round-off
    differs."""
    m = _port().double()
    p0 = {k: v.detach().clone() for k, v in m.named_parameters()}
    ref.init(TINY, SEED)
    params = _ref_params(m, torch.float64)
    batch = _batch()
    for step in range(3):
        m.zero_grad()
        lp = _port_loss(m, batch)
        lp.backward()
        m.update_routing()
        rp = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        lr = ref.loss(TINY, rp, batch)
        lr.backward()
        assert abs(float(lp) - float(lr)) <= 1e-12 * abs(float(lr))
        for k, v in rp.items():
            assert _rel(dict(m.named_parameters())[".".join(k)].grad,
                        v.grad) < 1e-9, (step, k)
        with torch.no_grad():
            for name, t in m.named_parameters():
                t.sub_(0.5 * t.grad)
            params = {k: v.detach() - 0.5 * v.grad for k, v in rp.items()}
    for moe_layer, bias in zip(m.moe_layers(), ref._STATE["bias"]):
        assert torch.equal(moe_layer.router.score_bias, bias)
        assert float(bias.abs().max()) > 0
    for name, t in m.named_parameters():
        k = tuple(name.split("."))
        assert _rel(t.detach() - p0[name], params[k] - p0[name]) < 1e-9, k


def _fp8(t):
    return lowp.fp8(t.float()).to(t.dtype)


def _bf16_input(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).bfloat16()


# bfloat16 against the float32 reference, the same bfloat16 input on both
# sides: bfloat16 rounds to 2^-9 relative, and the parts' outputs and
# gradients go through several roundings in series (projections, RoPE,
# attention; the expert products, SiLU, the combine). Over input seeds
# 1-10 the largest gap of a part's output or gradient (norm of the
# difference over the reference's) read 0.0062-0.0075 for the attention
# and 0.0056-0.0080 for the sparse layer. fp8 e4m3 (2^-4 relative) in the
# attention's q, k and v alone read 0.038-0.050, in the expert products'
# operands alone 0.063-0.092. The bound sits 2.5x above the first and
# 1.9x under the second.
BF16_PART = 0.02


@pytest.mark.parametrize("low", [None, "attention"])
def test_bf16_attention_matches_the_reference(monkeypatch, low):
    """A block's attention (projections, RoPE, attention, output) at
    bfloat16 against the float32 reference, its output and every
    gradient within BF16_PART; with its attention's operands in fp8, the
    gap exceeds it."""
    if low:
        sdpa = F.scaled_dot_product_attention
        monkeypatch.setattr(
            F, "scaled_dot_product_attention",
            lambda q, k, v, **kw: sdpa(_fp8(q), _fp8(k), _fp8(v), **kw))
    m = _port(dtype=torch.bfloat16)
    attn = m.layers[1].attn
    x = _bf16_input(1, (1, 16, 64)).requires_grad_(True)
    out = attn(x)
    dout = _bf16_input(2, out.shape)
    out.backward(dout)
    params = _ref_params(m, torch.float32)
    xr = x.detach().float().requires_grad_(True)
    want = ref._attention(TINY, params, ("layers", "1"), xr[0],
                          models.identity)
    want.backward(dout[0].float())
    gaps = [_rel(out[0].float(), want), _rel(x.grad.float(), xr.grad)]
    for name, t in attn.named_parameters():
        gaps.append(_rel(t.grad, params[("layers", "1", "attn")
                                        + tuple(name.split("."))].grad))
    if low:
        assert max(gaps) > BF16_PART, gaps
    else:
        assert max(gaps) < BF16_PART, gaps


@pytest.mark.parametrize("low", [None, "experts"])
def test_bf16_sparse_layer_matches_the_reference(monkeypatch, low):
    """A sparse layer at bfloat16 against the float32 reference on the
    same bfloat16 input (the router's float32 scores are then the same,
    so both choose alike): the output and every gradient within
    BF16_PART; with the expert products' operands in fp8, the gap
    exceeds it."""
    if low:
        gmm = moe.grouped_mm
        monkeypatch.setattr(moe, "grouped_mm",
                            lambda a, b, offs, **kw: gmm(_fp8(a), _fp8(b), offs, **kw))
    m = _port(dtype=torch.bfloat16)
    layer = m.layers[2].mlp
    x = _bf16_input(3, (2, 16, 64)).requires_grad_(True)
    out, aux = layer(x)
    dout = _bf16_input(4, out.shape)
    (out.float() * dout.float()).sum().add(aux * 100.0).backward()
    params = _ref_params(m, torch.float32)
    gaps = []
    xr = x.detach().float().requires_grad_(True)
    for i in range(2):
        want, waux, _ = ref._moe(TINY, params, ("layers", "2"), xr[i],
                                 models.identity, torch.zeros(8))
        ((want * dout[i].float()).sum() + waux * 100.0 / 2).backward()
        gaps.append(_rel(out[i].float(), want))
    gaps.append(_rel(x.grad.float(), xr.grad))
    for name, t in layer.named_parameters():
        gaps.append(_rel(t.grad, params[("layers", "2", "mlp")
                                        + tuple(name.split("."))].grad))
    if low:
        assert max(gaps) > BF16_PART, gaps
    else:
        assert max(gaps) < BF16_PART, gaps


# The whole model at bfloat16 against the float32 reference: the residual
# stream is bfloat16, so the router sees inputs that differ by a rounding
# and a token whose scores nearly tie picks another expert (1 to 3 flips
# in 64 tokens x 2 layers here); a flip moves that token's share of an
# expert's gradient whole. The loss gap measured is 1e-4 to 3.1e-3 and the
# whole gradient's 0.012-0.053 (seeds 1-8); a flip-free part is held
# tightly above.
BF16_LOSS, BF16_GRAD = 0.01, 0.1


def test_bf16_whole_model_matches_the_reference():
    m = _port(dtype=torch.bfloat16)
    batch = _batch()
    loss = _port_loss(m, batch)
    loss.backward()
    lp = float(loss)
    ref.init(TINY, SEED)
    params = _ref_params(m, torch.float32)
    lr = float(ref.loss(TINY, params, batch))
    assert abs(lp - lr) / lr < BF16_LOSS
    named = dict(m.named_parameters())
    diff = sum(float((named[".".join(k)].grad - v.grad).pow(2).sum())
               for k, v in params.items())
    norm = sum(float(v.grad.pow(2).sum()) for v in params.values())
    assert math.sqrt(diff / norm) < BF16_GRAD


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Held experts {0-3} and {4-7} of 8: the two shares' block outputs,
    less what every chip computes alike (the residual, the attention and
    the shared experts) counted once, add up to the uncut reference block
    (all 8 held, the shares' experts in order) at float64."""
    shares = [_port(dict(TINY, deployment=dict(
        TINY["deployment"], first_held_expert=first))).double()
        for first in (0, 4)]
    x = torch.randn(1, 16, 64, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    outs = []
    with torch.no_grad():
        for m in shares:
            blk = m.layers[1]
            h = x + blk.attn(blk.attn_norm(x))
            outs.append((blk(x)[0], h + blk.mlp.shared(blk.mlp_norm(h))))
    uncut = dict(TINY, n_routed_experts=8)
    p = {}
    for (name, a), (_, b) in zip(shares[0].named_parameters(),
                                 shares[1].named_parameters()):
        k = tuple(name.split("."))
        p[k] = torch.cat([a, b]).detach() if "experts" in k else a.detach()
    want = ref._block(uncut, p, 1, models.identity,
                      torch.zeros(8, dtype=torch.float64))(x[0])[0]
    (a, common), (b, _) = outs
    assert _rel((a + b - common)[0], want) < 1e-12


def test_routing_has_static_shapes_and_drops_nothing():
    """Two routings, one that sends every pick to held experts and one
    that sends none: the same buffer sizes (T x top_k rows), offsets that
    end at the held pairs, nothing dropped. The dropped count is the
    router's held picks less the rows the products consumed, so a
    dispatch that loses a pair shows it."""
    layer = _port().layers[1].mlp
    t, k = 16, 2
    all_held = torch.arange(t * k).view(t, k) % 4
    none_held = 4 + torch.arange(t * k).view(t, k) % 4
    mixed = torch.tensor([[0, 5], [6, 3]] * 8)
    sizes = set()
    for pick in (all_held, none_held, mixed):
        order, pos, offs = layer.dispatch(pick)
        pairs = (pick < 4).sum()
        sizes.add((order.shape, pos.shape, offs.shape))
        assert int(offs[-1]) == int(pairs) == int((pick < 4).sum())
        assert torch.equal(torch.diff(offs, prepend=offs.new_zeros(1)),
                           torch.bincount(pick[pick < 4], minlength=4)
                           .int())
        kept = pos[pick < 4]
        assert sorted(kept.tolist()) == list(range(int(pairs)))
        assert bool((pos[pick >= 4] == t * k).all())
    assert sizes == {((t * k,), (t, k), (4,))}
    m = _port()
    m.train()
    _port_loss(m, _batch()).backward()
    counts = m.update_routing()
    assert float(counts[2]) == 0.0 and float(counts[0]) > 0
    for sparse in m.moe_layers():
        def lossy(pick, real=sparse.dispatch):
            order, pos, offs = real(pick)
            return order, pos, torch.minimum(offs, offs[-1] - 1)
        sparse.dispatch = lossy
    _port_loss(m, _batch()).backward()
    assert float(m.update_routing()[2]) == len(m.moe_layers())


def test_ranges_hold_backward_work():
    """Under the profiler on the CPU: each of "attention", "router" and
    "experts" is open around operators inside ``loss.backward()``, not
    only in the forward."""
    m = _port()
    batch = _batch(b=1)
    loss = _port_loss(m, batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test_backward"):
            loss.backward()
    evs = [e for e in prof.events()]
    lo = min(e.time_range.start for e in evs if e.name == "test_backward")
    for name in ("attention", "router", "experts"):
        spans = [e for e in evs if e.name == name and e.time_range.start
                 >= lo]
        assert spans, name
        inner = [e for e in evs if e.name.startswith("aten::") and any(
            s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end for s in spans)]
        assert inner, name


def test_the_trainer_reports_routing_counts(tmp_path):
    """Through ``Trainer.train``: the step's routing counts in the
    returned lists, the tracer's record (emptied when the trainer is
    built; no profiler recording) and the "spans" record; none dropped;
    a small cut trains (the dense exchange's loss falls)."""
    cfg = TrainConfig(dnn="moonlight", model_config=TINY, batch_size=2,
                      device="cpu", compression="dense", lr=0.05,
                      steps_per_dispatch=2, out_dir=str(tmp_path),
                      log_interval=2)
    tracing.routing.append((1.0, 1.0, 0.0, False))
    with Trainer(cfg) as t:
        assert not tracing.routing
        assert (t.kind, t.cfg.dataset, t.cfg.clip_grad_norm) == (
            "lm", "tokens", 1.0)
        assert t.num_params == flat_layout(t.model).n
        out = t.train(8)
        assert out["drop_counts"] == [0.0] * 8
        assert all(v > 0 for v in out["pair_counts"])
        assert all(1.0 <= v <= 4.0 for v in out["load_ratios"])
        assert list(tracing.routing) == [
            (a, b, c, False) for a, b, c in zip(out["pair_counts"],
                                                out["load_ratios"],
                                                out["drop_counts"])]
        assert np.mean(out["losses"][-2:]) < np.mean(out["losses"][:2])
        assert "val_loss" in t.test()
    import json
    spans = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")
             if '"spans"' in line]
    assert spans and all(s["routing/dropped"] == 0 for s in spans)
    assert all(s["routing/pairs"] > 0 for s in spans)


def test_token_dataset_is_seeded():
    from gtopkssgd_tpu_torch.data import get_dataset

    a = get_dataset("tokens", batch_size=2, seed=3, seq_len=16,
                    vocab_size=128)
    b = get_dataset("tokens", batch_size=2, seed=3, seq_len=16,
                    vocab_size=128)
    x, y = next(a.epoch(0)), next(b.epoch(0))
    assert x["tokens"].shape == (2, 16) and x["tokens"].dtype == np.int32
    assert np.array_equal(x["tokens"], y["tokens"])
    assert np.array_equal(x["tokens"][:, 1:], x["targets"][:, :-1])
    assert x["tokens"].min() >= 0 and x["tokens"].max() < 128
    with pytest.raises(ValueError):
        DeepSeekV3(dict(TINY, scoring_func="softmax"))


@pytest.mark.cuda
def test_graph_steps_equal_eager_steps_on_card():
    """On a card, bfloat16: 8 steps at K = 4 replay a captured graph
    (captured with host syncs made errors) and equal 8 eager steps
    bitwise: the losses, the routing counts (none dropped) and the whole
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = dict(dnn="moonlight", model_config=TINY, batch_size=2,
                device="cuda", compression="gtopk", density=0.01,
                topk_method="auto", dtype="bfloat16")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with Trainer(TrainConfig(**base)) as eager:
            want = eager.train(8)
            want_state = eager.checkpoint_state()
        with Trainer(TrainConfig(steps_per_dispatch=4, **base)) as graph:
            got = graph.train(8)
            got_state = graph.checkpoint_state()
            stats = graph.graph_stats
    finally:
        torch.use_deterministic_algorithms(False)
    assert got["dispatch"] == "graph" and stats["replays"] == 7
    assert got["drop_counts"] == [0.0] * 8
    for key in ("losses", "pair_counts", "load_ratios", "drop_counts"):
        assert got[key] == want[key], key
    for name, t in got_state.items():
        assert torch.equal(t, want_state[name]), name
