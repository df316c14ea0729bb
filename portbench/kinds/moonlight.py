"""Moonlight-16B-A3B (``model_type`` deepseek_v3): DeepSeek-V3's decoder
(arXiv:2412.19437, section 2.1) as one chip of an expert-parallel
deployment holds it, on packed token sequences.

The published forward pass, in plain PyTorch at the parameters' dtype
(float32 in the harness, TF32 off; float64 in the tests): token
embedding; blocks of x + MLA(RMSNorm(x)) then x + MLP(RMSNorm(x)), the
first ``first_k_dense_replace`` MLPs dense and SiLU-gated, the rest
sparse-expert layers; a final RMSNorm and an untied head. RMSNorm:
x / sqrt(mean(x^2) + eps) * w, eps ``rms_norm_eps``, 1e-6 for the
latent's norm (the published code's default). Attention without a query
compression: q = W_q x, per head a 128-wide part and a 64-wide part
rotated by RoPE (adjacent pairs (2i, 2i+1) by position *
theta^(-2i/64), the angles in float32); [c, k_pe] = W_kva x, the latent c
RMSNorm'ed; [k_nope, v] = W_kvb c per head; k = [k_nope, rope(k_pe)]
with k_pe shared by the heads; explicit softmax(q k^T / sqrt(192)) with a
causal mask over the whole packed sequence (no mask between documents);
W_o over the heads' values. The sparse layer: scores s = sigmoid(W_r x)
over all ``deployment.n_routed_experts`` experts in float32; the
top-``num_experts_per_tok`` of s + b (the selection bias b chooses and
weighs nothing); the chosen scores over their sum times
``routed_scaling_factor``; the held experts (``n_routed_experts`` from
``deployment.first_held_expert``) in a loop, each a SiLU-gated MLP of
width ``moe_intermediate_size`` over the tokens that chose it, times
their weights; plus the ``n_shared_experts`` shared experts as one MLP of
their summed width. The sequence-wise balance loss (eqs. 17-20), per
layer and sequence: alpha * sum_i f_i P_i, f_i = R / (K S) * #{t: s_it in
TopK(s_t)}, P_i = mean_t s_it / sum_j s_jt; its mean over the sequences,
summed over the layers, is added to the mean next-token cross-entropy
over the vocabulary slice.

Departures from the published description, each also in the program:
the absent experts' part is left out (another chip's); the vocabulary is
a slice (ids drawn from it; logits and loss over it); the layers past
``num_hidden_layers`` are further pipeline stages; the selection bias
moves by ``bias_update_speed`` (gamma) toward balance after each step,
up for an expert whose load over the step's tokens lies under the mean,
down over it, the loads counted on the biased choice; alpha and gamma
come from the paper, not the configuration.

How it is computed, which the description does not fix: sequence by
sequence, each sequence's loss backward at once and the gradients
summed, every block under ``torch.utils.checkpoint``, so the float32
attention of one sequence and one block is what lives at a time; then
the optimizer's clip (``train_config.clip_grad_norm``: the gradients
times min(1, c / (||g|| + 1e-6))), as the program clips before it
selects. So ``loss`` leaves the gradients in the parameters' ``.grad``
and returns the loss through an identity whose backward adds nothing.
The selection bias is the module's state between the calls of one run:
``init`` zeroes it, each ``loss`` call routes with it and moves it after
(one worker: the moves of P workers' shared loads are not followed).

Parameters by the port's module paths split at dots, PyTorch's layouts,
laid out in the flat gradient as they are (``flat_perm``): LeCun normal
over each leaf's last dimension, truncated at two standard deviations,
drawn from one CPU generator leaf by leaf in sorted path order; norm
weights 1.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.models import Params, identity

POOL_STREAM = 0x70C5
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2
KV_NORM_EPS = 1e-6

# The selection biases of the sparse layers between the calls of a run.
_STATE: Dict[str, List[torch.Tensor]] = {"bias": []}


def held(config: Dict) -> Tuple[int, int, int]:
    """(router experts, first held id, held count)."""
    dep = config.get("deployment") or {}
    n = config["n_routed_experts"]
    return dep.get("n_routed_experts", n), dep.get("first_held_expert", 0), n


def pool(config: Dict, seed: int, rank: int, count: int, batch: int
         ) -> List[Dict[str, np.ndarray]]:
    """`count` batches of `batch` sequences: seq_len + 1 ids drawn
    Zipf(``zipf_a``) over the vocabulary slice (rank r is id r - 1, ranks
    past the slice clipped to its last id), tokens the first seq_len and
    targets the last, int32; a pure function of (seed, rank)."""
    s, v = int(config["seq_len"]), int(config["vocab_size"])
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(rank), POOL_STREAM]))
    ids = (np.minimum(rng.zipf(float(config["zipf_a"]),
                               (count, batch, s + 1)), v) - 1).astype(
        np.int32)
    return [{"tokens": ids[i, :, :-1], "targets": ids[i, :, 1:]}
            for i in range(count)]


def shapes(config: Dict) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Each parameter's path and shape."""
    c = config
    h, v = c["hidden_size"], c["vocab_size"]
    nh, nope, rd, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"])
    rank = c["kv_lora_rank"]
    r, _, e = held(c)
    out = {("embed", "weight"): (v, h), ("head", "weight"): (v, h),
           ("norm", "weight"): (h,)}
    for i in range(c["num_hidden_layers"]):
        pre = ("layers", str(i))
        out[pre + ("attn_norm", "weight")] = (h,)
        out[pre + ("mlp_norm", "weight")] = (h,)
        a = pre + ("attn",)
        out[a + ("q_proj", "weight")] = (nh * (nope + rd), h)
        out[a + ("kv_a_proj", "weight")] = (rank + rd, h)
        out[a + ("kv_norm", "weight")] = (rank,)
        out[a + ("kv_b_proj", "weight")] = (nh * (nope + vd), rank)
        out[a + ("o_proj", "weight")] = (h, nh * vd)
        m = pre + ("mlp",)
        if i < c["first_k_dense_replace"]:
            mlps = [(m, c["intermediate_size"])]
        else:
            f = c["moe_intermediate_size"]
            out[m + ("router", "weight")] = (r, h)
            out[m + ("experts", "gate_up")] = (e, 2 * f, h)
            out[m + ("experts", "down")] = (e, h, f)
            mlps = [(m + ("shared",), f * c["n_shared_experts"])]
        for pre_m, width in mlps:
            out[pre_m + ("gate_proj", "weight")] = (width, h)
            out[pre_m + ("up_proj", "weight")] = (width, h)
            out[pre_m + ("down_proj", "weight")] = (h, width)
    return out


def init(config: Dict, seed: int) -> Params:
    gen = torch.Generator().manual_seed(int(seed))
    p: Params = {}
    for path, shape in sorted(shapes(config).items()):
        if "norm" in path[-2]:
            p[path] = torch.ones(shape)
            continue
        std = math.sqrt(1.0 / shape[-1]) / TRUNC
        w = torch.empty(shape)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        p[path] = w
    r = held(config)[0]
    moe = config["num_hidden_layers"] - config["first_k_dense_replace"]
    _STATE["bias"] = [torch.zeros(r) for _ in range(moe)]
    return p


def flat_perm(path, dims: int) -> Tuple[int, ...]:
    return tuple(range(dims))


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, d]: adjacent pairs rotated, the angles in float32."""
    s, d = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device=x.device),
                      inv)
    cos, sin = (f(ang).to(x.dtype)[:, None, :] for f in (torch.cos,
                                                         torch.sin))
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).flatten(-2)


def _mm(x, w, quant):
    return F.linear(quant(x), quant(w))


def _mlp(x, p, pre, quant):
    g = _mm(x, p[pre + ("gate_proj", "weight")], quant)
    u = _mm(x, p[pre + ("up_proj", "weight")], quant)
    return _mm(F.silu(g) * u, p[pre + ("down_proj", "weight")], quant)


def _attention(c: Dict, p: Params, pre, x, quant):
    s = x.shape[0]
    nh, nope, rd, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"])
    rank, theta = c["kv_lora_rank"], float(c["rope_theta"])
    a = pre + ("attn",)
    q = _mm(x, p[a + ("q_proj", "weight")], quant).view(s, nh, nope + rd)
    kv = _mm(x, p[a + ("kv_a_proj", "weight")], quant)
    lat, k_pe = kv[:, :rank], kv[:, rank:]
    lat = _norm(lat, p[a + ("kv_norm", "weight")], KV_NORM_EPS)
    kv = _mm(lat, p[a + ("kv_b_proj", "weight")], quant).view(s, nh,
                                                               nope + vd)
    k = torch.cat([kv[..., :nope],
                   _rope(k_pe[:, None, :], theta).expand(s, nh, rd)], -1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], -1)
    v = kv[..., nope:]
    scores = torch.einsum("shd,thd->hst", quant(q), quant(k)) / math.sqrt(
        nope + rd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    att = torch.softmax(scores.masked_fill(mask, float("-inf")), -1)
    o = torch.einsum("hst,thd->shd", quant(att), quant(v)).reshape(s, -1)
    return _mm(o, p[a + ("o_proj", "weight")], quant)


def _moe(c: Dict, p: Params, pre, x, quant, bias):
    """(output, balance loss, the chosen experts' counts [R]) of one
    sequence x [S, H]."""
    s = x.shape[0]
    r, first, e = held(c)
    k = c["num_experts_per_tok"]
    m = pre + ("mlp",)
    scores = torch.sigmoid(F.linear(x, p[m + ("router", "weight")]))
    pick = torch.topk(scores + bias.to(scores.dtype), k, -1).indices
    w = scores.gather(-1, pick)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * float(c["routed_scaling_factor"])
    out = _mlp(x, p, m + ("shared",), quant)
    gu, down = p[m + ("experts", "gate_up")], p[m + ("experts", "down")]
    f = down.shape[-1]
    for j in range(e):
        tok, slot = torch.nonzero(pick == first + j, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = _mm(x[tok], gu[j], quant)
        y = _mm(F.silu(h[:, :f]) * h[:, f:], down[j], quant)
        out = out.index_add(0, tok, y * w[tok, slot, None])
    aux = x.new_zeros(())
    if c["seq_aux"]:
        top = torch.topk(scores, k, -1).indices
        fi = torch.zeros_like(scores).scatter_(-1, top, 1.0).sum(0) * (
            r / (k * s))
        pi = (scores / scores.sum(-1, keepdim=True)).mean(0)
        aux = float(c["aux_loss_alpha"]) * (fi * pi).sum()
    counts = torch.zeros_like(scores).scatter_(-1, pick, 1.0).sum(0)
    return out, aux, counts.detach()


def _block(c: Dict, p: Params, i: int, quant, bias):
    """Block i as a function of x [S, H]: (x out, balance loss, counts)."""
    pre = ("layers", str(i))
    eps = c["rms_norm_eps"]

    def run(x):
        x = x + _attention(c, p, pre, _norm(x, p[pre + ("attn_norm",
                                                        "weight")], eps),
                           quant)
        y = _norm(x, p[pre + ("mlp_norm", "weight")], eps)
        if i < c["first_k_dense_replace"]:
            return x + _mlp(y, p, pre + ("mlp",), quant), None, None
        out, aux, counts = _moe(c, p, pre, y, quant, bias)
        return x + out, aux, counts

    return run


def _sequence(c: Dict, p: Params, tokens, targets, quant, biases):
    """(loss of one sequence, each sparse layer's counts)."""
    x = p[("embed", "weight")][tokens]
    aux, counts = x.new_zeros(()), []
    moe = 0
    for i in range(c["num_hidden_layers"]):
        bias = biases[moe] if i >= c["first_k_dense_replace"] else None
        x, a, n = checkpoint(_block(c, p, i, quant, bias), x,
                             use_reentrant=False)
        if a is not None:
            aux, moe = aux + a, moe + 1
            counts.append(n)
    x = _norm(x, p[("norm", "weight")], c["rms_norm_eps"])
    logits = _mm(x, p[("head", "weight")], quant)
    return F.cross_entropy(logits, targets) + aux, counts


class _Done(torch.autograd.Function):
    """The loss's value; its backward adds nothing (``loss`` has already
    put the gradients in place)."""

    @staticmethod
    def forward(ctx, value, leaf):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return None, None


def loss(config: Dict, params: Params, batch: Dict, quant: Callable = identity,
         gen=None) -> torch.Tensor:
    """The batch's loss with its gradients already in ``.grad``, clipped
    (module docstring); the selection bias moves after."""
    c = config
    tokens, targets = batch["tokens"].long(), batch["targets"].long()
    b = tokens.shape[0]
    leaves = list(params.values())
    biases = [t.to(tokens.device, leaves[0].dtype) for t in _STATE["bias"]]
    total = torch.zeros((), dtype=leaves[0].dtype, device=tokens.device)
    loads = [torch.zeros_like(t) for t in biases]
    for i in range(b):
        value, counts = _sequence(c, params, tokens[i], targets[i], quant,
                                  biases)
        (value / b).backward()
        total = total + value.detach() / b
        loads = [a + n for a, n in zip(loads, counts)]
    clip = (c.get("train_config") or {}).get("clip_grad_norm")
    if clip is not None:
        grads = [t.grad for t in leaves if t.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
    speed = float(c["bias_update_speed"])
    _STATE["bias"] = [(bias + speed * torch.sign(load.sum() - load.numel()
                                                 * load)).cpu()
                      for bias, load in zip(biases, loads)]
    return _Done.apply(total, leaves[0])


def forward_macs(config: Dict) -> int:
    """Multiply-adds of one sequence's forward pass: per token the
    attention's projections, the dense MLP, each sparse layer's router,
    shared experts and routed experts at their expected held share
    (``num_experts_per_tok`` x held / router experts picks a token, at
    three products of width ``moe_intermediate_size``), and the head; and
    per layer the causal attention at half of S^2 (q k^T over the 192-wide
    heads, the weights times the 128-wide values). The embedding's lookup
    and the elementwise work are not counted."""
    c = config
    h, s = c["hidden_size"], c["seq_len"]
    nh, nope, rd, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"])
    rank, f = c["kv_lora_rank"], c["moe_intermediate_size"]
    r, _, e = held(c)
    layers, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    sparse = layers - dense
    proj = (h * nh * (nope + rd) + h * (rank + rd) + rank * nh * (nope + vd)
            + nh * vd * h)
    per_token = (layers * proj + dense * 3 * h * c["intermediate_size"]
                 + sparse * (h * r + 3 * h * f * c["n_shared_experts"])
                 + h * c["vocab_size"])
    routed = sparse * c["num_experts_per_tok"] * e * 3 * h * f  # times 1/r
    attention = layers * nh * (nope + rd + vd) * s * s // 2
    return s * per_token + s * routed // r + attention
