"""The sparse-expert layer of DeepSeek-V3 (arXiv:2412.19437, section 2.1.2)
as one chip of an expert-parallel deployment holds it.

``MoE`` routes every token over all ``router_experts`` (sigmoid scores in
float32, the selection bias ``score_bias`` added for the choice only,
top-``top_k``, the chosen scores renormalised and scaled by
``routed_scaling_factor``), computes the part of the result that its own
held experts give (``held`` consecutive expert ids from ``first``), adds
the shared experts, and keeps the step's loads for the bias update
(``update_routing``). Absent experts add nothing: their share of the
result lies on other chips, and nothing here stands in for them.

The held experts' part is dropless with static shapes, so a step holding
it can be captured in a CUDA graph: the (token, pick) pairs are sorted by
held expert (absent picks last) into a buffer of T x top_k rows, the
offsets of each expert's rows stay on the device (``torch.searchsorted``
on the sorted keys), and the products run as grouped products over those
offsets (``grouped_mm``: ``torch._grouped_mm`` on the card, a loop over
the experts on the CPU). Rows past the last held pair are never read:
each (token, pick) reads its row by its sorted position, an absent pick
a zero row. ``RoutedExperts`` saves only the layer's input and the
routing and recomputes the products in backward, so the T x top_k buffers
live one layer at a time.

Profiler ranges (``obs.tracing``), forward and backward: "router" (the
scores, the selection, the balance loss, the sort, the offsets, the
gather and the combine), "experts" (the grouped products).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.models.layers import Linear
from gtopkssgd_tpu_torch.obs.tracing import device_range, range_block


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor,
               trans_a: bool = False) -> torch.Tensor:
    """Per group g of rows (rows offs[g-1]..offs[g], offs[-1] = 0): with
    `b` 3-D, ``a_g @ b[g]`` (a [C, K], b [G, K, N] -> [C, N]; rows past
    offs[-1] are not written); with ``trans_a``, ``a_g^T @ b_g`` (a [C,
    K], b [C, N] -> [G, K, N]; a group without rows gives zeros). `offs`
    is int32 on the tensors' device. On the card ``torch._grouped_mm``;
    elsewhere a loop over the groups that reads the offsets to the
    host."""
    if a.is_cuda:
        if not trans_a:
            return torch._grouped_mm(a, b, offs=offs)
        out = torch._grouped_mm(a.t(), b, offs=offs)
        empty = torch.diff(offs, prepend=offs.new_zeros(1)) == 0
        return torch.where(empty[:, None, None], torch.zeros_like(out), out)
    ends = [0] + offs.tolist()
    if trans_a:
        return torch.stack([a[lo:hi].t() @ b[lo:hi]
                            for lo, hi in zip(ends, ends[1:])])
    out = a.new_zeros(a.shape[0], b.shape[-1])
    for g, (lo, hi) in enumerate(zip(ends, ends[1:])):
        out[lo:hi] = a[lo:hi] @ b[g]
    return out


class RoutedExperts(torch.autograd.Function):
    """The held experts' part of the layer for every token:
    out[t] = sum_j w[t, j] * E_{e(t, j)}(x[t]) over the picks j of token
    t whose expert is held, each E a SiLU-gated MLP, in x's dtype.

    x [T, H]; gate_up [E, 2F, H] (gate rows first) and down [E, H, F] in
    x's dtype; w [T, top_k] the picks' weights (float); order [C] the
    pairs (t * top_k + j) in sorted order; pos [T, top_k] each pick's
    sorted row (C: an absent pick, which reads a zero row); offs [E]
    int32 the experts' row ends. Everything runs in x's dtype, each
    product and sum accumulating in float32 and rounding once: the
    combine is a batched product of each token's weights and its picks'
    rows, the weights' gradient one of the rows and the output's
    gradient."""

    @staticmethod
    def forward(ctx, x, gate_up, down, w, order, pos, offs):
        ctx.save_for_backward(x, gate_up, down, w, order, pos, offs)
        y = _rows(x, gate_up, down, order, w.shape[1], offs)[2]
        with device_range("router"):
            return torch.bmm(w.to(x.dtype)[:, None, :], _pad(y)[pos])[:, 0]

    @staticmethod
    def backward(ctx, dout):
        x, gate_up, down, w, order, pos, offs = ctx.saved_tensors
        f, k = down.shape[-1], w.shape[1]
        xs, h, y = _rows(x, gate_up, down, order, k, offs)
        with device_range("router"):
            dout = dout.to(x.dtype).contiguous()
            dw = torch.bmm(_pad(y)[pos], dout[:, :, None])[..., 0]
            dy = dout[torch.div(order, k, rounding_mode="floor")]
            dy.mul_(w.flatten()[order].to(x.dtype)[:, None])
        with device_range("experts"):
            g, u = h[:, :f], h[:, f:]
            d_down = grouped_mm(F.silu(g) * u, dy, offs, trans_a=True)
            da = grouped_mm(dy, down, offs)
            dh = torch.cat([torch.ops.aten.silu_backward(da * u, g),
                            da * F.silu(g)], 1)
            d_gate_up = grouped_mm(xs, dh, offs, trans_a=True)
            dxs = grouped_mm(dh, gate_up, offs)
        with device_range("router"):
            dx = _pad(dxs)[pos].sum(1, dtype=torch.float32
                                    if x.dtype != torch.float64
                                    else torch.float64).to(x.dtype)
        return (dx, d_gate_up.transpose(1, 2), d_down.transpose(1, 2),
                dw.to(w.dtype), None, None, None)


def _pad(y: torch.Tensor) -> torch.Tensor:
    """y with a zero row appended, the row an absent pick reads."""
    return torch.cat([y, y.new_zeros(1, y.shape[1])])


def _rows(x, gate_up, down, order, k, offs):
    """(the gathered rows, the gate and up products, the expert outputs)
    of the sorted pairs."""
    with device_range("router"):
        xs = x[torch.div(order, k, rounding_mode="floor")]
    with device_range("experts"):
        h = grouped_mm(xs, gate_up.transpose(1, 2), offs)
        f = down.shape[-1]
        y = grouped_mm(F.silu(h[:, :f]) * h[:, f:], down.transpose(1, 2),
                       offs)
    return xs, h, y


class _SiluMul(torch.autograd.Function):
    """silu(g) * u; it saves g and u alone and recomputes silu(g) in
    backward, each op in the inputs' dtype (float32 inside the op)."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return F.silu(g) * u

    @staticmethod
    def backward(ctx, d):
        g, u = ctx.saved_tensors
        return (torch.ops.aten.silu_backward(d * u, g), d * F.silu(g))


class MLP(nn.Module):
    """down(silu(gate(x)) * up(x)): the dense layer and the shared
    experts."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = Linear(hidden, width, bias=False, device="meta")
        self.up_proj = Linear(hidden, width, bias=False, device="meta")
        self.down_proj = Linear(width, hidden, bias=False, device="meta")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(_SiluMul.apply(self.gate_proj(x),
                                             self.up_proj(x)))


class Experts(nn.Module):
    """The held experts' weights: ``gate_up`` [E, 2F, H] (each expert's
    gate rows, then its up rows) and ``down`` [E, H, F]."""

    def __init__(self, held: int, hidden: int, width: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(held, 2 * width, hidden,
                                                device="meta"))
        self.down = nn.Parameter(torch.empty(held, hidden, width,
                                             device="meta"))


class Router(nn.Module):
    """The gate's weight [router_experts, H]; its selection bias
    ``score_bias``, the step's loads ``load`` (from the picks) and the
    rows its products consumed ``consumed`` (from the sorted offsets) are
    buffers."""

    def __init__(self, experts: int, hidden: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, hidden,
                                               device="meta"))
        self.register_buffer("score_bias", torch.zeros(experts,
                                                       device="meta"))
        self.register_buffer("load", torch.zeros(experts, device="meta"))
        #: The step's rows the held experts' products consumed (each
        #: forward's last row end), counted apart from ``load``.
        self.register_buffer("consumed", torch.zeros((), device="meta"))


class MoE(nn.Module):
    """One sparse-expert layer's share (module docstring). `cfg` holds the
    published keys; ``held`` experts from ``first`` of ``router_experts``.
    ``forward(x)`` returns (output [B, S, H] in x's dtype, the sequence
    balance loss, a float32 scalar)."""

    def __init__(self, cfg: dict, router_experts: int, first: int,
                 held: int):
        super().__init__()
        hidden = cfg["hidden_size"]
        width = cfg["moe_intermediate_size"]
        self.router_experts, self.first, self.held = (router_experts, first,
                                                      held)
        self.top_k = cfg["num_experts_per_tok"]
        self.scaling = float(cfg["routed_scaling_factor"])
        self.norm_topk = bool(cfg["norm_topk_prob"])
        self.alpha = float(cfg["aux_loss_alpha"]) if cfg["seq_aux"] else 0.0
        self.router = Router(router_experts, hidden)
        self.experts = Experts(held, hidden, width)
        self.shared = MLP(hidden, width * cfg["n_shared_experts"])

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(weights [T, top_k] float, picks [T, top_k], balance loss) of x
        [B, S, H]; counts the step's loads while training."""
        b, s, _ = x.shape
        xf = x if x.dtype == torch.float64 else x.float()
        logits = F.linear(xf, self.router.weight.to(xf.dtype))
        scores = torch.sigmoid(logits)  # [B, S, R]
        pick = torch.topk(scores + self.router.score_bias.to(scores.dtype),
                          self.top_k, dim=-1).indices
        w = scores.gather(-1, pick)
        if self.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * self.scaling
        aux = scores.new_zeros(())
        if self.alpha:
            r, k = self.router_experts, self.top_k
            top = torch.topk(scores, k, dim=-1).indices
            f = torch.zeros_like(scores).scatter_(-1, top, 1.0).sum(1) * (
                r / (k * s))
            p = (scores / scores.sum(-1, keepdim=True)).mean(1)
            aux = self.alpha * (f * p).sum(-1).mean()
        if self.training:
            with torch.no_grad():
                chosen = torch.zeros_like(scores).scatter_(-1, pick, 1.0)
                self.router.load.add_(chosen.sum((0, 1)).to(
                    self.router.load.dtype))
        return w.reshape(b * s, -1), pick.reshape(b * s, -1), aux

    def dispatch(self, pick: torch.Tensor):
        """(order [C], pos [T, top_k], offs [E] int32) of picks [T,
        top_k]: the pairs sorted by held expert, stable, absent picks last
        (C = T x top_k rows, whatever the routing)."""
        t, k = pick.shape
        local = pick - self.first
        held = (local >= 0) & (local < self.held)
        key = torch.where(held, local, torch.full_like(local, self.held))
        keys, order = torch.sort(key.flatten(), stable=True)
        offs = torch.searchsorted(keys, torch.arange(
            1, self.held + 1, device=keys.device)).to(torch.int32)
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        pos = torch.where(held.flatten(), pos,
                          torch.full_like(pos, order.numel())).view(t, k)
        return order, pos, offs

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, h = x.shape

        def router(x):
            w, pick, aux = self.route(x)
            order, pos, offs = self.dispatch(pick)
            if self.training:
                with torch.no_grad():
                    self.router.consumed.add_(
                        offs[-1].to(self.router.consumed.dtype))
            return w, aux, order, pos, offs

        w, aux, order, pos, offs = range_block("router", router, x)
        ex = self.experts
        routed = RoutedExperts.apply(
            x.reshape(b * s, h), ex.gate_up.to(x.dtype), ex.down.to(x.dtype),
            w, order, pos, offs).view(b, s, h)
        return routed + self.shared(x), aux

    @torch.no_grad()
    def update_routing(self, speed: float) -> torch.Tensor:
        """After a step: move each expert's selection bias by `speed`
        toward balance (up for a load under the mean, down over it), and
        return (held pairs, the held experts' largest load over their
        mean, dropped pairs) of the step; the step's counts restart. The
        held pairs are the router's picks of held experts (``load``); the
        dropped ones, those of them that the products did not consume
        (``consumed``, read off the sort's offsets)."""
        r = self.router
        load = r.load
        r.score_bias.add_(speed * torch.sign(load.sum() - load.numel()
                                             * load).to(r.score_bias.dtype))
        held = load[self.first:self.first + self.held]
        pairs = held.sum()
        ratio = held.max() * self.held / torch.clamp(pairs, min=1.0)
        out = torch.stack([pairs, ratio, pairs - r.consumed.to(pairs.dtype)])
        load.zero_()
        r.consumed.zero_()
        return out


def held_range(cfg: dict) -> Tuple[int, int, int]:
    """(router experts, first held id, held count) of a configuration: the
    published count in ``deployment`` where the file cuts the experts to
    one chip's share, else every expert held."""
    dep: Optional[dict] = cfg.get("deployment")
    held = cfg["n_routed_experts"]
    if not dep:
        return held, 0, held
    return (dep["n_routed_experts"], dep.get("first_held_expert", 0),
            held)
