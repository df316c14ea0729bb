"""DeepSeek-V3's decoder (arXiv:2412.19437, section 2.1), the model of the
zoo's ``moonlight`` entry (Moonlight-16B-A3B,
https://huggingface.co/moonshotai/Moonlight-16B-A3B, ``model_type``
deepseek_v3), from a configuration of the published keys.

Token embedding; ``num_hidden_layers`` blocks, each RMSNorm ->
multi-head latent attention -> residual, RMSNorm -> MLP -> residual (a
dense SiLU-gated MLP for the first ``first_k_dense_replace`` blocks, the
sparse-expert layer ``models.moe.MoE`` after them); a final RMSNorm and
an untied head over the vocabulary. ``forward(tokens)`` returns (logits
f32[B, S, V], the summed sequence balance loss).

Multi-head latent attention without a query compression (``q_lora_rank``
null): q = W_q x split per head into a 128-wide part and a 64-wide RoPE
part; W_kva x gives the 512-wide latent c (RMSNorm'ed, eps 1e-6, as the
published code) and one 64-wide RoPE key k_pe shared by every head;
W_kvb c gives each head's 128-wide key part and 128-wide value; causal
softmax attention with scale 1/sqrt(192); W_o over the heads' values.
RoPE rotates adjacent pairs (2i, 2i+1) by position x theta^(-2i/64),
computed in float32 and rounded once.

Compute follows ``models.layers``: the parameters stay float32 and each
``Linear`` computes in its input's dtype (``dtype``, bfloat16 in the
benchmark); RMSNorm computes in float32 and rounds its output once; the
router's scores are float32 (``models.moe``); attention is
``F.scaled_dot_product_attention``; the logits come back in float32.

The cut to one chip's share of a deployment (``deployment`` in the
configuration): ``n_routed_experts`` experts held of the router's
``deployment.n_routed_experts``, a vocabulary of ``vocab_size`` (a
slice), ``num_hidden_layers`` blocks. The parameters' paths are the
module names split at dots, and the flat gradient is laid out in the
port's own layout (``own_layout``): paths sorted, each leaf as it is.

Profiler ranges, forward and backward (``obs.tracing.range_block``):
"attention" (the projections, RoPE, the attention and the output
projection), "router" and "experts" (``models.moe``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.models.layers import (
    Linear,
    float_logits,
    lecun_normal_,
    to_compute,
)
from gtopkssgd_tpu_torch.models.moe import MLP, MoE, held_range
from gtopkssgd_tpu_torch.obs.tracing import range_block

KV_NORM_EPS = 1e-6
# A part computed wider than bfloat16: float32, or float64 as it is.
_wide = float_logits


class _RMSNorm(torch.autograd.Function):
    """x / sqrt(mean(x^2) + eps) * w in float32 (float64 for float64),
    rounded once to x's dtype; it saves x and the row scales, not the
    float32 copies, and recomputes the normalised rows in backward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        xf = _wide(x)
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (xf * rstd * weight.to(xf.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        xf = _wide(x)
        y = xf * rstd
        g = _wide(dy) * weight.to(xf.dtype)
        dw = (_wide(dy) * y).reshape(-1, y.shape[-1]).sum(0)
        dx = rstd * (g - y * (g * y).mean(-1, keepdim=True))
        return dx.to(x.dtype), dw.to(weight.dtype), None


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(width, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _RMSNorm.apply(x, self.weight, self.eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, d] with each adjacent pair (2i, 2i+1) rotated by
    angle position * theta^(-2i/d), in float32 (float64 for float64),
    rounded once to x's dtype."""
    s, d = x.shape[1], x.shape[-1]
    xf = _wide(x)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    ang = torch.outer(torch.arange(s, device=x.device,
                                   dtype=torch.float32), inv)
    cos = torch.cos(ang).to(xf.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(xf.dtype)[None, :, None, :]
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       -1).flatten(-2).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("q_lora_rank"):
            raise ValueError("MLA with a query compression (q_lora_rank) "
                             "is not implemented")
        if cfg.get("rope_scaling"):
            raise ValueError("rope_scaling is not implemented")
        h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope_dim = cfg["qk_rope_head_dim"]
        self.v_dim = cfg["v_head_dim"]
        self.rank = cfg["kv_lora_rank"]
        self.theta = float(cfg["rope_theta"])
        qk = self.nope + self.rope_dim
        self.scale = qk ** -0.5
        self.q_proj = Linear(h, self.heads * qk, bias=False, device="meta")
        self.kv_a_proj = Linear(h, self.rank + self.rope_dim, bias=False,
                                device="meta")
        self.kv_norm = RMSNorm(self.rank, KV_NORM_EPS)
        self.kv_b_proj = Linear(self.rank, self.heads * (self.nope
                                                         + self.v_dim),
                                bias=False, device="meta")
        self.o_proj = Linear(self.heads * self.v_dim, h, bias=False,
                             device="meta")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.heads, -1)
        q_nope, q_pe = q.split([self.nope, self.rope_dim], -1)
        kv, k_pe = self.kv_a_proj(x).split([self.rank, self.rope_dim], -1)
        kv = self.kv_b_proj(self.kv_norm(kv)).view(b, s, self.heads, -1)
        k_nope, v = kv.split([self.nope, self.v_dim], -1)
        k_pe = rope(k_pe[:, :, None, :], self.theta)
        q = torch.cat([q_nope, rope(q_pe, self.theta)], -1)
        k = torch.cat([k_nope, k_pe.expand(-1, -1, self.heads, -1)], -1)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, -1))


class Block(nn.Module):
    def __init__(self, cfg: dict, dense: bool):
        super().__init__()
        eps = cfg["rms_norm_eps"]
        h = cfg["hidden_size"]
        self.attn_norm = RMSNorm(h, eps)
        self.attn = MLA(cfg)
        self.mlp_norm = RMSNorm(h, eps)
        if dense:
            self.mlp = MLP(h, cfg["intermediate_size"])
        else:
            self.mlp = MoE(cfg, *held_range(cfg))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + range_block("attention", self.attn, self.attn_norm(x))
        y = self.mlp(self.mlp_norm(x))
        if isinstance(y, tuple):
            return x + y[0], y[1]
        return x + y, None


class DeepSeekV3(nn.Module):
    """The decoder of `config` (the published keys and the cut, module
    docstring), computing in `dtype`."""

    #: The flat gradient is laid out by the module paths, leaves as they
    #: are (``convert.flat_layout``): there is no flax twin.
    own_layout = True

    def __init__(self, config: dict, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        for key, want in (("scoring_func", "sigmoid"),
                          ("topk_method", "noaux_tc"), ("n_group", 1),
                          ("topk_group", 1), ("hidden_act", "silu"),
                          ("moe_layer_freq", 1)):
            if cfg.get(key, want) != want:
                raise ValueError(f"{key}={cfg[key]!r} is not implemented "
                                 f"(only {want!r})")
        if cfg.get("tie_word_embeddings") or cfg.get("attention_bias"):
            raise ValueError("tied embeddings and attention biases are not "
                             "implemented")
        self.dtype = dtype
        self.config = cfg
        self.bias_speed = float(cfg["bias_update_speed"])
        h, v = cfg["hidden_size"], cfg["vocab_size"]
        self.embed = nn.Embedding(v, h, device="meta")
        self.layers = nn.ModuleList(
            Block(cfg, i < cfg["first_k_dense_replace"])
            for i in range(cfg["num_hidden_layers"]))
        self.norm = RMSNorm(h, cfg["rms_norm_eps"])
        self.head = Linear(h, v, bias=False, device="meta")
        self.to_empty(device="cpu")
        self._zero_buffers()

    def moe_layers(self):
        return [blk.mlp for blk in self.layers if isinstance(blk.mlp, MoE)]

    def _zero_buffers(self) -> None:
        for buf in self.buffers():
            buf.zero_()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Norm weights 1; every other leaf LeCun normal over its input
        width (its last dimension; an expert's own), truncated at two
        standard deviations, drawn from `generator` leaf by leaf in the
        order of their sorted paths; the routing buffers zero."""
        for path, p in sorted((tuple(n.split(".")), p)
                              for n, p in self.named_parameters()):
            if "norm" in path[-2]:
                p.fill_(1.0)
                continue
            lecun_normal_(p, p.shape[-1], generator)
        self._zero_buffers()

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = to_compute(F.embedding(tokens, self.embed.weight), self.dtype)
        aux = None
        for blk in self.layers:
            x, a = blk(x)
            if a is not None:
                aux = a if aux is None else aux + a
        logits = float_logits(self.head(self.norm(x)))
        if aux is None:
            aux = logits.new_zeros(())
        return logits, aux

    @torch.no_grad()
    def update_routing(self) -> torch.Tensor:
        """After a step: each sparse layer's bias update
        (``MoE.update_routing``); returns the step's (held pairs summed
        over the layers, the largest load ratio of any layer, dropped
        pairs summed), float32 on the model's device."""
        rows = [m.update_routing(self.bias_speed) for m in self.moe_layers()]
        if not rows:
            return self.head.weight.new_zeros(3, dtype=torch.float32)
        t = torch.stack(rows).float()
        return torch.stack([t[:, 0].sum(), t[:, 1].max(), t[:, 2].sum()])
