"""The precision control: the reference's operands rounded to the
nearest precision below the configuration's. Below bfloat16 lies fp8:
each operand of a convolution or dense layer is scaled so that its
largest magnitude maps to e4m3's largest finite value (448), rounded to
float8_e4m3fn and scaled back. The rounding is the forward's; the
backward passes the gradient through it unchanged (a straight-through
estimator), so the backward's products see the rounded operands."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


QUANT = {"float32": None, "fp8": fp8}
