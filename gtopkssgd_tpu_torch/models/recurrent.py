"""The LSTM layer both recurrent models share: the twin of flax's
``nn.RNN`` over an ``OptimizedLSTMCell``, run by cuDNN's LSTM.

The cell keeps flax's eight parameters as separate tensors, named as flax
names them: input kernels ``ii if ig io`` (no bias) and hidden kernels
``hi hf hg ho`` with biases. ``ravel_pytree`` lays the flat gradient out
parameter by parameter in the order of those names, so a packed
``weight_ih_l0`` would put the gates in other places of the flat vector
and the top-k buckets would select other coordinates. Kernels are stored
(out, in), as ``nn.Linear`` stores them; ``convert`` transposes them to
flax's (in, out).

The forward pass concatenates the gates in the order i, f, g, o (flax's
and torch's alike) into ``weight_ih`` [4H, in], ``weight_hh`` [4H, H],
``bias_hh`` [4H] with ``bias_ih`` = 0, and calls ``nn.LSTM`` on them with
``torch.func.functional_call``: the template ``nn.LSTM`` lives on the meta
device and owns no storage; autograd returns the gradients to the eight
parameters through the concatenation.

flax carries (c, h); torch carries (h, c). The layer takes and returns
flax's order.

``reverse_index(lengths, t)`` is flax's ``flip_sequences`` as an index:
position t of a row of length L reads frame (L - 1 - t) mod T, so the
valid frames run reversed and then the padding reversed; the same gather
puts the outputs back in order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

GATES = ("i", "f", "g", "o")
Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [B, H]


class LSTM(nn.Module):
    """One unidirectional LSTM layer over [B, T, in] (batch first)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.in_features, self.hidden = in_features, hidden
        self.kernel = nn.ParameterDict()
        for g in GATES:
            self.kernel["i" + g] = nn.Parameter(
                torch.zeros(hidden, in_features))
        for g in GATES:
            self.kernel["h" + g] = nn.Parameter(torch.zeros(hidden, hidden))
        self.bias = nn.ParameterDict(
            {"h" + g: nn.Parameter(torch.zeros(hidden)) for g in GATES})
        # Not a submodule: its parameters are never the model's.
        object.__setattr__(self, "_template", nn.LSTM(
            in_features, hidden, batch_first=True, device="meta"))

    def initial_carry(self, batch: int, like: torch.Tensor) -> Carry:
        zeros = like.new_zeros(batch, self.hidden)
        return zeros, zeros.clone()

    def forward(self, x: torch.Tensor, carry: Optional[Carry] = None
                ) -> Tuple[torch.Tensor, Carry]:
        """x f32[B, T, in], carry (c, h) or None for zeros ->
        (outputs f32[B, T, H], the carry after the last frame)."""
        if carry is None:
            carry = self.initial_carry(x.shape[0], x)
        c, h = carry
        kernel, bias = self.kernel, self.bias
        weights = {
            "weight_ih_l0": torch.cat([kernel["i" + g] for g in GATES]),
            "weight_hh_l0": torch.cat([kernel["h" + g] for g in GATES]),
            "bias_ih_l0": x.new_zeros(4 * self.hidden),
            "bias_hh_l0": torch.cat([bias["h" + g] for g in GATES]),
        }
        self._template.training = self.training
        out, (h_n, c_n) = torch.func.functional_call(
            self._template, weights,
            (x, (h[None].contiguous(), c[None].contiguous())))
        return out, (c_n[0], h_n[0])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers for the cell: LeCun-normal input kernels
        (truncated normal, variance 1/in), orthogonal hidden kernels, zero
        biases."""
        std = math.sqrt(1.0 / self.in_features) / 0.87962566103423978
        with torch.no_grad():
            for g in GATES:
                nn.init.trunc_normal_(self.kernel["i" + g], 0.0, std,
                                      -2 * std, 2 * std, generator=generator)
                nn.init.orthogonal_(self.kernel["h" + g],
                                    generator=generator)
                self.bias["h" + g].zero_()


def reverse_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """i64[B, T]: position t of row b reads frame (L_b - 1 - t) mod T."""
    pos = torch.arange(t, device=lengths.device)
    return (lengths.long()[:, None] - 1 - pos[None, :]).remainder(t)


def gather_time(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [B, T, F] with row b's frames taken in the order index[b]."""
    return torch.gather(x, 1, index[:, :, None].expand(-1, -1, x.shape[2]))
