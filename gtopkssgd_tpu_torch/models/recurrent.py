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

``dtype`` is the cell's compute dtype (flax's ``OptimizedLSTMCell(dtype=)``):
the input, the carry and the concatenated weights are cast to it, and
cuDNN runs the whole recurrence in it (one dtype for all of its operands,
where flax keeps a float32 carry float32). On the card a bfloat16 LSTM
needs cuDNN's bfloat16 RNN (cuDNN 8.3 and compute capability 8.0 on);
without it the layer raises rather than compute in another dtype.

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

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.hidden = in_features, hidden
        self.compute_dtype = dtype
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
        """Zeros in the compute dtype on `like`'s device."""
        dtype = (like.dtype if self.compute_dtype == torch.float32
                 else self.compute_dtype)
        zeros = like.new_zeros(batch, self.hidden, dtype=dtype)
        return zeros, zeros.clone()

    def forward(self, x: torch.Tensor, carry: Optional[Carry] = None
                ) -> Tuple[torch.Tensor, Carry]:
        """x [B, T, in], carry (c, h) or None for zeros -> (outputs [B, T,
        H], the carry after the last frame), in the compute dtype."""
        dt = x.dtype if self.compute_dtype == torch.float32 else \
            self.compute_dtype
        x = x.to(dt)
        if (x.is_cuda and dt == torch.bfloat16
                and not bf16_cudnn_rnn(x.device)):
            raise RuntimeError(
                "a bfloat16 LSTM on the card needs cuDNN's bfloat16 RNN "
                "(cuDNN >= 8.3 on compute capability >= 8.0); this card "
                f"has cuDNN {torch.backends.cudnn.version()} and "
                f"capability {torch.cuda.get_device_capability(x.device)}")
        if carry is None:
            carry = self.initial_carry(x.shape[0], x)
        c, h = (t.to(dt) for t in carry)
        kernel, bias = self.kernel, self.bias
        weights = {
            "weight_ih_l0": torch.cat([kernel["i" + g] for g in GATES]
                                      ).to(dt),
            "weight_hh_l0": torch.cat([kernel["h" + g] for g in GATES]
                                      ).to(dt),
            "bias_ih_l0": x.new_zeros(4 * self.hidden),
            "bias_hh_l0": torch.cat([bias["h" + g] for g in GATES]).to(dt),
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


def bf16_cudnn_rnn(device: torch.device) -> bool:
    """Whether cuDNN runs a bfloat16 RNN on `device` (PyTorch's own rule
    for sending one to cuDNN: cuDNN 8.3 on, compute capability 8.0 on)."""
    version = torch.backends.cudnn.version() or 0
    return (torch.backends.cudnn.is_available()
            and torch.backends.cudnn.enabled and version >= 8300
            and torch.cuda.get_device_capability(device) >= (8, 0))


def reverse_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """i64[B, T]: position t of row b reads frame (L_b - 1 - t) mod T."""
    pos = torch.arange(t, device=lengths.device)
    return (lengths.long()[:, None] - 1 - pos[None, :]).remainder(t)


def gather_time(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [B, T, F] with row b's frames taken in the order index[b]."""
    return torch.gather(x, 1, index[:, :, None].expand(-1, -1, x.shape[2]))
