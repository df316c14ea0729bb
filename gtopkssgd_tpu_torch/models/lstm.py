"""The 2-layer LSTM language model for PTB, the port of
``gtopkssgd_tpu/models/lstm.py`` (Zaremba et al.'s "medium" LM):
embedding, dropout, two LSTM layers each followed by dropout (the last
one included, so this is not ``nn.LSTM(num_layers=2, dropout=p)``, which
skips it), and a dense softmax layer over the vocabulary.

``forward(tokens, carry)`` returns (logits f32[B, T, vocab], new carry);
the carry is one (c, h) pair of [B, hidden] per layer, flax's order, in
the compute dtype ``dtype`` (the JAX model makes it so). The trainer
threads it through consecutive windows and detaches it between steps.
Under ``dtype`` the embedding table, the cells and the dense layer
compute in it (``models.layers``); the logits come back in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

import torch.nn.functional as F

from gtopkssgd_tpu_torch.models.layers import (
    Dropout,
    Linear,
    flax_init,
    float_logits,
    to_compute,
)
from gtopkssgd_tpu_torch.models.recurrent import LSTM, Carry


class PTBLSTM(nn.Module):
    def __init__(self, vocab_size: int = 10000, hidden_size: int = 650,
                 num_layers: int = 2, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.compute_dtype = dtype
        self.embed = nn.Embedding(vocab_size, hidden_size)
        self.cells = nn.ModuleList(LSTM(hidden_size, hidden_size, dtype)
                                   for _ in range(num_layers))
        self.fc = Linear(hidden_size, vocab_size)
        self.dropout = Dropout(dropout_rate)

    def initial_carry(self, batch_size: int) -> Tuple[Carry, ...]:
        like = self.fc.weight
        return tuple(cell.initial_carry(batch_size, like)
                     for cell in self.cells)

    def forward(self, tokens: torch.Tensor,
                carry: Optional[Tuple[Carry, ...]] = None):
        """tokens i64[B, T] -> (logits f32[B, T, vocab], new carry)."""
        if carry is None:
            carry = self.initial_carry(tokens.shape[0])
        x = self.dropout(F.embedding(
            tokens, to_compute(self.embed.weight, self.compute_dtype)))
        new_carry = []
        for cell, state in zip(self.cells, carry):
            x, state = cell(x, state)
            new_carry.append(state)
            x = self.dropout(x)
        return float_logits(self.fc(x)), tuple(new_carry)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: the embedding normal with variance
        1/hidden, the cells and the dense layer as ``flax_init`` draws
        them."""
        flax_init(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.embed.weight, 0.0,
                            math.sqrt(1.0 / self.hidden_size),
                            generator=generator)
