"""The DeepSpeech-style speech model for AN4, the port of
``gtopkssgd_tpu/models/lstman4.py``: two strided convolutions over the
(time, frequency) spectrogram, bidirectional LSTM layers with
sequence-wise BatchNorm between them, and a per-frame dense layer over
the 29 characters, trained with CTC.

* Convs without bias, (11, 41) stride 2 pad (5, 20) then (11, 21) stride 2
  pad (5, 10), 32 channels, each followed by BatchNorm and hard tanh.
* [B, 32, T', F'] is permuted to flax's [B, T', F', 32] before it is
  flattened to [B, T', F' * 32] (1,312 features at 161 bins).
* Each bidirectional layer (BatchNorm over batch and time before it from
  the second layer on) sums its two directions. ``input_lengths`` (frames
  before the convs) give each row its length after them,
  ``output_length``; as flax's ``nn.RNN(seq_lengths=...)`` does, the
  forward direction runs over all T' frames (its outputs at the padded
  frames are the recurrence continued over the padding, not zeros) and
  the backward one reads row b through ``reverse_index``: its valid
  frames reversed, then its padding reversed. The next BatchNorm's
  statistics include the padded frames, as flax's do; packed sequences
  would give other statistics.
* A last BatchNorm, then the dense layer.

Cell 2l is layer l's forward direction and cell 2l + 1 its backward one,
as flax numbers them (``tests/test_torch_recurrent.py`` holds the logits
to flax's, which a swap would break).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gtopkssgd_tpu_torch.data.an4 import N_BINS
from gtopkssgd_tpu_torch.models.layers import BatchNorm, flax_init
from gtopkssgd_tpu_torch.models.recurrent import (
    LSTM,
    gather_time,
    reverse_index,
)

AN4_NUM_CHARS = 29
# (kernel, stride, padding) of the two convs, over (time, frequency).
_CONVS = (((11, 41), (2, 2), (5, 20)), ((11, 21), (2, 2), (5, 10)))


def conv_features() -> int:
    """Width of a frame after the convs, 32 channels x F' (flax infers it
    from the input): 1,312 at 161 bins."""
    bins = N_BINS
    for (_, kf), (_, sf), (_, pf) in _CONVS:
        bins = (bins + 2 * pf - kf) // sf + 1
    return 32 * bins


class DeepSpeechAN4(nn.Module):
    def __init__(self, num_chars: int = AN4_NUM_CHARS,
                 rnn_hidden: int = 512, rnn_layers: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(1 if i == 0 else 32, 32, k, stride=s, padding=p,
                      bias=False)
            for i, (k, s, p) in enumerate(_CONVS))
        width = conv_features()
        self.bns = nn.ModuleList(
            [BatchNorm(32), BatchNorm(32)]
            + [BatchNorm(rnn_hidden, channel_dim=-1)
               for _ in range(rnn_layers)])
        self.cells = nn.ModuleList(
            LSTM(width if i < 2 else rnn_hidden, rnn_hidden)
            for i in range(2 * rnn_layers))
        self.fc = nn.Linear(rnn_hidden, num_chars)

    @staticmethod
    def output_length(input_length):
        """Frames after the two stride-2 convs."""
        t1 = (input_length - 1) // 2 + 1
        return (t1 - 1) // 2 + 1

    def forward(self, x: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x f32[B, T, 161] log spectrograms, input_lengths i32/i64[B]
        (None: every frame valid) -> logits f32[B, T', num_chars]."""
        y = x[:, None]  # [B, 1, T, F]
        for conv, bn in zip(self.convs, self.bns):
            y = F.hardtanh(bn(conv(y)))
        b, _, t, _ = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, t, -1)
        lengths = (torch.full((b,), t, device=y.device)
                   if input_lengths is None
                   else self.output_length(input_lengths.to(y.device)))
        rev = reverse_index(lengths, t)
        for layer in range(len(self.cells) // 2):
            if layer > 0:
                y = self.bns[1 + layer](y)
            fwd, bwd = self.cells[2 * layer], self.cells[2 * layer + 1]
            out_f, _ = fwd(y)
            out_b, _ = bwd(gather_time(y, rev))
            y = out_f + gather_time(out_b, rev)
        return self.fc(self.bns[-1](y))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
