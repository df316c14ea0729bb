"""CTC for the AN4 model: the loss the trainer minimizes and the greedy
decode ``test()`` scores, the port of the JAX trainer's ``optax.ctc_loss``
call and ``_greedy_error_counts``.

``ctc_loss`` is ``optax.ctc_loss(...).mean()``: blank 0, each utterance's
negative log-likelihood NOT divided by its label length, the mean over
the batch. ``F.ctc_loss`` takes log-probabilities [T, B, C], so the
logits go through ``log_softmax`` first (optax applies it itself).

An infeasible alignment (fewer frames than labels plus repeats) has
likelihood 0. optax returns a large finite loss for it (its log-zero is
-1e5); ``F.ctc_loss`` returns inf. The port passes ``zero_infinity=True``:
such an utterance adds 0 to the batch's sum, and no gradient, rather than
inf and NaN gradients. Feasible utterances agree with optax; the
synthetic AN4 sets hold none that is infeasible.

``greedy_error_counts`` decodes by argmax, drops repeats and blanks within
each row's valid frames, and returns the corpus counts [char errors,
chars, word errors, words] (Levenshtein distances against the labels;
words split at the space id); the error rates are sums over sums.
``edit_distance`` is a copy of the pure-Python path of
``gtopkssgd_tpu/native``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gtopkssgd_tpu_torch.data.an4 import SPACE_ID

BLANK = 0


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor
             ) -> torch.Tensor:
    """logits f32[B, T, C], logit_lengths [B] (valid frames), labels
    [B, S] padded, label_lengths [B] -> the mean CTC loss, a scalar."""
    log_probs = logits.log_softmax(-1).transpose(0, 1)
    per_utt = F.ctc_loss(log_probs, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=BLANK,
                         reduction="none", zero_infinity=True)
    return per_utt.mean()


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two int sequences."""
    if not len(a):
        return len(b)
    if not len(b):
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _words(seq: Sequence[int]) -> List[Tuple[int, ...]]:
    out: List[Tuple[int, ...]] = []
    cur: List[int] = []
    for c in seq:
        if c == SPACE_ID:
            if cur:
                out.append(tuple(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        out.append(tuple(cur))
    return out


def greedy_error_counts(logits: np.ndarray, out_len: np.ndarray,
                        labels: np.ndarray,
                        label_lengths: np.ndarray) -> np.ndarray:
    """i64[4]: char errors, chars, word errors, words of the greedy decode
    of `logits` [B, T', C] (row b valid in its first out_len[b] frames)
    against `labels` [B, S] (row b's first label_lengths[b])."""
    pred = np.asarray(logits).argmax(-1)
    bsz, t_out = pred.shape
    valid = np.arange(t_out)[None, :] < np.asarray(out_len)[:, None]
    prev = np.concatenate([np.zeros((bsz, 1), pred.dtype), pred[:, :-1]],
                          axis=1)
    keep = valid & (pred != BLANK) & (pred != prev)
    counts = np.zeros(4, np.int64)
    for b in range(bsz):
        seq = pred[b][keep[b]].tolist()
        ref = np.asarray(labels)[b, :int(label_lengths[b])].tolist()
        counts[0] += edit_distance(seq, ref)
        counts[1] += max(1, len(ref))
        ids: dict = {}
        sw = [ids.setdefault(w, len(ids)) for w in _words(seq)]
        rw = [ids.setdefault(w, len(ids)) for w in _words(ref)]
        counts[2] += edit_distance(sw, rw)
        counts[3] += max(1, len(rw))
    return counts
