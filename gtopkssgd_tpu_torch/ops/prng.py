"""JAX's default counter-based PRNG on tensors: threefry-2x32, ``PRNGKey``,
``fold_in`` and ``uniform`` in float32, bit for bit ``jax.random``'s with
``jax_threefry_partitionable`` on (the default since jax 0.5).

A key is a pair of uint32 words. Torch has little uint32 arithmetic, so a
word lives in an int64 tensor and every add, shift and rotate is masked
back to 32 bits. Everything stays on the operands' device, with no host
sync: ``simrecall`` seeds a key from a sum of the gradient and draws its
drop pattern inside the step.

* ``threefry2x32(k0, k1, x0, x1)``: the 20-round block cipher,
  elementwise over the counters (x0, x1).
* ``prng_key(seed)``: ``jax.random.PRNGKey`` for a 32-bit seed, (0, seed).
* ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``.
* ``random_bits(key, n)``: counter i is the pair (0, i) for i < 2^32;
  the 32 bits are the two output words xored.
* ``uniform(key, n)``: the bits' top 23 under the exponent of 1.0, as a
  float32 in [1, 2), less 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[torch.Tensor, torch.Tensor]


def _word(v, device=None) -> torch.Tensor:
    """A uint32 word as an int64 tensor (an int, or a tensor of any
    integer dtype whose bits are the word: int32 reads as unsigned)."""
    if not isinstance(v, torch.Tensor):  # a fill, not a host copy
        return torch.full((), int(v) & MASK, dtype=torch.int64,
                          device=device)
    return v.to(torch.int64) & MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counters (x0, x1) under the key
    (k0, k1); all int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    return _word(0, device), _word(seed, device)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``; `data` an int or a 0-d integer
    tensor (an int32's bits read as uint32)."""
    k0, k1 = key
    d = _word(data, k0.device)
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """n random uint32 words (int64 tensor), ``jax.random.bits``'s."""
    if n >= 1 << 32:
        raise ValueError(f"{n} words: the counter's high word is not "
                         "modelled")
    k0, k1 = key
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key: Key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32, in [0, 1)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
