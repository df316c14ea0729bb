"""Wire codecs for the sparse (vals, idx) exchange set.

Counterpart of ``gtopkssgd_tpu/parallel/codec.py``. Every sparse
collective ships a fixed-k set of (f32 value, i32 index) pairs with
sentinel padding ``idx == n``. A codec turns the set into ONE int32 wire
tensor whose words are, bit for bit, the words of the JAX package's uint32
buffer for the same set:

  fp32          identity: the values' bits, then the indices; 8 bytes an
                element.
  int8[:B]      blocks of B values (index-sorted) share one bf16 scale
                max|v| / 127; the values round half to even into int8.
  fp8[:B]       the same framing with float8_e4m3fn values and scales
                max|v| / 448.

The quantized codecs code the indices Elias-Fano style: the set is
sorted by index; each index splits into ``l = floor(log2((n+1)/k))`` low
bits, packed at l bits an element, and a high part whose values
``high_i + i`` are set bits of a monotone bit-vector. Words are
[values | scales | high bit-vector | low bits], each part padded to whole
32-bit words; ``_layout`` gives their lengths, and both the encoder and
the byte model (``wire_set_bytes``) read it.

The bit arithmetic runs in int64 masked to 32 bits (torch has no shifts
of uint32 on the CPU) and maps to int32 at the end; the scatters of bits
are integer adds into disjoint bit ranges, so their order does not matter
and an atomic ``index_add_`` on the card gives the same words. Decode
finds the k set bits of the high vector by a cumulative sum and one
integer scatter, with no host sync (``torch.nonzero`` would wait for the
card). Everything runs on the device of its inputs.

Encode is a deterministic function of the set, so a rank that decodes
its own wire recovers what its partner decodes: the merge tree merges
decode(own wire) with decode(partner wire), and both partners stay
bitwise equal (``collectives.gtopk_allreduce``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

_LANE_BITS = 32
_WORD_MASK = 0xFFFFFFFF


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Wire layout of one (k, n, block) shape, in 32-bit words."""

    k: int
    n: int
    block: int
    l_bits: int       # low bits an index (Elias-Fano split)
    n_blocks: int     # value scale blocks
    val_words: int    # 8-bit values, 4 a word
    scale_words: int  # bf16 block scales, 2 a word
    up_words: int     # monotone high-part bit-vector
    low_words: int    # packed low index bits

    @property
    def total_words(self) -> int:
        return (self.val_words + self.scale_words + self.up_words
                + self.low_words)


def _layout(k: int, n: int, block: int) -> _Layout:
    if k < 1 or n < 1:
        raise ValueError(f"codec layout needs k >= 1, n >= 1 (k={k} n={n})")
    u = n + 1  # the index universe is [0, n]: the sentinel n encodes too
    l_bits = max(0, (u // k).bit_length() - 1) if u > k else 0
    l_bits = min(l_bits, 31)
    n_blocks = _ceil_div(k, block)
    up_bits = (n >> l_bits) + k  # positions high_i + i, strictly increasing
    return _Layout(
        k=k, n=n, block=block, l_bits=l_bits, n_blocks=n_blocks,
        val_words=_ceil_div(k, 4),
        scale_words=_ceil_div(n_blocks, 2),
        up_words=_ceil_div(up_bits, _LANE_BITS),
        low_words=_ceil_div(k * l_bits, _LANE_BITS),
    )


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _pack_bits(values: torch.Tensor, width: int,
               n_words: int) -> torch.Tensor:
    """Pack int64 values (< 2^width each) at `width` bits an element into
    int64 words of 32 bits. An element may straddle two words; the part
    past the last word is dropped, as JAX's ``mode="drop"`` does."""
    dev = values.device
    if n_words == 0 or width == 0:
        return torch.zeros(n_words, dtype=torch.int64, device=dev)
    start = torch.arange(values.shape[0], dtype=torch.int64,
                         device=dev) * width
    w = start // _LANE_BITS
    o = start % _LANE_BITS
    low = (values << o) & _WORD_MASK
    spill = (o + width) > _LANE_BITS
    # o > 0 whenever spill (width <= 32), so the shift stays in [1, 31].
    sh = torch.where(o > 0, _LANE_BITS - o, 1)
    high = torch.where(spill, values >> sh, 0)
    words = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, w, low)
    words.index_add_(0, (w + 1).clamp(max=n_words), high)
    return words[:n_words]


def _unpack_bits(words: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """Inverse of ``_pack_bits`` over int32 words -> int64[k]; reads past
    the end clamp to the last word, as JAX's ``mode="clip"`` does."""
    dev = words.device
    if width == 0:
        return torch.zeros(k, dtype=torch.int64, device=dev)
    w64 = words.to(torch.int64) & _WORD_MASK
    last = w64.shape[0] - 1
    start = torch.arange(k, dtype=torch.int64, device=dev) * width
    w = start // _LANE_BITS
    o = start % _LANE_BITS
    cur = w64[w.clamp(max=last)]
    nxt = w64[(w + 1).clamp(max=last)]
    lo = cur >> o
    spill = (o + width) > _LANE_BITS
    sh = torch.where(o > 0, _LANE_BITS - o, 1)
    hi = torch.where(spill, (nxt << sh) & _WORD_MASK, 0)
    mask = _WORD_MASK if width >= 32 else (1 << width) - 1
    return (lo | hi) & mask


class WireCodec:
    """fp32 identity codec: the wire is the values' bits, then the
    indices (2k words). Also the base of the quantized codecs."""

    name = "fp32"
    values_bits = 32
    block = 0
    lossy = False

    def index_bits(self, k: int, n: int) -> float:
        return 32.0

    def wire_set_bytes(self, k: int, n: int) -> int:
        """On-wire bytes of one k-of-n set."""
        return 8 * k

    def bit_budget(self, k: int, n: int) -> Dict[str, float]:
        """Bits an element, by part."""
        return {"values_bits": float(self.values_bits),
                "index_bits": self.index_bits(k, n),
                "scale_bits": 0.0,
                "total_bits": float(self.values_bits) + self.index_bits(k, n)}

    def encode(self, vals: torch.Tensor, idx: torch.Tensor, *,
               n: int) -> torch.Tensor:
        return torch.cat([vals.contiguous().view(torch.int32),
                          idx.to(torch.int32)])

    def decode(self, wire: torch.Tensor, *, k: int,
               n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return wire[:k].view(torch.float32), wire[k:]

    def __repr__(self):
        return f"WireCodec({self.name!r})"


class _QuantCodec(WireCodec):
    """The framing the 8-bit value codecs share (int8, fp8)."""

    values_bits = 8
    lossy = True
    base_name = ""
    qmax = 0.0

    def __init__(self, block: int):
        if block < 4 or block % 4:
            raise ValueError(
                f"codec block size must be a positive multiple of 4, "
                f"got {block}")
        self.block = block
        self.name = f"{self.base_name}:{block}"

    def index_bits(self, k: int, n: int) -> float:
        lo = _layout(k, n, self.block)
        return (lo.up_words + lo.low_words) * _LANE_BITS / k

    def wire_set_bytes(self, k: int, n: int) -> int:
        return 4 * _layout(k, n, self.block).total_words

    def bit_budget(self, k: int, n: int) -> Dict[str, float]:
        lo = _layout(k, n, self.block)
        return {
            "values_bits": lo.val_words * _LANE_BITS / k,
            "index_bits": (lo.up_words + lo.low_words) * _LANE_BITS / k,
            "scale_bits": lo.scale_words * _LANE_BITS / k,
            "total_bits": lo.total_words * _LANE_BITS / k,
        }

    def _quant(self, blocks: torch.Tensor, s32: torch.Tensor) -> torch.Tensor:
        """f32[n_blocks, block] -> the 8-bit codes as uint8."""
        raise NotImplementedError

    def _codes_to_f32(self, qbytes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, vals: torch.Tensor, idx: torch.Tensor, *,
               n: int) -> torch.Tensor:
        k = vals.shape[0]
        lo = _layout(k, n, self.block)
        dev = vals.device
        # Sorted by index; ties are sentinel slots of value 0, so a stable
        # sort gives the words of JAX's lax.sort.
        sidx, order = torch.sort(idx, stable=True)
        svals = vals[order]

        # Values, quantized against the bf16-rounded block scale.
        kb = lo.n_blocks * self.block
        blocks = F.pad(svals, (0, kb - k)).view(lo.n_blocks, self.block)
        # XLA compiles the JAX package's amax / qmax as amax * (1 / qmax),
        # the reciprocal rounded to float32; so does the port, on every
        # device (a division rounds differently at some maxima).
        amax = blocks.abs().amax(dim=1)
        recip = float(np.float32(1.0) / np.float32(self.qmax))
        scale = (amax * torch.full_like(amax, recip)).to(torch.bfloat16)
        qbytes = self._quant(blocks, scale.to(torch.float32))
        val_b = torch.zeros(lo.val_words * 4, dtype=torch.uint8, device=dev)
        val_b[:k] = qbytes.reshape(-1)[:k]
        scale_p = torch.zeros(lo.scale_words * 2, dtype=torch.bfloat16,
                              device=dev)
        scale_p[:lo.n_blocks] = scale

        # Indices: Elias-Fano split at l low bits.
        iu = sidx.to(torch.int64)
        l_bits = lo.l_bits
        low_w = _pack_bits(iu & ((1 << l_bits) - 1), l_bits, lo.low_words)
        pos = (iu >> l_bits) + torch.arange(k, dtype=torch.int64, device=dev)
        up = torch.zeros(lo.up_words, dtype=torch.int64, device=dev)
        up.index_add_(0, pos // _LANE_BITS,
                      torch.ones_like(pos) << (pos % _LANE_BITS))
        return torch.cat([val_b.view(torch.int32), scale_p.view(torch.int32),
                          _to_int32(up), _to_int32(low_w)])

    def decode(self, wire: torch.Tensor, *, k: int,
               n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = _layout(k, n, self.block)
        dev = wire.device
        a = lo.val_words
        b = a + lo.scale_words
        c = b + lo.up_words
        val_w, scale_w, up, low_w = wire[:a], wire[a:b], wire[b:c], wire[c:]

        s32 = scale_w.view(torch.bfloat16)[:lo.n_blocks].to(torch.float32)
        kb = lo.n_blocks * self.block
        qbytes = torch.zeros(kb, dtype=torch.uint8, device=dev)
        qbytes[:k] = val_w.view(torch.uint8)[:k]
        q = self._codes_to_f32(qbytes)
        vals = (q.view(-1, self.block) * s32[:, None]).reshape(kb)[:k]

        # The positions of the first k set bits, by rank among the set
        # bits: a cumulative sum numbers them, one scatter places them.
        # Slots with no bit (a malformed vector) stay 0, as JAX's
        # nonzero(size=k, fill_value=0) leaves them.
        up64 = up.to(torch.int64) & _WORD_MASK
        shifts = torch.arange(_LANE_BITS, dtype=torch.int64, device=dev)
        bits = ((up64[:, None] >> shifts[None, :]) & 1).reshape(-1)
        rank = torch.cumsum(bits, 0)
        slot = torch.where((bits == 1) & (rank <= k), rank - 1, k)
        pos = torch.zeros(k + 1, dtype=torch.int64, device=dev)
        pos.index_add_(0, slot, torch.arange(bits.shape[0],
                                             dtype=torch.int64, device=dev))
        high = pos[:k] - torch.arange(k, dtype=torch.int64, device=dev)
        low = _unpack_bits(low_w, lo.l_bits, k)
        idx = ((high << lo.l_bits) | low) & _WORD_MASK
        return vals, _to_int32(idx)


class Int8Codec(_QuantCodec):
    base_name = "int8"
    qmax = 127.0

    def _quant(self, blocks, s32):
        denom = torch.where(s32 > 0, s32, 1.0)[:, None]
        q = torch.clamp(torch.round(blocks / denom), -127.0, 127.0)
        return q.to(torch.int8).view(torch.uint8)

    def _codes_to_f32(self, qbytes):
        return qbytes.view(torch.int8).to(torch.float32)


class Fp8Codec(_QuantCodec):
    base_name = "fp8"
    qmax = 448.0  # float8_e4m3fn's largest finite value

    def _quant(self, blocks, s32):
        denom = torch.where(s32 > 0, s32, 1.0)[:, None]
        q = torch.clamp(blocks / denom, -448.0, 448.0)
        return q.to(torch.float8_e4m3fn).view(torch.uint8)

    def _codes_to_f32(self, qbytes):
        return qbytes.view(torch.float8_e4m3fn).to(torch.float32)


DEFAULT_BLOCK = 64

#: Grammar: fp32 | int8[:BLOCK] | fp8[:BLOCK] (BLOCK a multiple of 4,
#: default 64).
CODEC_NAMES = ("fp32", "int8", "fp8")


def get_codec(spec: Union[None, str, WireCodec]) -> WireCodec:
    """A codec instance passes through; None means fp32; a string follows
    the ``fp32 | int8[:BLOCK] | fp8[:BLOCK]`` grammar."""
    if isinstance(spec, WireCodec):
        return spec
    spec = "fp32" if spec is None else str(spec)
    base, _, blk = spec.partition(":")
    if base not in CODEC_NAMES or (base == "fp32" and blk):
        raise ValueError(
            f"unknown wire codec {spec!r} (grammar: fp32 | int8[:BLOCK] "
            f"| fp8[:BLOCK])")
    if base == "fp32":
        return WireCodec()
    try:
        block = int(blk) if blk else DEFAULT_BLOCK
    except ValueError:
        raise ValueError(f"bad codec block size in {spec!r}") from None
    return (Int8Codec if base == "int8" else Fp8Codec)(block)


def roundtrip_aligned(codec, vals: torch.Tensor, idx: torch.Tensor, *,
                      n: int) -> torch.Tensor:
    """decode(encode(vals)) in the ORIGINAL slot order of (vals, idx):
    what the sender contributes through the wire. The optimizer folds
    vals - roundtrip into the residual and ships the roundtripped values,
    so repairing a globally rejected pick restores the original exactly.
    Identity for fp32."""
    codec = get_codec(codec)
    if not codec.lossy:
        return vals
    qvals, _ = codec.decode(codec.encode(vals, idx, n=n),
                            k=vals.shape[0], n=n)
    # Decode is in index order; sorted slot j came from slot perm[j].
    perm = torch.argsort(idx, stable=True)
    out = torch.zeros_like(vals)
    out[perm] = qvals
    return out
