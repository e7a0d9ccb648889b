"""Packed word-bitmask primitives (`repro.core.bitmask`, DESIGN.md §8).

The per-word metadata planes `wvalid`/`wdirty` pack 32 words per lane:
word offset `o` lives in lane `o // 32`, bit `o % 32` (LSB first), and
bits at offsets >= W in a ragged last lane stay zero.

The JAX package carries lanes as `uint32`; the port carries the same bit
patterns as `int32`, because torch's CPU backend lacks `<<` and `min` on
`uint32`.  Two consequences, both handled here:

  * bit 31 is the sign bit: `word_bit(31)` is a negative int32;
  * `>>` is arithmetic on int32 and copies the sign bit into the top.
    Every right shift below is followed by `& 1` or by a mask whose bit
    31 is clear, which drops the copied bits, so each result equals the
    uint32 one bit for bit.
"""
from __future__ import annotations

import torch

LANE_BITS = 32
I32 = torch.int32


def n_lanes(n_bits: int) -> int:
    """Packed lanes needed for `n_bits` flags."""
    return (n_bits + LANE_BITS - 1) // LANE_BITS


def word_index(o: torch.Tensor) -> torch.Tensor:
    """Lane holding word offset `o` along the packed axis."""
    return o.to(I32) >> 5


def word_bit(o: torch.Tensor) -> torch.Tensor:
    """Single-bit int32 pattern for word offset `o` within its lane
    (offset 31 gives the sign bit, a negative int32)."""
    return torch.ones_like(o, dtype=I32) << (o.to(I32) & 31)


def test_word(words: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Boolean `flags[..., o]` given gathered lanes
    `words = packed[..., word_index(o)]`."""
    return (words & word_bit(o)) != 0


def pack(flags: torch.Tensor) -> torch.Tensor:
    """[..., W] bool -> [..., n_lanes(W)] int32 bit patterns."""
    w = flags.shape[-1]
    lanes = n_lanes(w)
    pad = torch.zeros(flags.shape[:-1] + (lanes * LANE_BITS - w,),
                      dtype=torch.bool, device=flags.device)
    grouped = torch.cat([flags, pad], dim=-1).reshape(
        flags.shape[:-1] + (lanes, LANE_BITS)).to(I32)
    shifts = torch.arange(LANE_BITS, dtype=I32, device=flags.device)
    # OR of distinct single-bit patterns == their sum mod 2**32; the
    # int32 sum wraps exactly like the uint32 one
    return (grouped << shifts).sum(dim=-1, dtype=I32)


def unpack(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[..., L] int32 -> [..., n_bits] bool (inverse of `pack`)."""
    shifts = torch.arange(LANE_BITS, dtype=I32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1        # & 1 drops the sign
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * LANE_BITS,))
    return flat[..., :n_bits] != 0


def get_bit(vec: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Boolean `flags[o]` of a single packed row `vec [L]`."""
    return test_word(vec[word_index(o)], o)


def set_bit(vec: torch.Tensor, o: torch.Tensor, on=True) -> torch.Tensor:
    """Packed row with `flags[o] |= on`."""
    bit = torch.where(torch.as_tensor(on, device=vec.device), word_bit(o),
                      torch.zeros_like(word_bit(o)))
    out = vec.clone()
    out[word_index(o)] = vec[word_index(o)] | bit
    return out


def clear_bit(vec: torch.Tensor, o: torch.Tensor, off=True) -> torch.Tensor:
    """Packed row with `flags[o] &= ~off`."""
    bit = torch.where(torch.as_tensor(off, device=vec.device), word_bit(o),
                      torch.zeros_like(word_bit(o)))
    out = vec.clone()
    out[word_index(o)] = vec[word_index(o)] & ~bit
    return out


def any_set(packed: torch.Tensor) -> torch.Tensor:
    """Boolean `any(flags, -1)` per row."""
    return (packed != 0).any(dim=-1)


def popcount_word(w: torch.Tensor) -> torch.Tensor:
    """Per-lane set-bit count (Hacker's Delight 5-2).  Each `>>` is
    followed by a mask with bit 31 clear, or acts on a word whose bit 31
    is already clear; `-`, `+` and `*` wrap mod 2**32 like uint32."""
    w = w.to(I32)
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (w * 0x01010101) >> 24


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Integer `sum(flags, -1)` per row (padding bits are zero)."""
    return popcount_word(packed).sum(dim=-1, dtype=I32)
