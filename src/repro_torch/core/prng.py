"""Threefry-2x32 keys and draws, the parts of `jax.random` the JAX
package uses, in its partitionable layout (`jax_threefry_partitionable`,
the default of the JAX it is tested with).

A key is an int64 tensor of shape [..., 2] holding two uint32 words;
every function takes its key and device explicitly and keeps no state.
PyTorch has no shifts or unsigned compares on uint32, so each word is
held in int64 and every sum and shift is masked back to 32 bits.

  PRNGKey(seed)      [0, seed mod 2**32] for a seed of int32 or uint32
                     range (`threefry_seed`)
  fold_in(key, d)    threefry(key, (0, d))
  split(key, num)    threefry(key, (0, i)) for i < num, one key each
  bits(key, shape)   the two threefry words of the flat index (hi, lo)
                     of each element, XORed (partitionable random bits)
  uniform            the mantissa trick: bits >> 9 | 1.0's bits, minus 1
  bernoulli(p)       uniform < float32(p)
  exponential        -log1p(-uniform)

Keys, bits, `uniform` and `bernoulli` are bit for bit `jax.random`'s.
`exponential` goes through PyTorch's `log1p`, which differs from XLA's by
an ulp on some inputs.  Batched keys [..., 2] broadcast: `bits` of keys
[B, 2] and shape S is [B, *S], key b's draws in row b.
"""
from __future__ import annotations

import math

import torch

I64 = torch.int64
MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000      # float32 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 words held in int64 tensors
    (broadcast together).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in [-2**31, 2**32): the key
    [0, seed mod 2**32] (`threefry_seed`; a 32-bit seed has no high
    word)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} is outside int32/uint32 range")
    return torch.tensor([0, seed & MASK], dtype=I64, device=device)


def _words(key: torch.Tensor, extra_dims: int):
    """The key's two words, shaped to broadcast over `extra_dims`
    trailing axes."""
    shape = key.shape[:-1] + (1,) * extra_dims
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: data (a uint32 value, or a tensor of them
    broadcasting against the key's leading axes) folded into the key."""
    d = torch.as_tensor(data, dtype=I64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: keys [..., 2] give [..., num, 2]."""
    i = torch.arange(num, dtype=I64, device=key.device)
    k1, k2 = _words(key, 1)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 values in int64): keys
    [..., 2] give [..., *shape]."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 2**32:
        raise ValueError("more than 2**32 draws from one key")
    # the flat index's high word is 0 below 2**32 elements
    lo = torch.arange(size, dtype=I64, device=key.device).reshape(shape)
    k1, k2 = _words(key, len(shape))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 over [0, 1)."""
    b = (bits(key, shape) >> 9) | _ONE_BITS
    return b.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform < float32(p)."""
    u = uniform(key, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=key.device)


def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.exponential(key, shape)` in float32: -log1p(-u)."""
    return -torch.log1p(-uniform(key, shape))
