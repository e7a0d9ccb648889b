"""Foundational layers of the dense/MoE transformer (`repro.models.layers`).

Parameters are plain dicts of tensors, as in the JAX package.  Random
init draws from an explicit `torch.Generator` on the generator's device,
in float32, and casts to the requested type.  The norm and the two
attention forms go to the hand-written kernels (dispatched by device):
`rmsnorm` -> `kernels/rmsnorm`, `blockwise_attention` (the causal
self-attention of training and prefill) -> `kernels/flash_attention`,
`decode_attention` -> `kernels/flash_decode`.  `rmsnorm` and
`blockwise_attention` are differentiable: with grad on, each runs as a
`torch.autograd.Function` whose backward is a hand-written kernel too
(`kernels/rmsnorm/ops.py`, `kernels/flash_attention/ops.py`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel

NEG_INF = -1e30

# ---------------------------------------------------------------- init utils


def uniform_init(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform in [-scale, scale), drawn in float32 on `gen`'s device."""
    x = torch.rand(shape, generator=gen, device=gen.device)
    return (x * (2 * scale) - scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    return uniform_init(gen, (d_in, d_out), math.sqrt(1.0 / d_in), dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (x * 0.02).to(dtype)


# ------------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, float32 math, x's type out;
    differentiable in x and scale."""
    return _rmsnorm_kernel(x, scale, eps)


# -------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_dim: int | None = None, device=None) -> torch.Tensor:
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """x [..., S, D] (head dim last); positions [..., S] int.  Interleaved
    pairs (x[..., ::2], x[..., 1::2]) rotate by position * freq; the
    first `rotary_dim` channels rotate, the rest pass through."""
    d = x.shape[-1]
    rd = rotary_dim or d
    inv = rope_freqs(d, theta, rd, x.device)
    ang = positions[..., None].float() * inv              # [..., S, rd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr = x[..., :rd].float()
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    rotated = torch.stack([y1, y2], -1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rd:]], -1)


# ---------------------------------------------------------------- attention


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None) -> torch.Tensor:
    """Causal self-attention of a whole sequence (the training and
    prefill case of the JAX function: q_offset 0, no kv_len, Sq == Sk):
    q [B, H, S, D]; k, v [B, Hkv, S, D], through the flash attention
    kernel; differentiable in q, k and v.  Prefill continuation over a
    cache is not ported (ROADMAP Queue A 16)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token decode: q [B, H, D], cache k/v [B, Hkv, S, D], kv_len
    [B] int32, through the flash decode kernel (which keeps this
    function's rounding points: `kernels/flash_decode/ops.py`)."""
    return flash_decode(q.contiguous(), k, v, kv_len.to(torch.int32),
                        scale=scale)


# ---------------------------------------------------------------------- mlp


def swiglu_init(gen: torch.Generator, d: int, f: int,
                dtype=torch.float32) -> dict:
    return {"w1": dense_init(gen, d, f, dtype),
            "w3": dense_init(gen, d, f, dtype),
            "w2": dense_init(gen, f, d, dtype)}


def swiglu_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
