"""GQA attention (`repro.models.attention`, its GQA part): init, the
full-sequence causal form of training and prefill (`gqa_train`, which
also returns the layer's K/V cache) and one decode step against a cache
(`gqa_decode`), with the optional QKV bias.
Multi-head latent and cross attention are not ported yet (ROADMAP Queue
A 16).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The projections, uniform in +-sqrt(1/d_in); with `cfg.qkv_bias`
    also `bias_q` [H*D], `bias_k` and `bias_v` [Hkv*D], zeros in the
    model's type, as the JAX function draws them."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": L.dense_init(gen, d, h * hd, dtype),
         "wk": L.dense_init(gen, d, hkv * hd, dtype),
         "wv": L.dense_init(gen, d, hkv * hd, dtype),
         "wo": L.dense_init(gen, h * hd, d, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bias_q", h), ("bias_k", hkv), ("bias_v", hkv)):
            p[name] = torch.zeros(n * hd, dtype=dtype, device=gen.device)
    return p


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """x [B, S, d] -> q [B, H, S, D], k, v [B, Hkv, S, D], rotated; the
    QKV bias, where the config has one, is added to the products in the
    model's type before the reshape and RoPE."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bias_q"], k + p["bias_k"], v + p["bias_v"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    rd = int(cfg.partial_rotary * hd)
    q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta, rotary_dim=rd)
    k = L.apply_rope(k, positions[:, None, :], cfg.rope_theta, rotary_dim=rd)
    return q, k, v


def gqa_train(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, return_cache: bool = True):
    """Causal self-attention of x [B, S, d] at positions [B, S].  Returns
    (out [B, S, d], (k, v) [B, Hkv, S, D] or None), as the JAX function
    does."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = L.blockwise_attention(q, k, v)
    out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    if not return_cache:
        return out, None
    return out, (k.contiguous(), v.contiguous())


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache,
               kv_len: torch.Tensor):
    """x [B, 1, d]; cache (k, v) [B, Hkv, S, D]; kv_len [B].  The new
    token's K/V go to slot kv_len of each row, written into the cache
    tensors in place, and attention runs over kv_len + 1 positions.
    Returns (out [B, 1, d], cache)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, kv_len[:, None])
    k, v = cache
    rows = torch.arange(b, device=x.device)
    slot = kv_len.long()
    k[rows, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[rows, :, slot] = v_new[:, :, 0].to(v.dtype)
    o = L.decode_attention(q[:, :, 0], k, v, kv_len + 1)
    return o.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"], (k, v)
