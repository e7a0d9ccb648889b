"""Mixture-of-Experts FFN with sort-based (dropping) dispatch
(`repro.models.moe`).

Tokens are split into dispatch groups.  In each group the token-expert
assignments are stably sorted by expert, each assignment's position in
its expert's run comes from the run starts (`searchsorted`), and
assignments past the expert's capacity are dropped.  Experts apply as
batched [G, E, C, d] x [E, d, f] products.  The router is the
`topk_router` kernel (dispatched by device).

The combine is a fixed-order reduction (no `index_add_`, whose CUDA
atomics would make the greedy tokens depend on the run): each token's k
contributions are gathered to [t, k, d] in the order of the sorted
assignment list, which is the order the JAX scatter-add takes them,
and summed over k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.topk_router import topk_router
from repro_torch.models import layers as L


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    return {"router": L.dense_init(gen, d, e, torch.float32),
            "experts_w1": L.uniform_init(gen, (e, d, f), (1 / d) ** 0.5,
                                         dtype),
            "experts_w3": L.uniform_init(gen, (e, d, f), (1 / d) ** 0.5,
                                         dtype),
            "experts_w2": L.uniform_init(gen, (e, f, d), (1 / f) ** 0.5,
                                         dtype)}


def _dispatch(xg: torch.Tensor, wg: torch.Tensor, ig: torch.Tensor,
              e: int, cap: int):
    """Sort-based dispatch of G groups at once.  xg [G, tg, d], wg/ig
    [G, tg, k].  Returns (buf [G, e, cap, d], (order, wflat, keep,
    dest)), every meta tensor [G, tg*k] in sorted order; order[p] is the
    flat (token * k + choice) index of sorted position p."""
    g, tg, d = xg.shape
    k = ig.shape[-1]
    eflat = ig.reshape(g, tg * k).long()
    order = torch.argsort(eflat, dim=-1, stable=True)
    sorted_e = eflat.gather(-1, order)
    wflat = wg.reshape(g, tg * k).gather(-1, order)
    token_of = order // k
    experts = torch.arange(e, device=xg.device).expand(g, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    pos = torch.arange(tg * k, device=xg.device) \
        - seg_start.gather(-1, sorted_e)
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)   # drop slot
    xs = xg.gather(1, token_of[..., None].expand(g, tg * k, d))
    xs = torch.where(keep[..., None], xs, 0)
    # the spare row e*cap takes the dropped assignments and is sliced off
    buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype, device=xg.device)
    buf.scatter_(1, dest[..., None].expand(g, tg * k, d), xs)
    return buf[:, : e * cap].reshape(g, e, cap, d), (order, wflat, keep, dest)


def _combine(out: torch.Tensor, meta, tg: int, k: int, e: int,
             cap: int) -> torch.Tensor:
    """out [G, e, cap, d] -> y [G, tg, d] float32: each token's kept
    expert outputs times their router weights, summed over its k
    assignments in sorted order."""
    order, wflat, keep, dest = meta
    g, _, _, d = out.shape
    n = dest.shape[-1]
    # the sorted positions of each token's k assignments, ascending
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=out.device).expand(g, n)
        .contiguous())
    order_k = inv.reshape(g, tg, k).sort(-1).values
    flat = out.reshape(g, e * cap, d)
    got = flat.gather(1, dest.clamp(max=e * cap - 1)[..., None]
                      .expand(g, n, d))
    contrib = torch.where(keep[..., None], got, 0).float() * wflat[..., None]
    per_tok = contrib.gather(1, order_k.reshape(g, tg * k, 1)
                             .expand(g, tg * k, d))
    return per_tok.reshape(g, tg, k, d).sum(2)


def moe_apply(p: dict, cfg: ModelConfig, x2d: torch.Tensor, *,
              groups: int | None = None) -> torch.Tensor:
    """x2d [T, d] -> y [T, d].  The JAX function's load-balance aux loss
    and expert counts are training outputs and are not computed.

    `groups` None splits the T tokens into `dispatch_groups` groups,
    halved until the count divides T (the JAX rule).  The serving engine
    passes one group per slot, so each slot packs its own capacity as
    the JAX engine's per-slot vmap does."""
    m = cfg.moe
    t, d = x2d.shape
    e, k = m.n_experts, m.top_k
    if groups is None:
        g = m.dispatch_groups
        while g > 1 and t % g != 0:
            g //= 2
    else:
        g = groups
        if t % g:
            raise ValueError(f"moe_apply: {t} tokens in {g} groups")
    tg = t // g
    cap = min(max(int(tg * k / e * m.capacity_factor), 4), tg)

    logits = x2d.float() @ p["router"]                    # [T, E]
    weights, idx = topk_router(logits, k)                 # [T, k]

    buf, meta = _dispatch(x2d.reshape(g, tg, d), weights.reshape(g, tg, k),
                          idx.reshape(g, tg, k), e, cap)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["experts_w1"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["experts_w3"])
    out = torch.einsum("gecf,efd->gecd", h, p["experts_w2"])
    y = _combine(out, meta, tg, k, e, cap).reshape(t, d)
    return y.to(x2d.dtype)
