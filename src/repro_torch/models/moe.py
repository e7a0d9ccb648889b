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

Serving and training run one forward.  The dispatch and the combine are
autograd Functions (`_Dispatch`, `_Combine`) whose backward gathers
along the inverse maps, built from the saved routing.  Autograd of the
forward's gathers would scatter-add instead: CUDA atomics, or under
deterministic algorithms a sort-based kernel that took 411 ms of a 1156
ms training step (PERF.md §6, PR 24).

`moe_apply` is the serving call (y only); `moe_train` adds the JAX
function's training outputs, the Switch load-balance aux loss and the
expert counts.  The router is differentiable (`kernels/topk_router`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

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


@contextlib.contextmanager
def _distinct_scatter():
    """Deterministic algorithms off around a `scatter_` whose destinations
    are distinct but for one row that is sliced off (the drop slot): its
    result is the same bits either way, and the mode's `scatter_` is a
    sort-based `index_put_` over every element, which doubled a training
    step's device time (PERF.md §6, PR 24)."""
    if not torch.are_deterministic_algorithms_enabled():
        yield
        return
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True, warn_only=warn_only)


class Routing(NamedTuple):
    """The routing of G groups, each [G, tg*k]: `order` maps a sorted
    position p to its flat assignment q = token * k + choice, `inv` maps
    q back to p, `keep` says whether p has a slot, and `dest` is p's slot
    (expert * cap + place), or e*cap when p was dropped."""
    order: torch.Tensor
    inv: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor


def _route(ig: torch.Tensor, e: int, cap: int) -> Routing:
    """The assignments ig [G, tg, k] stably sorted by expert; the first
    `cap` of each expert's run keep a slot, the rest are dropped."""
    g, tg, k = ig.shape
    n = tg * k
    eflat = ig.reshape(g, n).long()
    order = torch.argsort(eflat, dim=-1, stable=True)
    sorted_e = eflat.gather(-1, order)
    experts = torch.arange(e, device=ig.device).expand(g, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, side="left")
    pos = torch.arange(n, device=ig.device) - seg_start.gather(-1, sorted_e)
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)   # drop slot
    inv = torch.empty_like(order)
    with _distinct_scatter():
        inv.scatter_(-1, order, torch.arange(n, device=ig.device)
                     .expand(g, n).contiguous())
    return Routing(order, inv, keep, dest)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx [G, m] of x [G, r, d] along axis 1; idx == r reads a row
    of zeros."""
    g, _, d = x.shape
    pad = torch.cat([x, x.new_zeros((g, 1, d))], 1)
    return pad.gather(1, idx[..., None].expand(idx.shape + (d,)))


class _Dispatch(torch.autograd.Function):
    """xg [G, tg, d] -> buf [G, e, cap, d]: each kept assignment's token
    in its slot, empty slots zero.  The backward gathers each assignment's
    slot and sums a token's k of them."""

    @staticmethod
    def forward(ctx, xg, r: Routing, e: int, cap: int):
        g, tg, d = xg.shape
        n = r.order.shape[-1]
        xs = xg.gather(1, (r.order // (n // tg))[..., None].expand(g, n, d))
        xs = torch.where(r.keep[..., None], xs, 0)
        # the spare row e*cap takes the dropped assignments and is sliced off
        buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype,
                          device=xg.device)
        with _distinct_scatter():
            buf.scatter_(1, r.dest[..., None].expand(g, n, d), xs)
        ctx.save_for_backward(r.inv, r.dest)
        ctx.tg = tg
        return buf[:, : e * cap].reshape(g, e, cap, d)

    @staticmethod
    def backward(ctx, dbuf):
        inv, dest = ctx.saved_tensors
        g, e, cap, d = dbuf.shape
        # q's slot, or the zero row e*cap where q was dropped
        dxs = _gather_rows(dbuf.reshape(g, e * cap, d), dest.gather(-1, inv))
        return dxs.reshape(g, ctx.tg, -1, d).sum(2), None, None, None


class _Combine(torch.autograd.Function):
    """out [G, e, cap, d], router weights wg [G, tg, k] -> y [G, tg, d]
    float32: each token's kept expert outputs times their weights, summed
    over its k assignments in sorted order.  The backward reads, for each
    slot, the gradient of the token whose assignment filled it."""

    @staticmethod
    def forward(ctx, out, wg, r: Routing):
        g, e, cap, d = out.shape
        _, tg, k = wg.shape
        n = tg * k
        wflat = wg.reshape(g, n).gather(-1, r.order)
        # the sorted positions of each token's k assignments, ascending
        order_k = r.inv.reshape(g, tg, k).sort(-1).values
        got = out.reshape(g, e * cap, d).gather(
            1, r.dest.clamp(max=e * cap - 1)[..., None].expand(g, n, d))
        contrib = torch.where(r.keep[..., None], got, 0).float() \
            * wflat[..., None]
        per_tok = contrib.gather(1, order_k.reshape(g, n, 1).expand(g, n, d))
        ctx.save_for_backward(out, wg, *r)
        return per_tok.reshape(g, tg, k, d).sum(2)

    @staticmethod
    def backward(ctx, dy):
        out, wg, order, inv, keep, dest = ctx.saved_tensors
        g, e, cap, d = out.shape
        _, tg, k = wg.shape
        n = tg * k
        # the gradient of each sorted position's token
        dyp = dy.gather(1, (order // k)[..., None].expand(g, n, d))
        dout = dwg = None
        if ctx.needs_input_grad[0]:
            wflat = wg.reshape(g, n).gather(-1, order)
            dgot = torch.where(keep[..., None], dyp * wflat[..., None],
                               0).to(out.dtype)
            # each slot's sorted position, n (the zero row) when empty
            p_of_slot = torch.full((g, e * cap + 1), n, dtype=order.dtype,
                                   device=order.device)
            with _distinct_scatter():
                p_of_slot.scatter_(-1, dest, torch.arange(
                    n, device=order.device).expand(g, n).contiguous())
            dout = _gather_rows(dgot, p_of_slot[:, : e * cap]) \
                .reshape(g, e, cap, d)
        if ctx.needs_input_grad[1]:
            got = out.reshape(g, e * cap, d).gather(
                1, dest.clamp(max=e * cap - 1)[..., None].expand(g, n, d))
            dw = torch.where(keep, (got.float() * dyp).sum(-1), 0)
            dwg = dw.gather(-1, inv).reshape(g, tg, k)
        return dout, dwg, None


def moe_apply(p: dict, cfg: ModelConfig, x2d: torch.Tensor, *,
              groups: int | None = None) -> torch.Tensor:
    """x2d [T, d] -> y [T, d] (the serving call; `moe_train` adds the
    aux loss and the expert counts).

    `groups` None splits the T tokens into `dispatch_groups` groups,
    halved until the count divides T (the JAX rule).  The serving engine
    passes one group per slot, so each slot packs its own capacity as
    the JAX engine's per-slot vmap does."""
    return _moe(p, cfg, x2d, groups)[0]


def moe_train(p: dict, cfg: ModelConfig, x2d: torch.Tensor):
    """x2d [T, d] -> (y [T, d], aux_loss scalar, expert_counts [E]), as
    `repro.models.moe.moe_apply`: the Switch aux loss aux_loss_coef * E *
    sum(mean router probability * fraction of tokens whose first choice
    is the expert), and each expert's count of the T*k assignments."""
    m = cfg.moe
    e = m.n_experts
    y, logits, idx = _moe(p, cfg, x2d, None)
    experts = torch.arange(e, device=x2d.device)
    me = torch.softmax(logits, -1).mean(0)
    ce = (idx[:, 0, None] == experts).float().mean(0)
    aux = m.aux_loss_coef * e * (me * ce).sum()
    counts = (idx.reshape(-1, 1) == experts).float().sum(0)
    return y, aux, counts


def _moe(p: dict, cfg: ModelConfig, x2d: torch.Tensor, groups):
    """(y [T, d] in x2d's type, router logits [T, E], idx [T, k])."""
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
    r = _route(idx.reshape(g, tg, k), e, cap)
    buf = _Dispatch.apply(x2d.reshape(g, tg, d), r, e, cap)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["experts_w1"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["experts_w3"])
    out = torch.einsum("gecf,efd->gecd", h, p["experts_w2"])
    y = _Combine.apply(out, weights.reshape(g, tg, k), r).reshape(t, d)
    return y.to(x2d.dtype), logits, idx
