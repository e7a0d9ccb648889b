"""Optimizers (`repro.optim.optimizers`): AdamW (float32 moments) and
Adafactor (factored second moments), as the JAX package's functional
API: `make_optimizer` returns (init_fn, update_fn) on parameter trees,
nested dicts of tensors.

`update_fn(grads, state, params) -> (updates, state, gnorm)` clips the
gradients to a global norm first (each leaf scaled as its update uses
it, so no clipped copy of the tree is held); `apply_updates` adds the
updates in each parameter's type.  Moments are float32 and the step
counter is an int32 0-d tensor, all on the parameters' device, so a
step makes no host round trip.  AdamW updates its moments in place: the
state passed in is consumed, as a donated buffer is under `jax.jit`,
and the new state holds the same tensors (two float32 copies of the
model's moments would not fit the card beside the model at the dense
configs' widths).  Leaves are visited in sorted-key order, as
`jax.tree.leaves` orders a dict, which fixes the order of the global
norm's sum.
"""
from __future__ import annotations

import math

import torch


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and of the same-shaped `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (`jax.tree.leaves`'s order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def cosine_schedule(base_lr: float, warmup: int = 100, total: int = 10000,
                    min_frac: float = 0.1):
    """lr(step): linear warm-up over `warmup` steps, then a cosine decay
    to min_frac * base_lr at `total`; float32 0-d tensor on step's
    device.  The divisions are by 0-d tensors: on CUDA a division by a
    Python number is a product with its rounded reciprocal."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = step / step.new_tensor(max(warmup, 1))
        prog = ((step - warmup) / step.new_tensor(max(total - warmup, 1))
                ).clamp(0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * torch.clamp(warm, max=1.0) * cos
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(tree, max_norm: float):
    """(the factor that scales `tree` to a global norm of at most
    max_norm, the norm); a leaf x clipped is x * scale.to(x.dtype)."""
    n = global_norm(tree)
    scale = torch.clamp(n.new_tensor(max_norm) / n.clamp(min=1e-9), max=1.0)
    return scale, n


def _zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ----------------------------------------------------------------- AdamW


def make_adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=1.0):
    def init(params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, clip_norm)
        lr = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(g, m, v, p):
            gf = (g * scale.to(g.dtype)).float()
            m.mul_(b1).add_((1 - b1) * gf)          # b1 * m + (1 - b1) * g
            v.mul_(b2).add_((1 - b2) * gf * gf)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, grads, state["m"], state["v"], params)
        return updates, {"m": state["m"], "v": state["v"],
                         "step": step}, gnorm

    return init, update


# -------------------------------------------------------------- Adafactor


def make_adafactor(lr_fn, eps=1e-30, clip_threshold=1.0, decay=0.8,
                   weight_decay=0.0, clip_norm=1.0):
    """Factored second moments (row and column statistics) for
    parameters of two or more dimensions, a full one below that."""

    def init(params):
        def one(p):
            if p.dim() >= 2:
                return {"vr": _zeros(p, p.shape[:-1]),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros(p)}
        return {"f": tree_map(one, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, clip_norm)
        lr = lr_fn(step)
        beta = 1.0 - step.float() ** -decay

        def upd(g, p, f):
            gf = (g * scale.to(g.dtype)).float()
            g2 = gf * gf + eps
            if p.dim() >= 2:
                vr = beta * f["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * f["vc"] + (1 - beta) * g2.mean(-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps))
                cfac = torch.rsqrt(vc)
                u = gf * rfac[..., None] * cfac[..., None, :]
                nf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(v)
                nf = {"v": v}
            rms_u = torch.sqrt((u * u).mean() + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype), nf

        # the factored state sits one dict below each parameter leaf
        out = tree_map(lambda g, p: (g, p), grads, params)
        out = _map_leaf_pairs(upd, out, state["f"])
        updates, nf = _unzip(out, 2)
        return updates, {"f": nf, "step": step}, gnorm

    return init, update


def _map_leaf_pairs(fn, pairs, fstate):
    """fn(g, p, f) over a tree of (g, p) leaves and the state tree whose
    leaves are the dicts {"vr", "vc"} or {"v"}; a tree of fn's tuples."""
    if isinstance(pairs, dict):
        return {k: _map_leaf_pairs(fn, v, fstate[k])
                for k, v in pairs.items()}
    return fn(*pairs, fstate)


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total_steps: int = 10000, **kw):
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    if name == "adamw":
        return make_adamw(lr_fn, **kw)
    if name == "adafactor":
        return make_adafactor(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
