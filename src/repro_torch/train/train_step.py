"""Train step (`repro.train.train_step`): value and gradient, microbatch
gradient accumulation, optimizer.

Microbatching splits [GB, ...] into n_micro microbatches of GB / n_micro
rows and runs the forward and backward of each in turn, adding each
one's gradients in float32 as g / n_micro in microbatch order, into one
float32 tree (what bounds activation memory; remat happens inside the
model's layer loop).  The gradients are cast to each parameter's type
before the update, and the float32 tree is dropped before it.  A
step is eager PyTorch: every gradient comes from `torch.autograd.grad`
on a fresh graph, and nothing is left on the parameters.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import apply_updates, tree_leaves, \
    tree_map


def _split_micro(batch: dict, n_micro: int) -> list:
    def f(x):
        gb = x.shape[0]
        assert gb % n_micro == 0, (gb, n_micro)
        return x.reshape(n_micro, gb // n_micro, *x.shape[1:])
    split = {k: f(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in split.items()} for i in range(n_micro)]


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """((loss, metrics) detached, grads in the parameters' tree) of
    loss_fn(params, batch) -> (loss, metrics)."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(x): torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, grads)}
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda x: by_leaf[id(x)], live)


def make_train_step(model: Model, opt_init, opt_update,
                    n_micro: Optional[int] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "gnorm"})."""
    del opt_init

    def train_step(params, opt_state, batch):
        if n_micro and n_micro > 1:
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_acc = None
            for mb in _split_micro(batch, n_micro):
                (loss, _), grads = value_and_grad(model.loss, params, mb)
                div = loss.new_tensor(float(n_micro))
                tree_map(lambda a, g: a.add_(g.float() / div), g_acc, grads)
                del grads
                loss_acc = (loss.new_zeros(()) if loss_acc is None
                            else loss_acc) + loss / div
            grads, metrics = g_acc, {"loss": loss_acc}
            del g_acc
        else:
            (_, metrics), grads = value_and_grad(model.loss, params, batch)
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        updates, opt_state, gnorm = opt_update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": metrics.get("loss", 0.0),
                                   "gnorm": gnorm}

    return train_step
