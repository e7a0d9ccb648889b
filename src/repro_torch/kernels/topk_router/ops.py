"""topk_router: the MoE router (softmax over E, top-k, renormalise).

`topk_router` dispatches by device (`kernels/common.py`): CPU tensors
take the plain version `topk_router_ref`, CUDA tensors launch the
hand-written kernel `csrc/topk_router.cu`, which replaces the Pallas TPU
kernel `topk_router_pallas` (src/repro/kernels/topk_router/kernel.py:43).
The source note there gives the kernel's design and its bound.

Training: `topk_router` goes through the `torch.autograd.Function`
`_TopkRouter` when grad mode is on and the logits require grad
(otherwise it launches as before).  The gradient reaches the logits
through the weights only; the indices are not differentiable.  Its
backward is `topk_router_bwd`, which launches the hand-written kernel
`csrc/topk_router_bwd.cu` on CUDA tensors and takes the plain version
`topk_router_bwd_ref` (the explicit vjp) on CPU tensors.  The Pallas
kernel is forward only; the JAX package differentiates its jnp form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
MAX_E = 256             # 8 experts a lane in csrc/topk_router.cu
MAX_K = 32              # lane r keeps round r


def topk_router_ref(logits: torch.Tensor, k: int):
    """Plain version: logits [T, E] float32 -> (weights [T, k] float32,
    idx [T, k] int32) in descending order.  k rounds of first-index
    argmax-and-mask over the softmax, then weights / max(sum, 1e-30)
    with the sum taken in round order."""
    x = logits.float()
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    rem = e / e.sum(-1, keepdim=True)
    vals, idxs = [], []
    for _ in range(k):
        v, i = rem.max(-1)       # torch.max: the first maximal index
        vals.append(v)
        idxs.append(i)
        rem = rem.scatter(-1, i[:, None], NEG_INF)
    total = torch.zeros_like(vals[0])
    for v in vals:
        total = total + v
    total = total.clamp(min=1e-30)
    return (torch.stack([v / total for v in vals], -1),
            torch.stack(idxs, -1).to(torch.int32))


def _launch(logits, k):
    t, e = logits.shape
    if not (1 <= k <= e <= MAX_E and k <= MAX_K):
        raise ValueError(f"topk_router kernel takes E <= {MAX_E} and "
                         f"1 <= k <= min(E, {MAX_K}), got k={k} E={e}")
    common.require(logits, "logits", torch.float32, (t, e))
    w = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    common.launch("topk_router", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
                  logits.device, common.ptr(logits), common.ptr(w),
                  common.ptr(idx), t, e, k)
    topk_router.launches += 1
    return w, idx


def _forward(logits, k):
    if common.on_cuda(logits):
        return _launch(logits, k)
    return topk_router_ref(logits, k)


def topk_router(logits: torch.Tensor, k: int):
    """(weights [T, k] float32, idx [T, k] int32) of the router logits
    [T, E] float32 (see `topk_router_ref`); the weights are
    differentiable in the logits."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _TopkRouter.apply(logits, k)
    return _forward(logits, k)


topk_router.launches = 0


def topk_router_bwd_ref(w: torch.Tensor, idx: torch.Tensor,
                        dw: torch.Tensor, e: int) -> torch.Tensor:
    """Plain version of the backward, the explicit vjp of
    `topk_router_ref` in the logits: dlogits [T, e] float32 with
    dlogits[t, idx[t, j]] = w[t, j] * (dw[t, j] - sum_l w[t, l] *
    dw[t, l]) and 0 elsewhere."""
    c = (w * dw).sum(-1, keepdim=True)
    out = torch.zeros((w.shape[0], e), dtype=torch.float32, device=w.device)
    return out.scatter(-1, idx.long(), w * (dw - c))


def _launch_bwd(w, idx, dw, e):
    t, k = w.shape
    if not (1 <= k <= e <= MAX_E and k <= MAX_K):
        raise ValueError(f"topk_router_bwd kernel takes E <= {MAX_E} and "
                         f"1 <= k <= min(E, {MAX_K}), got k={k} E={e}")
    dw = dw.contiguous()
    common.require(w, "w", torch.float32, (t, k))
    common.require(idx, "idx", torch.int32, (t, k))
    common.require(dw, "dw", torch.float32, (t, k))
    out = torch.empty((t, e), dtype=torch.float32, device=w.device)
    common.launch("topk_router_bwd", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 3, w.device, common.ptr(w),
                  common.ptr(idx), common.ptr(dw), common.ptr(out), t, e, k)
    topk_router_bwd.launches += 1
    return out


def topk_router_bwd(w: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
                    e: int) -> torch.Tensor:
    """dlogits [T, e] float32 of the router for the weights' cotangent dw
    [T, k] (see `topk_router_bwd_ref`)."""
    if common.on_cuda(w, idx, dw):
        return _launch_bwd(w, idx, dw, e)
    return topk_router_bwd_ref(w, idx, dw, e)


topk_router_bwd.launches = 0


class _TopkRouter(torch.autograd.Function):
    """The router kernel and its backward kernel as one differentiable
    operation (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = _forward(logits, k)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(w, idx)
        ctx.e = logits.shape[-1]
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        w, idx = ctx.saved_tensors
        if dw is None:
            return None, None
        return topk_router_bwd(w, idx, dw, ctx.e), None
