"""topk_router: the MoE router (softmax over E, top-k, renormalise).

`topk_router` dispatches by device (`kernels/common.py`): CPU tensors
take the plain version `topk_router_ref`, CUDA tensors launch the
hand-written kernel `csrc/topk_router.cu`, which replaces the Pallas TPU
kernel `topk_router_pallas` (src/repro/kernels/topk_router/kernel.py:43).
The source note there gives the kernel's design and its bound.
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


def topk_router(logits: torch.Tensor, k: int):
    """(weights [T, k] float32, idx [T, k] int32) of the router logits
    [T, E] float32 (see `topk_router_ref`)."""
    if common.on_cuda(logits):
        return _launch(logits, k)
    return topk_router_ref(logits, k)


topk_router.launches = 0
