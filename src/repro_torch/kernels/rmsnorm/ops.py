"""rmsnorm: RMSNorm over the last axis, float32 math.

`rmsnorm` dispatches by device (`kernels/common.py`): CPU tensors take
the plain version `rmsnorm_ref`, CUDA tensors launch the hand-written
kernel `csrc/rmsnorm.cu`, which replaces the Pallas TPU kernel
`rmsnorm_pallas` (src/repro/kernels/rmsnorm/kernel.py:24) and, like it,
takes any d.  The source note there gives the kernel's design and its
bound.

Training: `rmsnorm` goes through the `torch.autograd.Function`
`_RMSNorm` when grad mode is on and x or w requires grad (otherwise it
launches as before).  Its forward is the same dispatch; its backward is
`rmsnorm_bwd`, which launches the hand-written kernel
`csrc/rmsnorm_bwd.cu` on CUDA tensors and takes the plain version
`rmsnorm_bwd_ref` (the explicit vjp) on CPU tensors.  The Pallas kernel
is forward only; the JAX package differentiates its jnp form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain version: x * rsqrt(mean(x^2) + eps) * w in float32, cast to
    x's type.  x [..., d] float32/bfloat16; w [d]."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _launch(x, w, eps):
    d = x.shape[-1]
    code = common.float_code(x, "x")
    x = x.contiguous()
    common.require(w, "w", torch.float32, (d,))
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    common.launch("rmsnorm", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_int], x.device,
                  common.ptr(x), common.ptr(w), common.ptr(y), rows, d,
                  eps, code)
    rmsnorm.launches += 1
    return y


def _forward(x, w, eps):
    if common.on_cuda(x, w):
        return _launch(x, w, eps)
    return rmsnorm_ref(x, w, eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x [..., d] with scale w [d] float32 (see `rmsnorm_ref`);
    differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


rmsnorm.launches = 0

# the widest row the backward kernel takes: the dw partial row of its
# CTA-a-row instance in shared memory (csrc/rmsnorm_bwd.cu kMaxD)
BWD_MAX_D = 227 * 1024 // 4 - 16
# the backward's rows kernel: at most one CTA a streaming multiprocessor
# of the H100, each taking a run of consecutive rows and writing one dw
# partial row
BWD_CTAS = 132


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """Plain version of the backward, the explicit vjp of `rmsnorm_ref`:
    with r = rsqrt(mean(x^2) + eps) and g = dy * w, dx = r * g - r^3 * x
    * mean(g * x) in x's type and dw = sum over rows of dy * x * r in
    float32.  x, dy [..., d] of one type; w [d]."""
    d = x.shape[-1]
    xf, gy = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    g = gy * w.float()
    dx = r * g - (r * r * r) * xf * (g * xf).mean(-1, keepdim=True)
    dw = (gy * (xf * r)).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw


def _launch_bwd(x, w, dy, eps):
    d = x.shape[-1]
    code = common.float_code(x, "x")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel takes d <= {BWD_MAX_D}, "
                         f"got {d}")
    x, dy = x.contiguous(), dy.contiguous()
    common.require(dy, "dy", x.dtype, tuple(x.shape))
    common.require(w, "w", torch.float32, (d,))
    rows = x.numel() // d if d else 0
    per = common.cdiv(rows, min(rows, BWD_CTAS)) if rows else 0
    n_cta = common.cdiv(rows, per) if rows else 0
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty((max(n_cta, 1), d), dtype=torch.float32,
                          device=x.device)
    common.launch("rmsnorm_bwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_int], x.device,
                  *(common.ptr(t) for t in (x, w, dy, dx, dw, partial)),
                  rows, d, n_cta, per, eps, code)
    rmsnorm_bwd.launches += 1
    return dx, dw


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """(dx, dw) of RMSNorm at x [..., d], w [d] float32 for the output's
    cotangent dy (see `rmsnorm_bwd_ref`)."""
    if common.on_cuda(x, w, dy):
        return _launch_bwd(x, w, dy, eps)
    return rmsnorm_bwd_ref(x, w, dy, eps)


rmsnorm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The kernel forward and the backward kernel as one differentiable
    operation (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None
