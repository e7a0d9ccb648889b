"""rmsnorm: RMSNorm over the last axis, float32 math.

`rmsnorm` dispatches by device (`kernels/common.py`): CPU tensors take
the plain version `rmsnorm_ref`, CUDA tensors launch the hand-written
kernel `csrc/rmsnorm.cu`, which replaces the Pallas TPU kernel
`rmsnorm_pallas` (src/repro/kernels/rmsnorm/kernel.py:24).  The source
note there gives the kernel's design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

MAX_D = 256 * 16        # RMS_THREADS * RMS_PER_THREAD in csrc/rmsnorm.cu


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
    if d > MAX_D:
        raise ValueError(f"rmsnorm kernel takes d <= {MAX_D}, got {d}")
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x [..., d] with scale w [d] float32 (see `rmsnorm_ref`)."""
    if common.on_cuda(x, w):
        return _launch(x, w, eps)
    return rmsnorm_ref(x, w, eps)


rmsnorm.launches = 0
