"""flash_attention: causal GQA attention forward over one sequence.

`flash_attention` dispatches by device (`kernels/common.py`): CPU tensors
take the plain version `flash_attention_ref`, CUDA tensors launch the
hand-written kernel `csrc/flash_attention.cu`, which replaces the Pallas
TPU kernel `flash_attention_pallas`
(src/repro/kernels/flash_attention/kernel.py:72).  Unlike that kernel it
takes any S (prompts are ragged).  The source note there gives the
kernel's design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
HEAD_DIMS = (16, 64)    # the template instances of csrc/flash_attention.cu


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None) -> torch.Tensor:
    """Plain version: causal softmax(q*scale . k^T) . v in float32, masked
    scores at -1e30, divided by max(l, 1e-30), cast to q's type.

    q [B, Hq, S, D]; k, v [B, Hkv, S, D]; Hq % Hkv == 0."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    n = q.shape[2]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, qf @ kf.transpose(-1, -2), NEG_INF)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    out = (p @ vf) / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _launch(q, k, v, scale):
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    code = common.float_code(q, "q")
    if d not in HEAD_DIMS or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS} and "
                         f"Hq % Hkv == 0, got D={d} Hq={hq} Hkv={hkv}")
    common.require(q, "q", q.dtype, (b, hq, s, d))
    common.require(k, "k", q.dtype, (b, hkv, s, d))
    common.require(v, "v", q.dtype, (b, hkv, s, d))
    o = torch.empty_like(q)
    common.launch("flash_attention", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                  q.device, *(common.ptr(t) for t in (q, k, v, o)), b, hq,
                  hkv, s, d, scale, code)
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, scale: float | None = None) -> torch.Tensor:
    """[B, Hq, S, D] causal attention output (see `flash_attention_ref`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if common.on_cuda(q, k, v):
        return _launch(q, k, v, scale)
    return flash_attention_ref(q, k, v, scale=scale)


flash_attention.launches = 0
