"""flash_attention: causal GQA attention forward over one sequence.

`flash_attention` dispatches by device (`kernels/common.py`): CPU tensors
take the plain version `flash_attention_ref`, CUDA tensors launch the
hand-written kernel `csrc/flash_attention.cu`, which replaces the Pallas
TPU kernel `flash_attention_pallas`
(src/repro/kernels/flash_attention/kernel.py:72).  Unlike that kernel it
takes any S (prompts are ragged).  The source note there gives the
kernel's design and its bound.

Training: `flash_attention` goes through the `torch.autograd.Function`
`_FlashAttention` when grad mode is on and an input requires grad
(otherwise it launches the serving instance as before).  Its forward is
`flash_attention_lse`, the kernel's training instance, which also writes
each row's log-sum-exp (plain version `flash_attention_lse_ref`); its
backward is `flash_attention_bwd`, which launches the hand-written
kernel `csrc/flash_attention_bwd.cu` on CUDA tensors and takes the plain
version `flash_attention_bwd_ref` (the explicit vjp) on CPU tensors.  The
Pallas kernel is forward only; the JAX package differentiates its jnp
form `blockwise_attention`.
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


def _check(q, k, v, name):
    """(dtype code, B, Hq, Hkv, S, D) of the kernels' operands; raises on
    what they do not take."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    code = common.float_code(q, "q")
    if d not in HEAD_DIMS or hkv == 0 or hq % hkv:
        raise ValueError(f"{name} kernel takes D in {HEAD_DIMS} and "
                         f"Hq % Hkv == 0, got D={d} Hq={hq} Hkv={hkv}")
    common.require(q, "q", q.dtype, (b, hq, s, d))
    common.require(k, "k", q.dtype, (b, hkv, s, d))
    common.require(v, "v", q.dtype, (b, hkv, s, d))
    return code, b, hq, hkv, s, d


def _launch(q, k, v, scale):
    code, b, hq, hkv, s, d = _check(q, k, v, "flash_attention")
    o = torch.empty_like(q)
    common.launch("flash_attention", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                  q.device, *(common.ptr(t) for t in (q, k, v, o)), b, hq,
                  hkv, s, d, scale, code)
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, scale: float | None = None) -> torch.Tensor:
    """[B, Hq, S, D] causal attention output (see `flash_attention_ref`);
    differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    if common.on_cuda(q, k, v):
        return _launch(q, k, v, scale)
    return flash_attention_ref(q, k, v, scale=scale)


flash_attention.launches = 0


# ------------------------------------------------------------- training


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float | None = None):
    """Plain version of the training instance: (the output of
    `flash_attention_ref`, lse [B, Hq, S] float32), lse the natural
    log-sum-exp of each row's scaled, causally masked scores."""
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
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p @ vf) / l.clamp(min=1e-30)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _launch_lse(q, k, v, scale):
    code, b, hq, hkv, s, d = _check(q, k, v, "flash_attention_lse")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    common.launch("flash_attention", [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                  q.device, *(common.ptr(t) for t in (q, k, v, o, lse)), b,
                  hq, hkv, s, d, scale, code, entry="flash_attention_lse")
    flash_attention_lse.launches += 1
    return o, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None):
    """(output [B, Hq, S, D], lse [B, Hq, S] float32) of causal attention
    (see `flash_attention_lse_ref`): the forward that training saves."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if common.on_cuda(q, k, v):
        return _launch_lse(q, k, v, scale)
    return flash_attention_lse_ref(q, k, v, scale=scale)


flash_attention_lse.launches = 0


def flash_attention_bwd_ref(q, k, v, o, do, lse, *,
                            scale: float | None = None):
    """Plain version of the backward, the explicit vjp of causal
    attention in float32: P = exp(scale * q.k^T - lse) (masked), dV =
    P^T dO and dK = scale * dS^T q summed over each kv head's group of q
    heads, dQ = scale * dS k, with dS = P * (dO v^T - rowsum(dO * o)).
    Gradients in the inputs' type."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    p = torch.where(mask, torch.exp((qf @ kf.transpose(-1, -2)) * scale
                                    - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).reshape(b, hkv, group, n, d)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, group, n, d)
    return dq.to(q.dtype), dk.sum(2).to(k.dtype), dv.sum(2).to(v.dtype)


def _launch_bwd(q, k, v, o, do, lse, scale):
    code, b, hq, hkv, s, d = _check(q, k, v, "flash_attention_bwd")
    o, do = o.contiguous(), do.contiguous()
    common.require(o, "o", q.dtype, tuple(q.shape))
    common.require(do, "do", q.dtype, tuple(q.shape))
    common.require(lse, "lse", torch.float32, (b, hq, s))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Di for the CUDA-core kernels, or each 64-row q tile's lse and Di
    # block (2 x 64 float32) for the wgmma kernel
    scratch = torch.empty(b * hq * common.cdiv(s, 64) * 128,
                          dtype=torch.float32, device=q.device)
    common.launch("flash_attention_bwd", [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                  q.device, *(common.ptr(t) for t in (
                      q, k, v, o, do, lse, dq, dk, dv, scratch)),
                  b, hq, hkv, s, d, scale, code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, *, scale: float | None = None):
    """(dQ, dK, dV) of causal attention for the output's cotangent `do`,
    from the training forward's output `o` and `lse` (see
    `flash_attention_bwd_ref`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if common.on_cuda(q, k, v, o, do, lse):
        return _launch_bwd(q, k, v, o, do, lse, scale)
    return flash_attention_bwd_ref(q, k, v, o, do, lse, scale=scale)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The training instance and the backward kernel as one
    differentiable operation (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         scale=ctx.scale)
        return dq, dk, dv, None
