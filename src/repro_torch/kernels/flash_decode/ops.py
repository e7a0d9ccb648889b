"""flash_decode: one-token attention over a KV cache with a valid prefix.

`flash_decode` dispatches by device (`kernels/common.py`): CPU tensors
take the plain version `flash_decode_ref`, CUDA tensors launch the
hand-written kernel `csrc/flash_decode.cu`, which replaces the Pallas TPU
kernel `flash_decode_pallas` (src/repro/kernels/flash_decode/kernel.py:62).

Both follow the rounding points of the model's decode attention
(`repro.models.layers.decode_attention`, the function on the serving
path), not those of `repro.kernels.flash_decode.ref`: q * scale and p are
rounded to the cache's type, scores and P.V sum in float32, and the
softmax is normalised before P.V.  In float32 the roundings vanish and
the two are the same function; in bfloat16 they differ, and the port
matches the JAX model.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
MAX_GROUP = 8           # DEC_MAX_GROUP in csrc/flash_decode.cu
SMEM_BYTES = 227 * 1024


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Plain version.  q [B, Hq, D]; k, v [B, Hkv, S, D]; kv_len [B] int32
    (positions >= kv_len are masked at -1e30).  Returns [B, Hq, Dv] in
    q's type."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    qg = (q.float() * scale).to(k.dtype).reshape(b, hkv, group, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float())
    pos = torch.arange(s, device=q.device)
    logits = torch.where(pos < kv_len.reshape(b, 1, 1, 1), logits, NEG_INF)
    p = torch.exp(logits - logits.max(-1, keepdim=True).values)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, v.shape[-1]).to(q.dtype)


def _launch(q, k, v, kv_len, scale):
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    code = common.float_code(q, "q")
    group = hq // hkv if hkv else 0
    smem = 4 * group * (s + d)
    if hkv == 0 or hq % hkv or group > MAX_GROUP or smem > SMEM_BYTES:
        raise ValueError(f"flash_decode kernel takes Hq % Hkv == 0, group <= "
                         f"{MAX_GROUP} and 4*group*(S+D) <= {SMEM_BYTES} B, "
                         f"got Hq={hq} Hkv={hkv} S={s} D={d}")
    common.require(q, "q", q.dtype, (b, hq, d))
    common.require(k, "k", q.dtype, (b, hkv, s, d))
    common.require(v, "v", q.dtype, (b, hkv, s, d))
    common.require(kv_len, "kv_len", torch.int32, (b,))
    out = torch.empty_like(q)
    common.launch("flash_decode", [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                  q.device, *(common.ptr(t) for t in (q, k, v, kv_len, out)),
                  b, hq, hkv, s, d, scale, code)
    flash_decode.launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 scale: float | None = None) -> torch.Tensor:
    """[B, Hq, D] decode attention output (see `flash_decode_ref`); the
    kernel takes kv_len >= 1, as the serving path always has."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if common.on_cuda(q, k, v, kv_len):
        return _launch(q, k, v, kv_len, scale)
    return flash_decode_ref(q, k, v, kv_len, scale=scale)


flash_decode.launches = 0
