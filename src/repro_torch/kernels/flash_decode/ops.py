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
MAX_GROUP = 4           # DEC_MAX_GROUP in csrc/flash_decode.cu: heads a
                        # cluster computes; a larger group splits
CLUSTER = 8             # DEC_CLUSTER: CTAs that split one row's cache
WARPS = 8               # DEC_WARPS
SMEM_BYTES = 227 * 1024


def sub_groups(group: int) -> tuple:
    """(clusters a (row, kv-head) pair, heads of the largest): a GQA
    group of more than MAX_GROUP heads splits into the fewest sub-groups
    of at most MAX_GROUP, as equal as they come (n_sub / sub_group in the
    source; qwen2.5-32b's 5 -> 3 + 2, mistral-large-123b's 12 -> 3 of
    4)."""
    n = common.cdiv(group, MAX_GROUP)
    return n, common.cdiv(group, n)


def smem_bytes(group: int, s: int, d: int) -> int:
    """Shared memory of one CTA of the kernel for a cluster of `group`
    heads (a sub-group: at most MAX_GROUP), float32: the warps' partial
    P.V ([8, group, D]), the ranks' partials that rank 0 adds ([8, group,
    D]), the share's scores ([group, ceil(S/8)]) and the ranks' (max,
    sum) pairs ([8, group, 2])."""
    return 4 * group * (d * (WARPS + CLUSTER) + common.cdiv(s, CLUSTER)
                        + 2 * CLUSTER)


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
    gs = sub_groups(hq // hkv)[1] if hkv and hq % hkv == 0 else 0
    lanes = d * q.element_size() // 16      # 16-byte loads per cache row
    if not gs or smem_bytes(gs, s, d) > SMEM_BYTES \
            or lanes * 16 != d * q.element_size() or not 1 <= lanes <= 32 \
            or lanes & (lanes - 1):
        raise ValueError(f"flash_decode kernel takes Hq % Hkv == 0, D * "
                         f"element size a power-of-two multiple of 16 bytes "
                         f"up to 512 and 4*gs*(16*D + ceil(S/8) + 16) <= "
                         f"{SMEM_BYTES} B (gs: the sub-group, at most "
                         f"{MAX_GROUP} heads), got Hq={hq} Hkv={hkv} S={s} "
                         f"D={d} {q.dtype}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode kernel: k and v must start on 16 "
                         "bytes")
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


def resident_clusters(hq: int, hkv: int, s: int, d: int,
                      dtype: torch.dtype) -> int:
    """Clusters of 8 CTAs of the kernel that the card holds at once for
    this shape (`cudaOccupancyMaxActiveClusters`); a launch of B * Hkv *
    sub-groups clusters beyond it runs in waves.  Needs the card."""
    fn = common.library("flash_decode").flash_decode_resident_clusters
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(hq, hkv, s, d, common.FLOAT_CODES[dtype])


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
