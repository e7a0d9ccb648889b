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

The kernel has two instances (`_launch` picks one by type and D):
bfloat16 at a D of MMA_HEAD_DIMS takes `mma_decode_kernel`, one cluster
of 8 CTAs a (row, kv-head) whatever the GQA group, its dot products on
tensor cores; every other call takes `decode_kernel` on CUDA cores, a
group above MAX_GROUP heads in sub-groups (`sub_groups`).  Both are
bound by bytes (the valid prefix of K and V read once: 5.06 us at
qwen2.5-32b's bf16 serving shape on the H100).  On an NVIDIA H100 80GB
HBM3 at 700 W (PERF.md §6, medians of 20; bf16, B=8, S=512, D=128) the
tensor-core instance takes 8.95 / 9.67 / 38.63 us at groups 5 / 12 / 1,
where the CUDA-core one took 29.89 / 53.35 / 48.39 and SDPA ~13.7 /
13.7 / 41; granite's decode (D=64) 5.76 us against 6.55.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
MAX_GROUP = 4           # DEC_MAX_GROUP in csrc/flash_decode.cu: heads a
                        # cluster of the CUDA-core instance computes; a
                        # larger group splits
CLUSTER = 8             # DEC_CLUSTER: CTAs that split one row's cache
WARPS = 8               # DEC_WARPS, the CUDA-core instance's
SMEM_BYTES = 227 * 1024
MMA_HEAD_DIMS = (64, 128)  # bf16 head dims of the tensor-core instance
MMA_ROWS = 64           # DMMA_ROWS: cache rows of a chunk in shared memory
MMA_HEADS = 16          # DMMA_HEADS: heads of an M-tile
MMA_WARPS = 4           # DMMA_THREADS / 32


def uses_mma(dtype: torch.dtype, d: int) -> bool:
    """The instance rule: bfloat16 at a head dim of MMA_HEAD_DIMS takes
    the tensor-core instance, every other call the CUDA-core one."""
    return dtype == torch.bfloat16 and d in MMA_HEAD_DIMS


def sub_groups(group: int) -> tuple:
    """The CUDA-core instance's clusters a (row, kv-head) pair and heads
    of the largest: a GQA group of more than MAX_GROUP heads splits into
    the fewest sub-groups of at most MAX_GROUP, as equal as they come
    (n_sub / sub_group in the source; 5 -> 3 + 2, 12 -> 3 of 4)."""
    n = common.cdiv(group, MAX_GROUP)
    return n, common.cdiv(group, n)


def smem_bytes(group: int, s: int, d: int) -> int:
    """Shared memory of one CTA of the CUDA-core instance for a cluster of
    `group` heads (a sub-group: at most MAX_GROUP), float32: the warps'
    partial P.V ([8, group, D]), the ranks' partials that rank 0 adds
    ([8, group, D]), the share's scores ([group, ceil(S/8)]) and the
    ranks' (max, sum) pairs ([8, group, 2])."""
    return 4 * group * (d * (WARPS + CLUSTER) + common.cdiv(s, CLUSTER)
                        + 2 * CLUSTER)


def mma_smem_bytes(group: int, d: int) -> int:
    """Shared memory of one CTA of the tensor-core instance (`MmaLayout`
    in the source), whatever S: a chunk's K and V rows ([MMA_ROWS, D]
    bf16), the q tile ([MMA_HEADS, D] bf16, whose place p of the chunk,
    [MMA_HEADS, MMA_ROWS] bf16, takes later), the warps' and the ranks'
    (max, sum) pairs and the ranks' partial P.V of the rank's D/8
    columns ([8, min(group, MMA_HEADS), D/8] float32)."""
    return (2 * MMA_ROWS * 2 * d + MMA_HEADS * 2 * max(d, MMA_ROWS)
            + 8 * MMA_HEADS * (MMA_WARPS + CLUSTER)
            + 4 * CLUSTER * min(group, MMA_HEADS) * (d // 8))


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
    """One launch of the instance that `uses_mma` picks; what neither
    takes raises ValueError before any launch.  The tensor-core instance
    takes any group and S (its shared memory does not grow with S); the
    CUDA-core one takes D * element size a power-of-two multiple of 16
    bytes up to 512 and its sub-group's scores in shared memory."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    code = common.float_code(q, "q")
    mma = uses_mma(q.dtype, d)
    if not hkv or hq % hkv:
        raise ValueError(f"flash_decode kernel takes Hq % Hkv == 0, got "
                         f"Hq={hq} Hkv={hkv}")
    lanes = d * q.element_size() // 16      # 16-byte loads per cache row
    if not mma and (smem_bytes(sub_groups(hq // hkv)[1], s, d) > SMEM_BYTES
                    or lanes * 16 != d * q.element_size()
                    or not 1 <= lanes <= 32 or lanes & (lanes - 1)):
        raise ValueError(f"flash_decode kernel (CUDA-core instance) takes "
                         f"D * element size a power-of-two multiple of 16 "
                         f"bytes up to 512 and 4*gs*(16*D + ceil(S/8) + 16) "
                         f"<= {SMEM_BYTES} B (gs: the sub-group, at most "
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
    ptrs = [common.ptr(t) for t in (q, k, v, kv_len, out)]
    if mma:
        common.launch("flash_decode", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 5 + [ctypes.c_float], q.device,
                      *ptrs, b, hq, hkv, s, d, scale,
                      entry="flash_decode_mma")
    else:
        common.launch("flash_decode", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int],
                      q.device, *ptrs, b, hq, hkv, s, d, scale, code)
    flash_decode.launches += 1
    return out


def resident_clusters(hq: int, hkv: int, s: int, d: int,
                      dtype: torch.dtype) -> int:
    """Clusters of 8 CTAs of the instance `uses_mma` picks that the card
    holds at once for this shape (`cudaOccupancyMaxActiveClusters`); a
    launch of more (B * Hkv for the tensor-core instance, B * Hkv *
    sub-groups for the CUDA-core one) runs in waves.  Needs the card."""
    lib = common.library("flash_decode")
    if uses_mma(dtype, d):
        fn = lib.flash_decode_mma_resident_clusters
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return fn(hq, hkv, d)
    fn = lib.flash_decode_resident_clusters
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(hq, hkv, s, d, common.FLOAT_CODES[dtype])


def clusters(b: int, hq: int, hkv: int, d: int, dtype: torch.dtype) -> int:
    """Clusters one call launches: B * Hkv for the tensor-core instance,
    B * Hkv * sub-groups for the CUDA-core one."""
    per = 1 if uses_mma(dtype, d) else sub_groups(hq // hkv)[0]
    return b * hkv * per


def mma_attributes(d: int) -> dict:
    """The tensor-core instance's registers a thread and local memory a
    thread (spills, bytes) at head dim `d`, as the loaded module reports
    them (`cudaFuncGetAttributes`).  Needs the card."""
    fn = common.library("flash_decode").flash_decode_mma_attributes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = fn(d, ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"flash_decode_mma_attributes: error {err}")
    return {"registers": regs.value, "local_bytes": local.value}


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
