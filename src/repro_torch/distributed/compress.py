"""Delta compression for cross-pod traffic: per-row symmetric int8 with
error feedback, the port of `repro.distributed.compress`.

Bitwise the JAX package on the CPU and on the card: a per-row max, IEEE
division (`true_div`), `torch.round` (half to even, as `jnp.round`), a
clip to int8.  Every
function also takes leading axes before the rows (the stacked pod axis
of `hier_sync`), with one index list shared by all of them."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import common


class EFState(NamedTuple):
    err: torch.Tensor  # [..., n_blocks, block_size] f32 residual


def ef_init(n_blocks: int, block_size: int, device=None) -> EFState:
    return EFState(err=torch.zeros((n_blocks, block_size),
                                   dtype=torch.float32,
                                   device=common.resolve_device(device)))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8.  x [..., n, d] -> (q int8 [..., n, d],
    scale f32 [..., n])."""
    amax = x.abs().amax(-1)
    scale = torch.clamp(true_div(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on every device.  PyTorch's CUDA kernel turns
    a division by a Python number into a product with its reciprocal,
    which rounds twice; a 0-d tensor on x's device keeps the IEEE
    division that the CPU and the JAX package do."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def compress_blocks(delta: torch.Tensor, ef: EFState, idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, EFState]:
    """delta [..., n_blocks, bs]; idx [k] block ids (-1 pad).
    Returns (q [..., k, bs] int8, scales [..., k], ef').

    The residual write clamps pads to block 0, as the reference's
    `err.at[clip(idx)].set(...)` does, and the last list entry wins where
    a block repeats: the reference's result on the CPU, made
    deterministic by a priority owner map.  So a pad after block 0 in the
    list writes block 0's old residual back (ROADMAP Queue C)."""
    n = delta.shape[-2]
    k = idx.shape[0]
    safe = idx.clamp(0, n - 1).long()
    valid = (idx >= 0)[:, None]
    err_rows = ef.err.index_select(-2, safe)
    payload = (delta.index_select(-2, safe) + err_rows) * valid
    q, scale = quantize_int8(payload)
    recon = dequantize_int8(q, scale)
    vals = torch.where(valid, payload - recon, err_rows)
    prio = torch.arange(1, k + 1, dtype=torch.int32, device=idx.device)
    owner = torch.zeros(n, dtype=torch.int32, device=idx.device) \
        .scatter_reduce(0, safe, prio, "amax")
    src = (owner - 1).clamp(min=0).long()
    new_err = torch.where((owner > 0)[:, None], vals.index_select(-2, src),
                          ef.err)
    return q, scale, EFState(err=new_err)


def compressed_bytes(max_dirty: int, block_size: int) -> int:
    return max_dirty * block_size * 1 + max_dirty * 4  # int8 payload + scales
