"""The selective-flush family: the gather-compact of dirty blocks, its
scatter inverse, and the protocol engine's drain/writeback merge.

* `selective_flush` compacts the bank rows a dirty-block list names into
  a dense buffer (the cross-pod sync's flush, `distributed.hier_sync`);
  CUDA tensors launch `csrc/selective_flush.cu`, which replaces the
  Pallas TPU kernel `selective_flush_pallas`
  (src/repro/kernels/selective_flush/kernel.py:38).
* `selective_apply` scatters compacted rows back.  It is plain PyTorch
  on every device, as the JAX package leaves it to XLA's scatter.
* `drain_writeback` merges drained L1 blocks into the L2 bank under a
  packed per-word dirty mask (`protocol.b_drain`, `protocol.b_writeback`);
  CUDA tensors launch `csrc/drain_writeback.cu`, which replaces
  `drain_writeback_pallas` (kernel.py:93).

Each kernel wrapper dispatches by device (`kernels/common.py`): CPU
tensors take the plain version `<name>_ref`.  The source notes give each
kernel's design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitmask
from repro_torch.kernels import common

I32 = torch.int32
# drain_writeback's tile holds at least one bank row's owner map in 48 KB
# of shared memory (csrc/drain_writeback.cu kOwnerWords)
MAX_WRITEBACK_WORDS = 48 * 1024 // 4


def selective_flush_ref(bank: torch.Tensor, indices: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version: out[i] = bank[clip(indices[i], 0, nb-1)], and a zero
    row where indices[i] < 0.

    bank [nb, bs]; indices [k] int32 (-1 pads).  Returns [k, bs] in the
    bank's dtype."""
    safe = indices.clamp(0, bank.shape[0] - 1).long()
    out = bank.index_select(0, safe)
    return torch.where((indices >= 0)[:, None], out, torch.zeros_like(out))


def _flush_launch(bank, indices):
    nb, bs = bank.shape
    k = indices.shape[0]
    common.float_code(bank, "bank")
    common.require(bank, "bank", bank.dtype, (nb, bs))
    common.require(indices, "indices", I32, (k,))
    if nb < 1:
        raise ValueError("selective_flush: the bank has no rows")
    out = torch.empty((k, bs), dtype=bank.dtype, device=bank.device)
    if k and bs:
        common.launch("selective_flush", [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 2 + [ctypes.c_longlong],
                      bank.device, common.ptr(bank), common.ptr(indices),
                      common.ptr(out), nb, k, bs * bank.element_size())
        selective_flush.launches += 1
    return out


def selective_flush(bank: torch.Tensor, indices: torch.Tensor
                    ) -> torch.Tensor:
    """Compact the bank rows named by `indices` (-1 padded) into a dense
    [k, bs] buffer (see `selective_flush_ref`)."""
    if common.on_cuda(bank, indices):
        return _flush_launch(bank, indices)
    return selective_flush_ref(bank, indices)


selective_flush.launches = 0


def selective_apply(bank: torch.Tensor, updates: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """Scatter inverse of `selective_flush`: a fresh bank with
    bank[indices[i]] = updates[i] for every entry in [0, nb); pads (-1)
    and indices >= nb write nothing.  Where an index repeats, the last
    entry wins (a priority owner map, so the result does not depend on
    the device's scatter order).

    bank [nb, bs]; updates [k, bs]; indices [k] int32."""
    nb = bank.shape[0]
    k = indices.shape[0]
    if k == 0:
        return bank.clone()
    g = (indices >= 0) & (indices < nb)
    dest = torch.where(g, indices, nb).long()
    prio = torch.arange(1, k + 1, dtype=I32, device=bank.device)
    # the spare row nb takes the dropped entries' writes and is sliced off
    owner = torch.zeros(nb + 1, dtype=I32, device=bank.device) \
        .scatter_reduce(0, dest, prio, "amax")[:nb]
    vals = updates.to(bank.dtype).index_select(
        0, (owner - 1).clamp(min=0).long())
    return torch.where((owner > 0)[:, None], vals, bank)


def drain_writeback_ref(l2: torch.Tensor, rows: torch.Tensor,
                        dirty: torch.Tensor, indices: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version: out[b, w] = rows[i, w] for the LAST entry i with
    indices[i] == b and word w dirty; other words keep their l2 value.
    Entries with indices outside [0, nb) write nothing.

    l2 [nb, W] int32; rows [m, W] int32; dirty [m, ceil(W/32)] int32
    packed lanes; indices [m] int32."""
    nb, w = l2.shape
    m = indices.shape[0]
    g = (indices >= 0) & (indices < nb)
    sel = bitmask.unpack(dirty, w) & g[:, None]
    prio = torch.where(sel, torch.arange(1, m + 1, dtype=I32,
                                         device=l2.device)[:, None], 0)
    dest = torch.where(g, indices, nb).long()[:, None].expand(m, w)
    # the spare row nb takes the pads' writes and is sliced off
    owner = torch.zeros((nb + 1, w), dtype=I32, device=l2.device) \
        .scatter_reduce(0, dest, prio, "amax")[:nb]
    src = (owner - 1).clamp(min=0).long()
    vals = rows.gather(0, src)
    return torch.where(owner > 0, vals, l2)


def _launch(l2, rows, dirty, indices):
    nb, w = l2.shape
    m = indices.shape[0]
    lanes = dirty.shape[-1]
    common.require(l2, "l2", I32, (nb, w))
    common.require(rows, "rows", I32, (m, w))
    common.require(dirty, "dirty", I32, (m, bitmask.n_lanes(w)))
    common.require(indices, "indices", I32, (m,))
    if w > MAX_WRITEBACK_WORDS:
        raise ValueError(f"drain_writeback kernel takes W <= "
                         f"{MAX_WRITEBACK_WORDS} words a block, got {w}")
    out = torch.empty_like(l2)
    common.launch("drain_writeback", [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 4, l2.device,
                  *(common.ptr(t) for t in (l2, rows, dirty, indices, out)),
                  nb, w, m, lanes)
    drain_writeback.launches += 1
    return out


def drain_writeback(l2: torch.Tensor, rows: torch.Tensor,
                    dirty: torch.Tensor, indices: torch.Tensor
                    ) -> torch.Tensor:
    """Merged [nb, W] bank, a fresh tensor (see `drain_writeback_ref`)."""
    if common.on_cuda(l2, rows, dirty, indices):
        return _launch(l2, rows, dirty, indices)
    return drain_writeback_ref(l2, rows, dirty, indices)


drain_writeback.launches = 0
