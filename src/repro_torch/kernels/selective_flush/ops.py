"""drain_writeback: the protocol engine's drain/writeback scatter-merge.

Merges drained L1 blocks into the L2 bank under a packed per-word dirty
mask (`protocol.b_drain`, `protocol.b_writeback`).  `drain_writeback`
dispatches by device (`kernels/common.py`): CPU tensors take the plain
version `drain_writeback_ref`, CUDA tensors launch the hand-written
kernel `csrc/drain_writeback.cu`, which replaces the Pallas TPU kernel
`drain_writeback_pallas` (src/repro/kernels/selective_flush/kernel.py:93).
The source note there gives the kernel's design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitmask
from repro_torch.kernels import common

I32 = torch.int32


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
    out = torch.empty_like(l2)
    owner = torch.empty_like(l2)
    common.launch("drain_writeback", [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 4, l2.device,
                  *(common.ptr(t) for t in (l2, rows, dirty, indices, owner,
                                            out)), nb, w, m, lanes)
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
