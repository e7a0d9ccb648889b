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
  per-word dirty mask (`protocol.b_drain`, `protocol.b_writeback`);
  CUDA tensors launch `csrc/drain_writeback.cu`, which replaces
  `drain_writeback_pallas` (kernel.py:93).  That Pallas kernel has two
  bodies, picked by the mask's dtype, and so has the port: packed int32
  lanes [m, ceil(W/32)] launch the packed instance
  (`_writeback_kernel_packed`, kernel.py:75), a bool mask [m, W] (the
  REPRO_NO_PACK=1 layout) goes through `drain_writeback_bool` to the
  byte-mask instance (`_writeback_kernel`, kernel.py:63).  Each counts
  its own launches.

Each kernel wrapper dispatches by device (`kernels/common.py`): CPU
tensors take the plain version `<name>_ref`.  The source notes give each
kernel's design and its bound.

`drain_writeback_many` and `drain_writeback_bool_many` are the replica
instances (the Pallas kernel's batch grid axis under `jax.vmap`): a
leading [R] axis on every operand, one launch for every replica, each
counting its own launches.  Under `torch.func.vmap`, `drain_writeback`
on replica-batched tensors reaches them through a custom op's vmap rule
(`common.replica_op`).
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
    packed lanes or [m, W] bool; indices [m] int32.  The replica instance
    takes a leading [R] axis on all four: replica r's entries merge into
    its own bank only."""
    if l2.ndim == 3:
        reps, nb, w = l2.shape
        m = indices.shape[1]
        g = (indices >= 0) & (indices < nb)
        base = torch.arange(reps, dtype=I32, device=l2.device)[:, None] * nb
        out = drain_writeback_ref(
            l2.reshape(reps * nb, w), rows.reshape(reps * m, w),
            dirty.reshape((reps * m,) + tuple(dirty.shape[2:])),
            torch.where(g, indices + base, -1).reshape(reps * m))
        return out.view(reps, nb, w)
    nb, w = l2.shape
    m = indices.shape[0]
    g = (indices >= 0) & (indices < nb)
    flags = dirty if dirty.dtype == torch.bool else bitmask.unpack(dirty, w)
    sel = flags & g[:, None]
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
    """Check the inputs and launch the instance of `dirty`'s dtype: the
    packed entry takes the lane count, the bool entry derives it.  A
    leading [R] axis on every input launches the replica entry of that
    instance: one launch over every replica's bank."""
    nb, w = l2.shape[-2:]
    lead = tuple(l2.shape[:-2])
    m = indices.shape[-1]
    packed = dirty.dtype != torch.bool
    common.require(l2, "l2", I32, lead + (nb, w))
    common.require(rows, "rows", I32, lead + (m, w))
    if packed:
        common.require(dirty, "dirty", I32, lead + (m, bitmask.n_lanes(w)))
    else:
        common.require(dirty, "dirty", torch.bool, lead + (m, w))
    common.require(indices, "indices", I32, lead + (m,))
    if w > MAX_WRITEBACK_WORDS:
        raise ValueError(f"drain_writeback kernel takes W <= "
                         f"{MAX_WRITEBACK_WORDS} words a block, got {w}")
    out = torch.empty_like(l2)
    lanes = (dirty.shape[-1],) if packed else ()
    reps = lead[:1]             # the replica entry takes R last
    entry = "drain_writeback" if packed else "drain_writeback_bool"
    common.launch("drain_writeback", [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * (3 + len(lanes) + len(reps)),
                  l2.device,
                  *(common.ptr(t) for t in (l2, rows, dirty, indices, out)),
                  nb, w, m, *lanes, *reps,
                  entry=entry + "_many" if lead else entry)
    return out


def _replica_op(name: str):
    return common.replica_op(
        name, "(Tensor l2, Tensor rows, Tensor dirty, Tensor indices) -> "
        "Tensor", _impls[name], _rules[name])


def drain_writeback_bool(l2: torch.Tensor, rows: torch.Tensor,
                         dirty: torch.Tensor, indices: torch.Tensor
                         ) -> torch.Tensor:
    """`drain_writeback` under a bool [m, W] mask: CUDA tensors launch the
    byte-mask instance of `csrc/drain_writeback.cu`."""
    if dirty.dtype != torch.bool:
        raise ValueError(f"dirty: want a bool mask, got {dirty.dtype}")
    if common.batched(l2, rows, dirty, indices):
        return _replica_op("drain_writeback_bool")(l2, rows, dirty, indices)
    if common.on_cuda(l2, rows, dirty, indices):
        out = _launch(l2, rows, dirty, indices)
        drain_writeback_bool.launches += 1
        return out
    return drain_writeback_ref(l2, rows, dirty, indices)


def drain_writeback(l2: torch.Tensor, rows: torch.Tensor,
                    dirty: torch.Tensor, indices: torch.Tensor
                    ) -> torch.Tensor:
    """Merged [nb, W] bank, a fresh tensor (see `drain_writeback_ref`).
    A bool mask goes to `drain_writeback_bool`; packed int32 lanes launch
    the packed instance here.  Under vmap, replica-batched inputs take
    one `drain_writeback_many` call for every replica."""
    if dirty.dtype == torch.bool:
        return drain_writeback_bool(l2, rows, dirty, indices)
    if common.batched(l2, rows, dirty, indices):
        return _replica_op("drain_writeback")(l2, rows, dirty, indices)
    if common.on_cuda(l2, rows, dirty, indices):
        out = _launch(l2, rows, dirty, indices)
        drain_writeback.launches += 1
        return out
    return drain_writeback_ref(l2, rows, dirty, indices)


drain_writeback.launches = 0
drain_writeback_bool.launches = 0


def drain_writeback_many(l2: torch.Tensor, rows: torch.Tensor,
                         dirty: torch.Tensor, indices: torch.Tensor
                         ) -> torch.Tensor:
    """The replica instance: l2 [R, nb, W], rows [R, m, W], dirty
    [R, m, L] packed lanes, indices [R, m] -> a fresh [R, nb, W] bank;
    CUDA tensors launch one grid over (replica, destination tile)."""
    if dirty.dtype == torch.bool:
        return drain_writeback_bool_many(l2, rows, dirty, indices)
    if common.on_cuda(l2, rows, dirty, indices):
        out = _launch(l2, rows, dirty, indices)
        drain_writeback_many.launches += 1
        return out
    return drain_writeback_ref(l2, rows, dirty, indices)


def drain_writeback_bool_many(l2: torch.Tensor, rows: torch.Tensor,
                              dirty: torch.Tensor, indices: torch.Tensor
                              ) -> torch.Tensor:
    """`drain_writeback_many` under a bool [R, m, W] mask."""
    if dirty.dtype != torch.bool:
        raise ValueError(f"dirty: want a bool mask, got {dirty.dtype}")
    if common.on_cuda(l2, rows, dirty, indices):
        out = _launch(l2, rows, dirty, indices)
        drain_writeback_bool_many.launches += 1
        return out
    return drain_writeback_ref(l2, rows, dirty, indices)


drain_writeback_many.launches = 0
drain_writeback_bool_many.launches = 0


def _front(info, in_dims, args) -> list:
    return [common.to_front(info.batch_size, x, d)
            for x, d in zip(args, in_dims)]


def _rule(info, in_dims, *args):
    return drain_writeback_many(*_front(info, in_dims, args)), 0


def _bool_rule(info, in_dims, *args):
    return drain_writeback_bool_many(*_front(info, in_dims, args)), 0


_impls = {"drain_writeback": drain_writeback,
          "drain_writeback_bool": drain_writeback_bool}
_rules = {"drain_writeback": _rule, "drain_writeback_bool": _bool_rule}
