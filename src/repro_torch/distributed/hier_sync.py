"""sRSP-style asymmetric cross-pod synchronization, the port of
`repro.distributed.hier_sync` (the paper's technique as a framework
feature, DESIGN.md §2).

Each pod is the local sharer of the parameter blocks its batch touched.
A remote acquire (a periodic global sync) flushes only the union of
blocks dirtied since the last sync: `selective_flush` compacts them and
one small reduction over the pods exchanges them, where the RSP-baseline
analogue (`full_global_sync`) all-reduces the whole bank.  The promotion
mask marks the blocks that were written remotely.

The pod axis.  The JAX functions are written per pod and run under
`shard_map` over a "pod" mesh axis.  Here every tensor carries a leading
local-pod axis L, and the number of pods is L times the size of an
optional process group:

  * one card: L = n_pods, no group (`make_pod_sync`'s [n_pods, nb, bs]);
  * one process per pod: L = 1 on each rank, a group of n_pods ranks.

`psum` gathers every rank's [L, ...] slice (`dist.all_gather`, rank
order) and sums the [n_pods, ...] stack over its first axis.  An
all-reduce would move fewer bytes, but its summation order is the
backend's: the gather makes a sync's bits the same on one card and
across processes (ROADMAP Queue C weighs the bytes).

Values that are the same on every pod after a `psum` (the union, the
index list, the overflow flag, the reduced payload) are kept once,
without the L axis.  On CUDA tensors the float32 flush launches the
`selective_flush` kernel once per sync over the flattened [L*nb, bs]
bank (each pod's indices offset by p*nb); the int8 path gathers inside
`compress_blocks`, as the reference does, and runs no kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import compress as CMP
from repro_torch.kernels.selective_flush import ops as SF

F32 = torch.float32


class BankSyncState(NamedTuple):
    """Per-pod state for one parameter bank; every leaf leads with the
    local-pod axis L."""
    ref: torch.Tensor          # [L, nb, bs] f32 snapshot at the last sync
    ef: torch.Tensor           # [L, nb, bs] f32 error-feedback residual
    promoted: torch.Tensor     # [L, nb] bool, the PA-TBL analogue
    syncs: torch.Tensor        # [L] i32 global syncs performed
    bytes_selective: torch.Tensor  # [L] f32 bytes a selective sync moved
    bytes_full: torch.Tensor       # [L] f32 bytes a full sync would move


def bank_init(bank: torch.Tensor) -> BankSyncState:
    """The state of a stacked bank [L, nb, bs] (any float type): the
    reference snapshot is a float32 copy, the rest zeros."""
    lead, (n, b) = bank.shape[:-2], bank.shape[-2:]
    dev = bank.device
    return BankSyncState(
        ref=bank.to(F32, copy=True),
        ef=torch.zeros((*lead, n, b), dtype=F32, device=dev),
        promoted=torch.zeros((*lead, n), dtype=torch.bool, device=dev),
        syncs=torch.zeros(lead, dtype=torch.int32, device=dev),
        bytes_selective=torch.zeros(lead, dtype=F32, device=dev),
        bytes_full=torch.zeros(lead, dtype=F32, device=dev))


def dirty_mask(bank: torch.Tensor, st: BankSyncState, tol: float = 0.0
               ) -> torch.Tensor:
    d = (bank.to(F32) - st.ref).abs()
    return d.amax(-1) > tol


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over every pod.  x leads with this process's pods; with a
    group, every rank's slice is gathered first, in rank order, so the
    sum is one reduction over [n_pods, ...] in global pod order and has
    the same bits however the pods are spread over processes."""
    if group is not None:
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts)
    return x.sum(0)


def _n_pods(bank: torch.Tensor, group) -> int:
    return bank.shape[0] * (1 if group is None
                            else dist.get_world_size(group))


def dirty_list(union: torch.Tensor, max_dirty: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shared index list of a union dirty mask [nb]: the first
    max_dirty union-dirty block ids in ascending order, -1 padded, and
    whether more blocks than that are dirty.  The list has
    min(max_dirty, nb) entries, as the reference's slice of an
    nb-long array does.  (idx [k] int32, overflow 0-d bool)"""
    n_blocks = union.shape[0]
    # dirty ids first, in ascending order (a stable sort of a 0/1 key)
    order = torch.argsort((~union).to(torch.int32), stable=True) \
        .to(torch.int32)
    ar = torch.arange(n_blocks, device=union.device)
    idx = torch.where(ar < max_dirty, order, -1)[:max_dirty]
    idx = torch.where(union[idx.clamp(0, n_blocks - 1).long()], idx, -1)
    return idx, union.sum() > max_dirty


def flat_list(idx: torch.Tensor, n_local: int, nb: int) -> torch.Tensor:
    """The shared list offset into the flattened [L*nb, bs] bank: pod p's
    valid entries by p*nb, pads kept at -1.  [L*k] int32."""
    off = torch.arange(n_local, dtype=torch.int32,
                       device=idx.device)[:, None] * nb
    return torch.where(idx >= 0, idx + off, -1).reshape(-1)


def selective_global_sync(bank: torch.Tensor, st: BankSyncState, *,
                          max_dirty: int, use_int8: bool = False,
                          group=None
                          ) -> Tuple[torch.Tensor, BankSyncState]:
    """The remote acquire: union the dirty sets across pods, flush only
    those blocks, average their deltas, promote.

    bank [L, nb, bs], this process's pods' current values.  The list
    holds the first min(max_dirty, nb) union-dirty block ids, -1 padded,
    the same on every pod; when more blocks are dirty the sync falls back
    to the full mean (no host sync: both are computed, `torch.where`
    picks)."""
    L, n_blocks, bs = bank.shape
    n_pods = _n_pods(bank, group)
    delta = bank.to(F32) - st.ref

    mine = dirty_mask(bank, st)
    union = _psum(mine.to(torch.int32), group) > 0               # [nb]
    idx, overflow = dirty_list(union, max_dirty)
    k = idx.shape[0]

    if use_int8:
        q, scale, ef_state = CMP.compress_blocks(delta, CMP.EFState(st.ef),
                                                 idx)
        payload = CMP.true_div(_psum(CMP.dequantize_int8(q, scale), group),
                               n_pods)
        ef = ef_state.err
        moved = k * bs * 1 + k * 4
    else:
        flat = SF.selective_flush(delta.reshape(L * n_blocks, bs),
                                  flat_list(idx, L, n_blocks))
        payload = CMP.true_div(_psum(flat.reshape(L, k, bs), group), n_pods)
        ef = st.ef
        moved = k * bs * 4

    # fall back to full sync on overflow (conservative, like LR-TBL eviction)
    full_mean = st.ref + CMP.true_div(_psum(delta, group), n_pods)
    safe = idx.clamp(0, n_blocks - 1).long()
    rows = st.ref.index_select(1, safe) + payload
    merged = SF.selective_apply(st.ref.reshape(L * n_blocks, bs),
                                rows.reshape(L * k, bs),
                                flat_list(idx, L, n_blocks)) \
        .reshape(L, n_blocks, bs)
    new_bank = torch.where(overflow, full_mean, merged)
    full_bytes = torch.tensor(float(n_blocks * bs * 4), dtype=F32,
                              device=bank.device)
    moved_bytes = torch.where(overflow, full_bytes, torch.tensor(
        float(moved + n_blocks // 8), dtype=F32, device=bank.device))

    new_st = BankSyncState(
        ref=new_bank,
        ef=ef,
        promoted=union.expand(L, n_blocks).clone(),  # remotely written
        syncs=st.syncs + 1,
        bytes_selective=st.bytes_selective + moved_bytes,
        bytes_full=st.bytes_full + full_bytes)
    return new_bank.to(bank.dtype, copy=True), new_st


def full_global_sync(bank: torch.Tensor, st: BankSyncState, *, group=None
                     ) -> Tuple[torch.Tensor, BankSyncState]:
    """RSP-baseline analogue: always move the whole bank."""
    n_pods = _n_pods(bank, group)
    delta = bank.to(F32) - st.ref
    new_bank = st.ref + CMP.true_div(_psum(delta, group), n_pods)
    sz = torch.tensor(float(bank.shape[1] * bank.shape[2] * 4), dtype=F32,
                      device=bank.device)
    return new_bank.to(bank.dtype, copy=True), st._replace(
        ref=new_bank, syncs=st.syncs + 1,
        bytes_selective=st.bytes_selective + sz,
        bytes_full=st.bytes_full + sz)


def make_pod_sync(n_pods: int, n_blocks: int, block_size: int, *,
                  max_dirty: int, use_int8: bool = False,
                  selective: bool = True, group=None):
    """The sync over all pods: `sync(bank, st) -> (new_bank, new_st)` on a
    stacked bank [L, n_blocks, block_size] with every state leaf led by
    L, where L * (the group's size, 1 without a group) == n_pods."""
    fn = functools.partial(
        selective_global_sync if selective else full_global_sync,
        group=group,
        **({"max_dirty": max_dirty, "use_int8": use_int8} if selective
           else {}))
    ranks = 1 if group is None else dist.get_world_size(group)

    def sync(bank: torch.Tensor, st: BankSyncState
             ) -> Tuple[torch.Tensor, BankSyncState]:
        if bank.dim() != 3 or bank.shape[1:] != (n_blocks, block_size) \
                or bank.shape[0] * ranks != n_pods:
            raise ValueError(f"want a bank [L, {n_blocks}, {block_size}] "
                             f"with L * {ranks} ranks == {n_pods} pods, "
                             f"got {tuple(bank.shape)}")
        return fn(bank, st)

    return sync

