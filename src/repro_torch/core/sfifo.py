"""sFIFO, the QuickRelease-style synchronization FIFO (`repro.core.sfifo`).

A seq-tagged set per cache: each live entry carries the push counter
value it was (re)pushed with, and FIFO order is ascending seq.  The JAX
package models one cache and vmaps it over caches; here the cache axis
is written out as the leading dimension of every leaf, and each op takes
one operand per cache.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INVALID = -1
SEQ_MAX = 2**30
I32 = torch.int32


class SFifo(NamedTuple):
    addrs: torch.Tensor     # [n, cap] int32 block ids, -1 = free slot
    seqs: torch.Tensor      # [n, cap] int32 push order (where addrs >= 0)
    next_seq: torch.Tensor  # [n] int32 monotone counter


def make(n: int, capacity: int, device=None) -> SFifo:
    return SFifo(addrs=torch.full((n, capacity), INVALID, dtype=I32,
                                  device=device),
                 seqs=torch.zeros((n, capacity), dtype=I32, device=device),
                 next_seq=torch.zeros((n,), dtype=I32, device=device))


def first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none
    (`jnp.argmax` of a boolean row)."""
    return x.to(I32).argmax(dim=-1)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, idx[..., None])[..., 0]


def _put(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Copy of `x [n, k]` with x[i, idx[i]] = vals[i]."""
    return x.scatter(1, idx[:, None], torch.as_tensor(
        vals, dtype=x.dtype, device=x.device).expand(x.shape[0])[:, None])


def push(f: SFifo, addr: torch.Tensor, force_tail: torch.Tensor
         ) -> Tuple[SFifo, torch.Tensor, torch.Tensor]:
    """Insert `addr[i]` into cache i's FIFO.

    Returns (fifo', evicted [n], pos [n]): the block evicted to make room
    (-1 if none; the caller writes it back) and the seq tag of the
    entry (a local release records it in the LR-TBL)."""
    addr = addr.to(I32)
    valid = f.addrs >= 0
    hit = (f.addrs == addr[:, None]) & valid
    present = hit.any(dim=1)
    hit_idx = first_true(hit)
    free = ~valid
    any_free = free.any(dim=1)
    free_idx = first_true(free)
    # FIFO eviction victim: smallest seq among live entries
    oldest_idx = torch.where(valid, f.seqs, SEQ_MAX).argmin(dim=1)
    slot = torch.where(present, hit_idx,
                       torch.where(any_free, free_idx, oldest_idx))
    evicted = torch.where(present | any_free, INVALID, _at(f.addrs, slot))
    # re-tag on a fresh insert, or present + force_tail (move to tail)
    retag = ~present | force_tail
    pos = torch.where(retag, f.next_seq, _at(f.seqs, hit_idx))
    r = retag[:, None]
    addrs = torch.where(r, _put(f.addrs, slot, addr), f.addrs)
    seqs = torch.where(r, _put(f.seqs, slot, f.next_seq), f.seqs)
    return SFifo(addrs, seqs, f.next_seq + retag.to(I32)), evicted, pos


def drain_upto(f: SFifo, pos: torch.Tensor
               ) -> Tuple[SFifo, torch.Tensor, torch.Tensor]:
    """Remove every entry of cache i with seq <= pos[i].

    Returns (fifo', drained [n, cap], count [n]); drained rows list the
    removed blocks in FIFO order, -1 padded at the end."""
    valid = f.addrs >= 0
    sel = valid & (f.seqs <= pos.to(I32)[:, None])
    count = sel.sum(dim=1, dtype=I32)
    # selected entries sorted by (unique) seq; unselected sink to the back
    order = torch.where(sel, f.seqs, SEQ_MAX).argsort(dim=1, stable=True)
    cap = f.addrs.shape[1]
    ar = torch.arange(cap, dtype=I32, device=f.addrs.device)
    drained = torch.where(ar[None, :] < count[:, None],
                          f.addrs.gather(1, order), INVALID)
    addrs = torch.where(sel, INVALID, f.addrs)
    return SFifo(addrs, f.seqs, f.next_seq), drained, count


def size(f: SFifo) -> torch.Tensor:
    return (f.addrs >= 0).sum(dim=1, dtype=I32)
