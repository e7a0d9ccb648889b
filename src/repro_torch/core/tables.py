"""LR-TBL and PA-TBL, the two structures sRSP adds (`repro.core.tables`).

Set-associative CAMs with per-address LRU aging behind a `TableGeometry`
(sets x ways).  An address maps to set `(addr >> 4) mod sets`.  The JAX
package models one cache's table and vmaps it over caches; here every
leaf has a leading cache axis and each op takes one address per cache
(`[n]`), or, for `lr_lookup`, any `[n, ...]` block of addresses per
cache.  Inserts write their way unconditionally, as the JAX ops do; the
protocol masks inactive caches afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.sfifo import first_true

INVALID = -1
SEQ_MAX = 2**30
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TableGeometry:
    """sets x ways layout of a CAM table."""
    sets: int = 1
    ways: int = 8

    def __str__(self) -> str:
        return f"{self.sets}x{self.ways}"


LR_GEOMETRY = TableGeometry(sets=2, ways=4)
PA_GEOMETRY = TableGeometry(sets=8, ways=4)


def set_index(n_sets: int, addr: torch.Tensor) -> torch.Tensor:
    """Home set of `addr` (floor mod keeps negative probes in range)."""
    return torch.remainder(addr.to(I32) >> 4, n_sets)


class LRTbl(NamedTuple):
    addrs: torch.Tensor     # [n, sets, ways] int32, -1 free
    ptrs: torch.Tensor      # [n, sets, ways] int32 sFIFO seq positions
    ages: torch.Tensor      # [n, sets, ways] int32 last-touch order
    next_age: torch.Tensor  # [n] int32


class PATbl(NamedTuple):
    addrs: torch.Tensor     # [n, sets, ways] int32, -1 free
    ages: torch.Tensor      # [n, sets, ways] int32 last-touch order
    next_age: torch.Tensor  # [n] int32


def lr_make(n: int, g: TableGeometry = LR_GEOMETRY, device=None) -> LRTbl:
    shape = (n, g.sets, g.ways)
    return LRTbl(addrs=torch.full(shape, INVALID, dtype=I32, device=device),
                 ptrs=torch.zeros(shape, dtype=I32, device=device),
                 ages=torch.zeros(shape, dtype=I32, device=device),
                 next_age=torch.zeros((n,), dtype=I32, device=device))


def pa_make(n: int, g: TableGeometry = PA_GEOMETRY, device=None) -> PATbl:
    shape = (n, g.sets, g.ways)
    return PATbl(addrs=torch.full(shape, INVALID, dtype=I32, device=device),
                 ages=torch.zeros(shape, dtype=I32, device=device),
                 next_age=torch.zeros((n,), dtype=I32, device=device))


def _rows(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x[i, s[i]] for every cache i: [n, sets, ways] -> [n, ways]."""
    ar = torch.arange(x.shape[0], device=x.device)
    return x[ar, s]


def _put(x: torch.Tensor, s, way, vals) -> torch.Tensor:
    """Copy of `x` with x[i, s[i], way[i]] = vals[i]."""
    out = x.clone()
    ar = torch.arange(x.shape[0], device=x.device)
    out[ar, s.long(), way] = torch.as_tensor(vals, dtype=x.dtype,
                                             device=x.device)
    return out


def _victim_way(row_a, row_g, addr):
    """(way, present, any_free): the hit way, else the first free way,
    else the set's least-recently-touched way."""
    valid = row_a >= 0
    hit = (row_a == addr[:, None]) & valid
    present = hit.any(dim=1)
    free = ~valid
    any_free = free.any(dim=1)
    lru = torch.where(valid, row_g, SEQ_MAX).argmin(dim=1)
    way = torch.where(present, first_true(hit),
                      torch.where(any_free, first_true(free), lru))
    return way, present, any_free


def lr_insert(t: LRTbl, addr: torch.Tensor, ptr: torch.Tensor
              ) -> Tuple[LRTbl, torch.Tensor, torch.Tensor]:
    """Insert or update addr -> ptr in each cache's table and refresh the
    entry's age.  Returns (tbl', evicted_addr [n], evicted_ptr [n]): the
    LRU victim's record when the set was full (-1, -1 otherwise)."""
    addr = addr.to(I32)
    s = set_index(t.addrs.shape[1], addr)
    row_a, row_p = _rows(t.addrs, s), _rows(t.ptrs, s)
    way, present, any_free = _victim_way(row_a, _rows(t.ages, s), addr)
    evict = ~present & ~any_free
    ar = torch.arange(addr.shape[0], device=addr.device)
    ev_addr = torch.where(evict, row_a[ar, way], INVALID)
    ev_ptr = torch.where(evict, row_p[ar, way], INVALID)
    return LRTbl(addrs=_put(t.addrs, s, way, addr),
                 ptrs=_put(t.ptrs, s, way, ptr),
                 ages=_put(t.ages, s, way, t.next_age),
                 next_age=t.next_age + 1), ev_addr, ev_ptr


def lr_lookup(t: LRTbl, addr: torch.Tensor) -> torch.Tensor:
    """Recorded sFIFO position of addr[i, ...] in cache i's table, or -1.
    `addr` is [n] or [n, k] (every cache probed for k addresses)."""
    addr = addr.to(I32)
    n, sets, _ = t.addrs.shape
    s = set_index(sets, addr)
    ar = torch.arange(n, device=addr.device).reshape(
        (n,) + (1,) * (addr.ndim - 1))
    row = t.addrs[ar, s]                             # [n, ..., ways]
    hit = (row == addr[..., None]) & (row >= 0)
    ptr = t.ptrs[ar, s].gather(-1, first_true(hit)[..., None])[..., 0]
    return torch.where(hit.any(dim=-1), ptr, INVALID)


def lr_remove(t: LRTbl, addr: torch.Tensor) -> LRTbl:
    addr = addr.to(I32)
    s = set_index(t.addrs.shape[1], addr)
    row = _rows(t.addrs, s)
    hit = (row == addr[:, None]) & (row >= 0)
    addrs = t.addrs.clone()
    addrs[torch.arange(addr.shape[0], device=addr.device), s.long()] = \
        torch.where(hit, INVALID, row)
    return t._replace(addrs=addrs)


def lr_reset(t: LRTbl) -> LRTbl:
    return t._replace(addrs=torch.full_like(t.addrs, INVALID))


def pa_insert(t: PATbl, addr: torch.Tensor) -> PATbl:
    """Record addr[i] in cache i's table; a re-insert refreshes the age
    and a full set evicts its LRU way silently."""
    addr = addr.to(I32)
    s = set_index(t.addrs.shape[1], addr)
    way, _, _ = _victim_way(_rows(t.addrs, s), _rows(t.ages, s), addr)
    return PATbl(addrs=_put(t.addrs, s, way, addr),
                 ages=_put(t.ages, s, way, t.next_age),
                 next_age=t.next_age + 1)


def pa_contains(t: PATbl, addr: torch.Tensor) -> torch.Tensor:
    """[n] bool: cache i's next local acquire of addr[i] is promoted."""
    addr = addr.to(I32)
    row = _rows(t.addrs, set_index(t.addrs.shape[1], addr))
    return ((row == addr[:, None]) & (row >= 0)).any(dim=1)


def pa_reset(t: PATbl) -> PATbl:
    return t._replace(addrs=torch.full_like(t.addrs, INVALID))
