"""Functional model of the sRSP / RSP scoped-synchronization protocols
(`repro.core.protocol`, paper §2-4).

Block-major store over a shared L2 and N private L1 caches:

    Store.l2      [n_blocks, W]               int32 word values at L2
    Store.l1      [n_caches, n_blocks, W]     int32 per-cache values
    Store.wvalid  [n_caches, n_blocks, L]     flag plane: copy readable
    Store.wdirty  [n_caches, n_blocks, L]     flag plane: not written back
    Store.fifo / lr / pa                      sFIFO, LR-TBL, PA-TBL, each
                                              with a leading cache axis

Two metadata layouts, as in the JAX package (DESIGN.md §8): packed int32
bit patterns with L = ceil(W/32) (`core/bitmask.py`, the default), or
bool planes with L = W under `REPRO_NO_PACK=1`, read once at import into
`PACKED`.  Only `make_store` reads `PACKED`; every layout-aware helper
(`_pl_clear`, `_rows_where`, `wvalid_bool`, `wdirty_bool`, and
`plane_commit`/`drain_writeback` below them) takes its branch from the
plane's dtype, so both layouts can run in one process.

Every op is `(store, ...) -> (store', ...)` and returns fresh tensors;
nothing is updated in place, so an old store stays valid beside the new
one, as in the JAX package.  Where JAX scatters with
`mode="drop"`, the port scatters into one spare row past the end and
slices it off (`_scatter_rows`); only that row ever receives duplicate
indices.  Where JAX branches with `lax.cond`, the port calls `cond`:
on one replica it branches on the host on a scalar read back from the
device; on the replica path (`torch.func.vmap` over stacked states, the
harness's `run_*_many`) it runs both branches and selects per replica,
as `lax.cond` lowers under `jax.vmap`.

Two API layers, as in the JAX package: batched multi-cache ops (`b_*`,
`*_b`: an `active [n_caches]` mask plus per-cache operands) and the
classic single-cache wrappers (`load`, `store_word`, `local_acquire`,
...).  The three kernels of this path: `drain_writeback` (every drain,
writeback and crash recovery), `plane_commit` (every store's metadata
planes) and, in the harness, `trip_plan`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core import bitmask, sfifo, tables
from repro_torch.core.costmodel import CostParams, Counters, make_counters
from repro_torch.kernels import common
from repro_torch.kernels.fused_turn import plane_commit
from repro_torch.kernels.selective_flush import drain_writeback
from repro_torch.obs import trace as obs

INVALID = -1
DRAIN_ALL = 2**30      # any seq is <= it: the whole sFIFO drains
I32 = torch.int32
F32 = torch.float32

# Metadata layout, read once at import as in the JAX package: packed
# int32 word bitmasks by default, bool [.., W] planes under REPRO_NO_PACK=1
PACKED = os.environ.get("REPRO_NO_PACK", "0") != "1"


@dataclasses.dataclass(frozen=True)
class ProtoConfig:
    n_caches: int
    n_words: int
    block_words: int = 16      # 64B block / 4B word (Table 1)
    fifo_cap: int = 16         # L1 sFIFO entries (Table 1)
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    params: CostParams = dataclasses.field(default_factory=CostParams)

    @property
    def n_blocks(self) -> int:
        return (self.n_words + self.block_words - 1) // self.block_words

    @property
    def meta_lanes(self) -> int:
        """Last-axis extent of the wvalid/wdirty planes in this layout."""
        return bitmask.n_lanes(self.block_words) if PACKED \
            else self.block_words


class Lease(NamedTuple):
    """Clock-stamped sync-word lease per cache (pure bookkeeping)."""
    addr: torch.Tensor     # [n] int32 held sync word, -1 if none
    stamp: torch.Tensor    # [n] f32 cycle clock at acquire


class Store(NamedTuple):
    l2: torch.Tensor
    l1: torch.Tensor
    wvalid: torch.Tensor
    wdirty: torch.Tensor
    fifo: sfifo.SFifo
    lr: tables.LRTbl
    pa: tables.PATbl
    lease: Lease
    counters: Counters
    trace: obs.TraceLog


def make_store(cfg: ProtoConfig, device=None) -> Store:
    """Empty store on `device` (default: the GPU)."""
    dev = common.resolve_device(device)
    n, nb, w = cfg.n_caches, cfg.n_blocks, cfg.block_words
    plane = torch.zeros((n, nb, cfg.meta_lanes),
                        dtype=I32 if PACKED else torch.bool, device=dev)
    return Store(
        l2=torch.zeros((nb, w), dtype=I32, device=dev),
        l1=torch.zeros((n, nb, w), dtype=I32, device=dev),
        wvalid=plane, wdirty=plane.clone(),
        fifo=sfifo.make(n, cfg.fifo_cap, dev),
        lr=tables.lr_make(n, cfg.lr_tbl, dev),
        pa=tables.pa_make(n, cfg.pa_tbl, dev),
        lease=Lease(addr=torch.full((n,), INVALID, dtype=I32, device=dev),
                    stamp=torch.zeros((n,), dtype=F32, device=dev)),
        counters=make_counters(n, dev),
        trace=obs.make(obs.default_cap(), n, dev))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def tree_map(fn: Callable, *trees):
    """`fn` over the leaves of like NamedTuple trees (tensors at the
    leaves), rebuilt in their types."""
    first = trees[0]
    if isinstance(first, tuple):
        parts = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    return fn(*trees)


def select(pred, yes, no):
    """Leaf-wise `torch.where(pred, yes, no)` over two like trees."""
    return tree_map(lambda a, b: torch.where(pred, a, b), yes, no)


def cond(pred, yes: Callable, no: Callable, *args):
    """`lax.cond(pred, yes, no, *args)`.  A plain 0-d `pred` is read on
    the host and one branch runs; a replica-batched one (under vmap) runs
    both branches and selects per replica."""
    if not common.batched(pred):
        return yes(*args) if bool(pred) else no(*args)
    return select(pred, yes(*args), no(*args))


# the innermost `lane_bound` block: (bound, the overflow flags of its
# lane scans); None outside every block
_LANE_BOUND = None


@contextlib.contextmanager
def lane_bound(k: int):
    """Within the block, every `lane_scan` on the replica path takes at
    most `k` active lanes a replica.  The replica engines set it around a
    remote turn form, whose ops act for the form's masked agents only:
    one for the serial remote turn, the largest remote batch for
    `remote_turn_b`.  Yields a list that gathers, for each such scan, a
    bool that is True where the replica's mask held more than `k` lanes
    (lanes the scan left out); the caller must see that none is set."""
    global _LANE_BOUND
    saved, _LANE_BOUND = _LANE_BOUND, (k, [])
    try:
        yield _LANE_BOUND[1]
    finally:
        _LANE_BOUND = saved


def lane_scan(active, fn: Callable, carry):
    """`carry = fn(carry, j)` for every active lane j in ascending order
    (the reference's masked `lax.scan` over lanes).  On one replica only
    the active lanes run, found on the host.  On the replica path step k
    takes each replica's k-th active lane, for k up to the lane count or
    the `lane_bound` in force, and a replica with fewer keeps the carry;
    a replica with more is flagged to the block's caller."""
    if not common.batched(active):
        for j in torch.nonzero(active).flatten().tolist():
            carry = fn(carry, j)
        return carry
    n = active.shape[0]
    # active lanes first, in ascending order
    order = torch.argsort((~active).to(torch.int8), stable=True)
    count = active.sum()
    steps = n
    if _LANE_BOUND is not None:
        steps = min(n, _LANE_BOUND[0])
        _LANE_BOUND[1].append(count > steps)
    for k in range(steps):
        carry = select(k < count, fn(carry, order[k]), carry)
    return carry


def _vec(x, n: int, dtype, device) -> torch.Tensor:
    """`x` (Python scalar, 0-d or [n] tensor) as a contiguous [n] tensor."""
    return torch.as_tensor(x, dtype=dtype, device=device) \
        .broadcast_to((n,)).contiguous()


def _i32(cfg, st, x):
    return _vec(x, cfg.n_caches, I32, st.l2.device)


def _bool(cfg, st, x):
    return _vec(x, cfg.n_caches, torch.bool, st.l2.device)


def _lanes(cfg, st) -> torch.Tensor:
    return torch.arange(cfg.n_caches, device=st.l2.device)


def _one_hot(cfg, st, cid) -> torch.Tensor:
    return _lanes(cfg, st) == torch.as_tensor(cid, device=st.l2.device)


def _where(cond, a, b):
    """torch.where keeping int32 when both branches are Python ints."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.tensor(a, dtype=I32, device=cond.device)
    return torch.where(cond, a, b)


def _mask_rows(pred, new, old):
    """Per-cache select over every leaf (leaves have a leading [n])."""
    def sel(a, b):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return type(new)(*(sel(a, b) for a, b in zip(new, old)))


def _scatter_rows(x, nlead: int, flat, vals):
    """Copy of `x` with rows `flat` of its [prod(shape[:nlead]), ...] view
    set to `vals`; the index one past the last row drops (JAX
    `mode="drop"`).  That spare row is the only one written twice."""
    tail = x.shape[nlead:]
    rows = x.reshape((-1,) + tail)
    ext = torch.cat([rows, rows.new_zeros((1,) + tail)])
    ext[flat.long()] = vals
    return ext[:-1].reshape(x.shape)


def _add_at(x, hot, v):
    """`x.at[cid].add(v)` for the one-hot mask of cid."""
    return x + torch.where(hot, v, 0.0)


def _split(cfg, addrs):
    return (torch.div(addrs, cfg.block_words, rounding_mode="floor"),
            torch.remainder(addrs, cfg.block_words))


def _pl_get(plane, lane, b, o):
    """Per-lane flag read flags[lane, b, o] -> bool [n], in either
    layout."""
    if plane.dtype == torch.bool:
        return plane[lane, b.long(), o.long()]
    return bitmask.test_word(
        plane[lane, b.long(), bitmask.word_index(o).long()], o)


def _pl_clear(plane, lane, b, o, off):
    """Per-lane flag clear: flags[lane, b, o] &= ~off, in either layout."""
    out = plane.clone()
    if plane.dtype == torch.bool:
        out[lane, b.long(), o.long()] = plane[lane, b.long(), o.long()] & ~off
        return out
    w = bitmask.word_index(o).long()
    mask = torch.where(off, bitmask.word_bit(o), 0)
    out[lane, b.long(), w] = plane[lane, b.long(), w] & ~mask
    return out


def _rows_where(g, rows):
    """Rows where g[...] else all-clear, in the rows' own dtype (a bare
    `torch.where(g, rows, 0)` would promote bool rows to int64)."""
    return torch.where(g[..., None], rows, rows.new_zeros(()))


def plane_scatter_set(plane, lane, b, o):
    """Bulk flag OR over index triples (the write-combining bulk-store
    path, worksteal's enqueue scatter), in either layout.  Triples must
    be distinct; `b` outside [-n_blocks, n_blocks) drops (a negative one
    counts from the end, as JAX's `mode="drop"` does).  Packed lanes
    accumulate by add, which equals OR exactly because each (lane, b, o)
    bit appears at most once; every dropped triple lands in one spare
    element past the end."""
    n, nb, lanes = plane.shape
    lane, b, o = (x.to(torch.int64) for x in (lane, b, o))
    packed = plane.dtype != torch.bool
    col = bitmask.word_index(o).to(torch.int64) if packed else o
    flat = torch.where((b >= -nb) & (b < nb),
                       (lane * nb + torch.remainder(b, nb)) * lanes + col,
                       n * nb * lanes)
    ext = plane.new_zeros(n * nb * lanes + 1)
    if packed:
        ext.index_put_((flat,), bitmask.word_bit(o), accumulate=True)
        return plane | ext[:-1].reshape(plane.shape)
    ext[:-1] = plane.reshape(-1)
    ext[flat] = True
    return ext[:-1].reshape(plane.shape)


def _count(c: Counters, **kw) -> Counters:
    return c._replace(**{k: getattr(c, k) + v for k, v in kw.items()})


def _plane_bool(plane, w: int) -> torch.Tensor:
    return plane if plane.dtype == torch.bool else bitmask.unpack(plane, w)


def wvalid_bool(st: Store) -> torch.Tensor:
    """Boolean [n_caches, n_blocks, W] view of wvalid (tests/debug)."""
    return _plane_bool(st.wvalid, st.l1.shape[-1])


def wdirty_bool(st: Store) -> torch.Tensor:
    """Boolean [n_caches, n_blocks, W] view of wdirty (tests/debug)."""
    return _plane_bool(st.wdirty, st.l1.shape[-1])


def lease_stamp(st: Store, active, addrs) -> Store:
    """Record an acquire: active lanes hold `addrs` as of their clock."""
    return st._replace(lease=Lease(
        addr=torch.where(active, addrs, st.lease.addr),
        stamp=torch.where(active, st.counters.cycles, st.lease.stamp)))


def lease_clear(st: Store, active) -> Store:
    """Record a release: active lanes hold nothing."""
    return st._replace(lease=Lease(
        addr=torch.where(active, INVALID, st.lease.addr),
        stamp=torch.where(active, 0.0, st.lease.stamp)))


# --------------------------------------------------------------------------
# batched block writeback / drain core
# --------------------------------------------------------------------------

def b_writeback(cfg: ProtoConfig, st: Store, blks, guard
                ) -> Tuple[Store, torch.Tensor]:
    """Cache i writes back the dirty words of block blks[i] (skipped where
    guard[i] is False or blks[i] < 0).  Returns (store', did [n] f32)."""
    n, nb = cfg.n_caches, cfg.n_blocks
    lane = _lanes(cfg, st)
    blks = _i32(cfg, st, blks)
    g = _bool(cfg, st, guard) & (blks >= 0)
    safe = blks.clamp(min=0)
    rows = st.l1[lane, safe.long()]                         # [n, W]
    dirty_rows = st.wdirty[lane, safe.long()]               # [n, L]
    sel = _rows_where(g, dirty_rows)
    l2 = drain_writeback(st.l2, rows, sel, _where(g, safe, nb))
    # skipped lanes write their own row back unchanged (sel is 0 there)
    wdirty = st.wdirty.clone()
    wdirty[lane, safe.long()] = dirty_rows & ~sel
    did = (sel != 0).any(dim=-1).to(F32)
    tot = did.sum()
    c = _count(st.counters, l2_accesses=tot, wb_blocks=tot)
    return st._replace(l2=l2, wdirty=wdirty, counters=c), did


def b_drain(cfg: ProtoConfig, st: Store, pos, charge
            ) -> Tuple[Store, torch.Tensor]:
    """Selective flush of all caches at once: cache i drains its sFIFO up
    to seq pos[i] (pos < 0 drains nothing) and writes every drained block
    back in one masked scatter.  A charged cache pays l2_lat + n_wb *
    wb_per_block even when it drained nothing.  Returns (store', n_wb)."""
    n, nb, w = cfg.n_caches, cfg.n_blocks, cfg.block_words
    f2, drained, _ = sfifo.drain_upto(st.fifo, _i32(cfg, st, pos))
    st = st._replace(fifo=f2)
    cap = drained.shape[1]
    g = drained >= 0
    safe = drained.clamp(min=0).long()
    crow = _lanes(cfg, st)[:, None].expand(n, cap)
    rows = st.l1[crow, safe]                                # [n, cap, W]
    cur = st.wdirty[crow, safe]                             # [n, cap, L]
    dirty_rows = _rows_where(g, cur)
    lanes = dirty_rows.shape[-1]
    # cache-major flatten: later caches override earlier on collisions
    l2 = drain_writeback(st.l2, rows.reshape(n * cap, w),
                         dirty_rows.reshape(n * cap, lanes),
                         _where(g, drained, nb).reshape(n * cap))
    flat = torch.where(g, crow * nb + drained, n * nb).reshape(n * cap)
    wdirty = _scatter_rows(st.wdirty, 2, flat,
                           (cur & ~dirty_rows).reshape(n * cap, lanes))
    n_wb = (dirty_rows != 0).any(dim=-1).sum(dim=1).to(F32)
    tot = n_wb.sum()
    p = cfg.params
    cyc = torch.where(_bool(cfg, st, charge),
                      p.l2_lat + n_wb * p.wb_per_block, 0.0)
    c = _count(st.counters, cycles=cyc, l2_accesses=tot, wb_blocks=tot)
    return st._replace(l2=l2, wdirty=wdirty, counters=c), n_wb


def b_invalidate(cfg: ProtoConfig, st: Store, mask) -> Store:
    """Whole-cache invalidate of every cache in `mask`: flush dirty first,
    flash-invalidate, clear LR-TBL and PA-TBL."""
    mask = _bool(cfg, st, mask)
    st, _ = b_drain(cfg, st, _where(mask, DRAIN_ALL, INVALID), mask)
    wvalid = torch.where(mask[:, None, None], st.wvalid.new_zeros(()),
                         st.wvalid)
    lr = _mask_rows(mask, tables.lr_reset(st.lr), st.lr)
    pa = _mask_rows(mask, tables.pa_reset(st.pa), st.pa)
    fmask = mask.to(F32)
    c = _count(st.counters, cycles=fmask * cfg.params.inv_flash,
               inv_full=fmask.sum(), inv_per_cache=fmask)
    return st._replace(wvalid=wvalid, lr=lr, pa=pa, counters=c)


def b_recover(cfg: ProtoConfig, st: Store, mask) -> Store:
    """Crash-recovery drain for every cache in `mask` (dead agents whose
    lease expired, DESIGN.md §10): drain, writeback and flash-invalidate
    the dead cache and clear its LR/PA entries (`b_invalidate`, so the
    `drain_writeback` kernel reclaims its dirty words whether an LR entry
    covers them or not); force-release its leased sync word at L2 (a
    plain ST 0, not a CAS); clear the lease and count one recovery per
    reclaimed cache."""
    mask = _bool(cfg, st, mask)
    clock0 = st.counters.cycles
    la = st.lease.addr
    st = b_invalidate(cfg, st, mask)
    st, _ = b_atomic_l2(cfg, st, mask & (la >= 0), la.clamp(min=0), 0, 0,
                        False)
    st = lease_clear(st, mask)
    st = st._replace(counters=_count(st.counters,
                                     recoveries=mask.to(F32).sum()))
    return obs.record_event(st, mask, obs.RECOVER, obs.OC_RECOVER,
                            addr=la, clock=clock0,
                            cycles=st.counters.cycles - clock0)


# --------------------------------------------------------------------------
# plain loads / stores
# --------------------------------------------------------------------------

def b_load(cfg: ProtoConfig, st: Store, active, addrs
           ) -> Tuple[Store, torch.Tensor]:
    """Ordinary read, one per active cache: L1 hit or fill from L2."""
    active = _bool(cfg, st, active)
    lane = _lanes(cfg, st)
    b, o = _split(cfg, _i32(cfg, st, addrs))
    # the load shape of plane_commit (set_dirty=None) is the plain version
    wvalid, _, hit, _ = plane_commit(st.wvalid, st.wdirty, b, o, active,
                                     None)
    bl, ol = b.long(), o.long()
    mine = st.l1[lane, bl, ol]
    val = torch.where(hit, mine, st.l2[bl, ol])
    l1 = st.l1.clone()
    l1[lane, bl, ol] = torch.where(active, val, mine)
    p = cfg.params
    miss = (active & ~hit).to(F32)
    c = _count(st.counters,
               cycles=torch.where(active, torch.where(
                   hit, p.l1_lat, p.l1_lat + p.l2_lat), 0.0),
               l1_hits=(active & hit).to(F32).sum(),
               l1_misses=miss.sum(), l2_accesses=miss.sum())
    return st._replace(l1=l1, wvalid=wvalid, counters=c), val


def b_store_word(cfg: ProtoConfig, st: Store, active, addrs, vals,
                 force_tail=False) -> Tuple[Store, torch.Tensor]:
    """Ordinary write (write-combining, no-allocate), one per active
    cache: update the local copy, mark it dirty, record the block in the
    sFIFO; a capacity eviction writes the oldest block back.
    Returns (store', fifo_pos [n])."""
    active = _bool(cfg, st, active)
    lane = _lanes(cfg, st)
    b, o = _split(cfg, _i32(cfg, st, addrs))
    bl, ol = b.long(), o.long()
    l1 = st.l1.clone()
    l1[lane, bl, ol] = torch.where(active, _i32(cfg, st, vals),
                                   st.l1[lane, bl, ol])
    wvalid, wdirty, _, _ = plane_commit(st.wvalid, st.wdirty, b, o,
                                        active, active)
    st = st._replace(l1=l1, wvalid=wvalid, wdirty=wdirty)
    f2, evicted, pos = sfifo.push(st.fifo, b, _bool(cfg, st, force_tail))
    st = st._replace(fifo=_mask_rows(active, f2, st.fifo))
    evicted = torch.where(active, evicted, INVALID)
    st, n_evwb = b_writeback(cfg, st, evicted, evicted >= 0)
    p = cfg.params
    c = _count(st.counters, cycles=torch.where(
        active, p.l1_lat + n_evwb * p.wb_per_block, 0.0))
    return st._replace(counters=c), pos


def load(cfg: ProtoConfig, st: Store, cid, addr
         ) -> Tuple[Store, torch.Tensor]:
    st, vals = b_load(cfg, st, _one_hot(cfg, st, cid), addr)
    return st, vals[cid]


def store_word(cfg: ProtoConfig, st: Store, cid, addr, val, *,
               force_tail=False, guard=True) -> Tuple[Store, torch.Tensor]:
    hot = _one_hot(cfg, st, cid) & _bool(cfg, st, guard)
    st, pos = b_store_word(cfg, st, hot, addr, val, force_tail)
    return st, pos[cid]


def writeback_block(cfg: ProtoConfig, st: Store, cid, b, guard=True
                    ) -> Tuple[Store, torch.Tensor]:
    hot = _one_hot(cfg, st, cid)
    st, did = b_writeback(cfg, st, _where(hot, _i32(cfg, st, b), INVALID),
                          hot & _bool(cfg, st, guard))
    return st, did.sum()


def drain_fifo(cfg: ProtoConfig, st: Store, cid, pos
               ) -> Tuple[Store, torch.Tensor]:
    hot = _one_hot(cfg, st, cid)
    st, n_wb = b_drain(cfg, st, _where(hot, _i32(cfg, st, pos), INVALID),
                       hot)
    return st, n_wb.sum()


def drain_fifo_all(cfg: ProtoConfig, st: Store, cid):
    return drain_fifo(cfg, st, cid, DRAIN_ALL)


def invalidate_cache(cfg: ProtoConfig, st: Store, cid) -> Store:
    return b_invalidate(cfg, st, _one_hot(cfg, st, cid))


# --------------------------------------------------------------------------
# atomics
# --------------------------------------------------------------------------

def b_atomic_l1(cfg, st: Store, active, addrs, expect, new, is_cas
                ) -> Tuple[Store, torch.Tensor]:
    """Atomic at the L1 (local scope).  Returns (store', old [n])."""
    active = _bool(cfg, st, active)
    st, cur = b_load(cfg, st, active, addrs)
    success = (cur == _i32(cfg, st, expect)) if is_cas \
        else torch.ones_like(active)
    st, _ = b_store_word(cfg, st, active & success, addrs,
                         torch.where(success, _i32(cfg, st, new), cur))
    return st, cur


def b_atomic_l2(cfg, st: Store, active, addrs, expect, new, is_cas
                ) -> Tuple[Store, torch.Tensor]:
    """Atomic at the L2, one per active cache (active lanes target
    pairwise-distinct words).  Returns (store', old [n])."""
    nb, w = cfg.n_blocks, cfg.block_words
    active = _bool(cfg, st, active)
    lane = _lanes(cfg, st)
    b, o = _split(cfg, _i32(cfg, st, addrs))
    cur = st.l2[b.long(), o.long()]
    success = (cur == _i32(cfg, st, expect)) if is_cas \
        else torch.ones_like(active)
    flat = torch.where(active & success, b * w + o, nb * w)
    l2 = _scatter_rows(st.l2, 2, flat,
                       torch.where(success, _i32(cfg, st, new), cur))
    # the local copy of this word is no longer authoritative
    wvalid = _pl_clear(st.wvalid, lane, b, o, active)
    wdirty = _pl_clear(st.wdirty, lane, b, o, active)
    fact = active.to(F32)
    c = _count(st.counters, cycles=fact * cfg.params.l2_lat,
               l2_accesses=fact.sum())
    return st._replace(l2=l2, wvalid=wvalid, wdirty=wdirty,
                       counters=c), cur


def _atomic_l2(cfg, st: Store, cid, addr, expect, new, is_cas):
    st, old = b_atomic_l2(cfg, st, _one_hot(cfg, st, cid), addr, expect,
                          new, is_cas)
    return st, old[cid]


# --------------------------------------------------------------------------
# local (work-group) scope
# --------------------------------------------------------------------------

def local_release_b(cfg: ProtoConfig, st: Store, active, addrs, vals
                    ) -> Store:
    """atomic_ST_rel_wg: push the sync block to the sFIFO tail, record
    (addr -> pos) in the LR-TBL; an evicted LR record drains up to its
    position so no release is lost."""
    active = _bool(cfg, st, active)
    addrs = _i32(cfg, st, addrs)
    st, pos = b_store_word(cfg, st, active, addrs, vals, force_tail=True)
    lr2, ev_addr, ev_ptr = tables.lr_insert(st.lr, addrs, pos)
    st = st._replace(lr=_mask_rows(active, lr2, st.lr))
    st, _ = b_drain(cfg, st, torch.where(active & (ev_addr >= 0), ev_ptr,
                                         INVALID), active)
    fact = active.to(F32)
    c = _count(st.counters, cycles=fact * cfg.params.tbl_lat,
               local_syncs=fact.sum())
    return st._replace(counters=c)


def local_acquire_b(cfg: ProtoConfig, st: Store, active, addrs, expect, new
                    ) -> Tuple[Store, torch.Tensor]:
    """atomic_CAS_acq_wg: lanes whose PA-TBL holds the address are
    promoted (full invalidate + CAS at L2); the others CAS at L1."""
    active = _bool(cfg, st, active)
    addrs = _i32(cfg, st, addrs)
    promote = tables.pa_contains(st.pa, addrs) & active
    st = b_invalidate(cfg, st, promote)
    st, old_l2 = b_atomic_l2(cfg, st, promote, addrs, expect, new, True)
    st, old_l1 = b_atomic_l1(cfg, st, active & ~promote, addrs, expect,
                             new, True)
    fact = active.to(F32)
    c = _count(st.counters, cycles=fact * cfg.params.tbl_lat,
               local_syncs=fact.sum(), promotions=promote.to(F32).sum())
    return st._replace(counters=c), torch.where(promote, old_l2, old_l1)


def local_release(cfg: ProtoConfig, st: Store, cid, addr, val) -> Store:
    return local_release_b(cfg, st, _one_hot(cfg, st, cid), addr, val)


def local_acquire(cfg: ProtoConfig, st: Store, cid, addr, expect, new):
    st, old = local_acquire_b(cfg, st, _one_hot(cfg, st, cid), addr,
                              expect, new)
    return st, old[cid]


# --------------------------------------------------------------------------
# global (device) scope
# --------------------------------------------------------------------------

def global_release_b(cfg: ProtoConfig, st: Store, active, addrs, vals
                     ) -> Store:
    active = _bool(cfg, st, active)
    st, _ = b_drain(cfg, st, _where(active, DRAIN_ALL, INVALID), active)
    st, _ = b_atomic_l2(cfg, st, active, addrs, 0, vals, False)
    return st._replace(counters=_count(
        st.counters, global_syncs=active.to(F32).sum()))


def global_acquire_b(cfg: ProtoConfig, st: Store, active, addrs, expect, new
                     ) -> Tuple[Store, torch.Tensor]:
    active = _bool(cfg, st, active)
    st = b_invalidate(cfg, st, active)
    st, old = b_atomic_l2(cfg, st, active, addrs, expect, new, True)
    return st._replace(counters=_count(
        st.counters, global_syncs=active.to(F32).sum())), old


def global_release(cfg: ProtoConfig, st: Store, cid, addr, val) -> Store:
    return global_release_b(cfg, st, _one_hot(cfg, st, cid), addr, val)


def global_acquire(cfg: ProtoConfig, st: Store, cid, addr, expect, new):
    st, old = global_acquire_b(cfg, st, _one_hot(cfg, st, cid), addr,
                               expect, new)
    return st, old[cid]


# --------------------------------------------------------------------------
# remote scope promotion: sRSP (§4.2, §4.3) and original RSP (§3)
# --------------------------------------------------------------------------

def _probe_and_selective_flush(cfg: ProtoConfig, st: Store, cid, addr
                               ) -> Store:
    """Selective-flush(addr) probe to every L1: caches with an LR-TBL
    entry for addr drain up to it and move addr into their PA-TBL; the
    others NACK, paying one CAM lookup."""
    p = cfg.params
    n = cfg.n_caches
    addrs = _i32(cfg, st, addr)
    hot = _one_hot(cfg, st, cid)
    ptrs = tables.lr_lookup(st.lr, addrs)
    has = (ptrs >= 0) & ~hot
    st, n_wb = b_drain(cfg, st, torch.where(has, ptrs, INVALID), has)
    st = st._replace(
        lr=_mask_rows(has, tables.lr_remove(st.lr, addrs), st.lr),
        pa=_mask_rows(has, tables.pa_insert(st.pa, addrs), st.pa))
    wait = torch.where(has, p.l2_lat + n_wb * p.wb_per_block, 0.0).sum() \
        + 1.0
    nack = torch.where(~hot & ~has, p.tbl_lat, 0.0)
    c = st.counters
    c = c._replace(cycles=_add_at(c.cycles + nack, hot,
                                  p.probe_lat + p.l2_lat + wait),
                   probes=c.probes + float(n - 1))
    return st._replace(counters=c)


def srsp_remote_acquire(cfg: ProtoConfig, st: Store, cid, addr, expect, new
                        ) -> Tuple[Store, torch.Tensor]:
    """atomic_CAS_rem_acq_cmp under sRSP (§4.2)."""
    addrs = _i32(cfg, st, addr)
    own_ptr = tables.lr_lookup(st.lr, addrs)[cid]

    def same_cu(st):
        # local sharer on the same CU: order its releases, CAS at L2
        st, _ = drain_fifo(cfg, st, cid, own_ptr)
        return st._replace(lr=_mask_rows(_one_hot(cfg, st, cid),
                                         tables.lr_remove(st.lr, addrs),
                                         st.lr))

    def cross_cu(st):
        st = _probe_and_selective_flush(cfg, st, cid, addr)
        return invalidate_cache(cfg, st, cid)

    st = cond(own_ptr >= 0, same_cu, cross_cu, st)
    st, old = _atomic_l2(cfg, st, cid, addr, expect, new, True)
    return st._replace(counters=_count(st.counters, remote_syncs=1.0)), old


def srsp_remote_release(cfg: ProtoConfig, st: Store, cid, addr, val
                        ) -> Store:
    """atomic_ST_rem_rel_cmp under sRSP (§4.3): flush own cache, ST at
    L2, every PA-TBL records addr."""
    p = cfg.params
    n = cfg.n_caches
    st, _ = drain_fifo_all(cfg, st, cid)
    st, _ = _atomic_l2(cfg, st, cid, addr, 0, val, False)
    st = st._replace(pa=tables.pa_insert(st.pa, _i32(cfg, st, addr)))
    hot = _one_hot(cfg, st, cid)
    c = st.counters
    c = c._replace(cycles=_add_at(c.cycles + torch.where(hot, 0.0, p.tbl_lat),
                                  hot, p.probe_lat + 1.0),
                   probes=c.probes + float(n),
                   remote_syncs=c.remote_syncs + 1.0)
    return st._replace(counters=c)


def rsp_remote_acquire(cfg: ProtoConfig, st: Store, cid, addr, expect, new
                       ) -> Tuple[Store, torch.Tensor]:
    """Original RSP (§3): promote by flushing EVERY L1, then invalidate
    the own L1 and CAS at L2."""
    p = cfg.params
    n = cfg.n_caches
    st, n_wb = b_drain(cfg, st, DRAIN_ALL, True)
    wait = (p.l2_lat + n_wb * p.wb_per_block).sum()
    c = st.counters
    c = c._replace(cycles=_add_at(c.cycles, _one_hot(cfg, st, cid),
                                  p.probe_lat + wait),
                   probes=c.probes + float(n - 1))
    st = invalidate_cache(cfg, st._replace(counters=c), cid)
    st, old = _atomic_l2(cfg, st, cid, addr, expect, new, True)
    return st._replace(counters=_count(st.counters, remote_syncs=1.0)), old


def rsp_remote_release(cfg: ProtoConfig, st: Store, cid, addr, val) -> Store:
    """Original RSP: flush own, ST at L2, then invalidate EVERY L1."""
    p = cfg.params
    n = cfg.n_caches
    st, _ = drain_fifo_all(cfg, st, cid)
    st, _ = _atomic_l2(cfg, st, cid, addr, 0, val, False)
    st = b_invalidate(cfg, st, True)
    c = st.counters
    c = c._replace(cycles=_add_at(c.cycles, _one_hot(cfg, st, cid),
                                  p.probe_lat + float(n) * p.l2_lat),
                   probes=c.probes + float(n),
                   remote_syncs=c.remote_syncs + 1.0)
    return st._replace(counters=c)


def srsp_remote_acquire_b(cfg: ProtoConfig, st: Store, active, addrs,
                          expect, new) -> Tuple[Store, torch.Tensor]:
    """Masked multi-issuer twin of `srsp_remote_acquire` (DESIGN.md §9):
    one LR sweep over an [cache, lane] lookup matrix and one merged
    drain for every issuer.  Equal to serializing the active lanes in
    ascending order when the batch is address-disjoint."""
    p = cfg.params
    n = cfg.n_caches
    active = _bool(cfg, st, active)
    addrs = _i32(cfg, st, addrs)
    lanes = _lanes(cfg, st)
    # §4.2 fork per lane: a local sharer on the same CU skips promotion
    own_ptr = tables.lr_lookup(st.lr, addrs)
    same = active & (own_ptr >= 0)
    cross = active & (own_ptr < 0)
    st, _ = b_drain(cfg, st, torch.where(same, own_ptr, INVALID), same)
    st = st._replace(lr=_mask_rows(same, tables.lr_remove(st.lr, addrs),
                                   st.lr))
    # cross-CU lanes: one probe round for the whole batch
    ptrs = tables.lr_lookup(st.lr, addrs[None, :].expand(n, n))
    probed = cross[None, :] & (lanes[:, None] != lanes[None, :])
    has = (ptrs >= 0) & probed
    sharer = has.any(dim=1)
    drain_pos = torch.where(has, ptrs, INVALID).amax(dim=1)
    st, n_wb = b_drain(cfg, st, torch.where(sharer, drain_pos, INVALID),
                       sharer)
    shared = addrs[sfifo.first_true(has)]
    st = st._replace(
        lr=_mask_rows(sharer, tables.lr_remove(st.lr, shared), st.lr),
        pa=_mask_rows(sharer, tables.pa_insert(st.pa, shared), st.pa))
    nack = (probed & ~has).to(F32).sum(dim=1) * p.tbl_lat
    wait = torch.where(has, (p.l2_lat + n_wb * p.wb_per_block)[:, None],
                       0.0).sum(dim=0) + 1.0
    c = st.counters
    c = c._replace(
        cycles=c.cycles + nack
        + torch.where(cross, p.probe_lat + p.l2_lat + wait, 0.0),
        probes=c.probes + cross.to(F32).sum() * float(n - 1))
    st = b_invalidate(cfg, st._replace(counters=c), cross)
    st, old = b_atomic_l2(cfg, st, active, addrs, expect, new, True)
    return st._replace(counters=_count(
        st.counters, remote_syncs=active.to(F32).sum())), old


def srsp_remote_release_b(cfg: ProtoConfig, st: Store, active, addrs, vals
                          ) -> Store:
    """Masked multi-issuer twin of `srsp_remote_release`: one merged
    drain, one masked ST at L2, then the selective-invalidate broadcasts
    in ascending lane order (PA ages depend on insertion order)."""
    p = cfg.params
    n = cfg.n_caches
    active = _bool(cfg, st, active)
    addrs = _i32(cfg, st, addrs)
    st, _ = b_drain(cfg, st, _where(active, DRAIN_ALL, INVALID), active)
    st, _ = b_atomic_l2(cfg, st, active, addrs, 0, vals, False)
    st = st._replace(pa=lane_scan(
        active, lambda pa, j: tables.pa_insert(pa, addrs[j].expand(n)),
        st.pa))
    fact = active.to(F32)
    tot = fact.sum()
    c = st.counters
    c = c._replace(cycles=c.cycles + (tot - fact) * p.tbl_lat
                   + torch.where(active, p.probe_lat + 1.0, 0.0),
                   probes=c.probes + tot * float(n),
                   remote_syncs=c.remote_syncs + tot)
    return st._replace(counters=c)


# --------------------------------------------------------------------------
# protocol bundles and the registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Protocol:
    """A registered scope-parametric op table (DESIGN.md §9): per scope,
    a masked multi-agent op (`*_b`) and the scalar single-cache op.
    `acquire_rem_b`/`release_rem_b` are the batched address-disjoint
    remote twins (None: remote turns serialize).  `recover_b(cfg, st,
    mask)` is the elastic engines' crash-recovery drain (None: a dead
    agent's lease never expires).  `crash_gate` is the crash fault's
    (victim, at); None is a healthy protocol."""
    name: str
    acquire_loc_b: Callable
    release_loc_b: Callable
    acquire_loc: Callable
    release_loc: Callable
    acquire_rem: Callable
    release_rem: Callable
    acquire_glob_b: Callable
    release_glob_b: Callable
    acquire_glob: Callable
    release_glob: Callable
    acquire_rem_b: Callable = None
    release_rem_b: Callable = None
    recover_b: Callable = None
    crash_gate: tuple = None

    @property
    def remote_batchable(self) -> bool:
        return self.acquire_rem_b is not None \
            and self.release_rem_b is not None


class UnknownNameError(KeyError, ValueError):
    """Registry miss (both a mapping miss and a bad value)."""


class Registry(dict):
    """name -> object mapping whose misses list every registered key."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def __missing__(self, key):
        raise UnknownNameError(f"unknown {self.kind} {key!r}; "
                               f"registered: {sorted(self)}")


PROTOCOLS = Registry("protocol")


def register_protocol(proto: Protocol) -> Protocol:
    PROTOCOLS[proto.name] = proto
    return proto


def protocols() -> tuple:
    return tuple(sorted(PROTOCOLS))


def get_protocol(name: str) -> Protocol:
    return PROTOCOLS[name]


SRSP = register_protocol(Protocol(
    name="srsp",
    acquire_loc_b=local_acquire_b, release_loc_b=local_release_b,
    acquire_loc=local_acquire, release_loc=local_release,
    acquire_rem=srsp_remote_acquire, release_rem=srsp_remote_release,
    acquire_glob_b=global_acquire_b, release_glob_b=global_release_b,
    acquire_glob=global_acquire, release_glob=global_release,
    acquire_rem_b=srsp_remote_acquire_b,
    release_rem_b=srsp_remote_release_b,
    recover_b=b_recover))

# Original RSP's remote ops touch every cache: no batched remote twin.
RSP = register_protocol(Protocol(
    name="rsp",
    acquire_loc_b=local_acquire_b, release_loc_b=local_release_b,
    acquire_loc=local_acquire, release_loc=local_release,
    acquire_rem=rsp_remote_acquire, release_rem=rsp_remote_release,
    acquire_glob_b=global_acquire_b, release_glob_b=global_release_b,
    acquire_glob=global_acquire, release_glob=global_release,
    recover_b=b_recover))

# Baseline: every scope realized as global sync.
GLOBAL = register_protocol(Protocol(
    name="global",
    acquire_loc_b=global_acquire_b, release_loc_b=global_release_b,
    acquire_loc=global_acquire, release_loc=global_release,
    acquire_rem=global_acquire, release_rem=global_release,
    acquire_glob_b=global_acquire_b, release_glob_b=global_release_b,
    acquire_glob=global_acquire, release_glob=global_release,
    acquire_rem_b=global_acquire_b, release_rem_b=global_release_b,
    recover_b=b_recover))

# NOT remote-safe: REMOTE scope realized as local sync (staleness demo).
LOCAL_ONLY = register_protocol(Protocol(
    name="local",
    acquire_loc_b=local_acquire_b, release_loc_b=local_release_b,
    acquire_loc=local_acquire, release_loc=local_release,
    acquire_rem=local_acquire, release_rem=local_release,
    acquire_glob_b=global_acquire_b, release_glob_b=global_release_b,
    acquire_glob=global_acquire, release_glob=global_release,
    acquire_rem_b=local_acquire_b, release_rem_b=local_release_b,
    recover_b=b_recover))
