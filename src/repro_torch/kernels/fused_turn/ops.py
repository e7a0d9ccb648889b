"""The fused-turn kernels: `trip_plan` and `plane_commit` (DESIGN.md §12).

Both dispatch by device (`kernels/common.py`): CPU tensors take the plain
versions `trip_plan_ref` / `plane_commit_ref`, CUDA tensors launch the
hand-written kernels `csrc/trip_plan.cu` and `csrc/plane_commit.cu`,
which replace the Pallas TPU kernels `trip_plan_pallas`
(src/repro/kernels/fused_turn/kernel.py:94) and `plane_commit_pallas`
(:138).  The source notes give each kernel's design and its bound.

`plane_commit` takes the plain version on every device in two cases, as
the JAX package does (`fused_turn/ops.py:57-59`), and neither is a
fallback from a failed launch:
  * `set_dirty=None`, the `b_load` shape: the kernel covers the store
    shape only;
  * bool planes, the `REPRO_NO_PACK=1` layout: the reference never sends
    them to its Pallas kernel, which takes packed lanes only, so the port
    has no kernel for them either.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import bitmask
from repro_torch.kernels import common

BIG = 3e38          # float32(3e38); clocks stay far below it
MAX_PLAN_LANES = 1024
I32 = torch.int32


class TripPlan(NamedTuple):
    """One batched-trip scheduling decision."""
    lmask: torch.Tensor   # [n] bool  agents whose local turn executes
    rmask: torch.Tensor   # [n] bool  co-schedulable remote batch
    wg: torch.Tensor      # []  int32 serial-fallback agent (first argmin)


def trip_plan_ref(clocks, can_l, can_r, bound, raddr, horizon) -> TripPlan:
    """Plain version of the `_batched_trip` selection math.  `raddr` None
    skips the remote dedup (no remote-batching capability); `horizon`
    None is no event fence."""
    n = clocks.shape[0]
    wgs = torch.arange(n, dtype=I32, device=clocks.device)
    cand = can_l | can_r
    wg = torch.where(cand, clocks, BIG).argmin().to(I32)
    sclk = torch.where(can_r, clocks, BIG)
    ms = sclk.min()
    js = sclk.argmin().to(I32)
    fence = torch.where(can_l, clocks + bound, BIG).min()
    lex = (clocks < ms) | ((clocks == ms) & (wgs < js))
    batch = can_l & lex & (clocks <= fence)
    if horizon is not None:
        batch = batch & (clocks < horizon)
    # can_l[wg] & (wgs == wg) == can_l & (wgs == wg), without a host read
    lmask = batch | (~batch.any() & can_l & (wgs == wg))
    if raddr is None:
        return TripPlan(lmask, torch.zeros_like(can_l), wg)
    lclk = torch.where(can_l, clocks, BIG)
    ml = lclk.min()
    jl = lclk.argmin().to(I32)
    r0 = can_r & ((clocks < ml) | ((clocks == ml) & (wgs < jl)))
    if horizon is not None:
        r0 = r0 & (clocks < horizon)
    collide = r0[:, None] & r0[None, :] & (raddr[:, None] == raddr[None, :])
    earlier = (clocks[None, :] < clocks[:, None]) \
        | ((clocks[None, :] == clocks[:, None]) & (wgs[None, :] < wgs[:, None]))
    rmask = r0 & ~(collide & earlier).any(dim=1)
    return TripPlan(lmask, rmask, wg)


def _plan_launch(clocks, can_l, can_r, bound, raddr, horizon, remote_cap):
    n = clocks.shape[0]
    if not 1 <= n <= MAX_PLAN_LANES:
        raise ValueError(f"trip_plan kernel takes 1..{MAX_PLAN_LANES} "
                         f"lanes, got {n}")
    for t, name, dt in ((clocks, "clocks", torch.float32),
                        (can_l, "can_l", torch.bool),
                        (can_r, "can_r", torch.bool),
                        (bound, "bound", torch.float32)):
        common.require(t, name, dt, (n,))
    if remote_cap:
        common.require(raddr, "raddr", I32, (n,))
    # one buffer for the three outputs: lmask bytes [0, n), rmask bytes
    # [n, 2n), wg the int32 at bytes [off, off + 4)
    off = common.round_up(2 * n, 4)
    buf = torch.empty((off + 4,), dtype=torch.uint8, device=clocks.device)
    lmask, rmask, _ = buf.view(torch.bool).split((n, n, off + 4 - 2 * n))
    wg = buf.view(I32)[off // 4]
    common.launch("trip_plan", [ctypes.c_void_p] * 5
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_void_p] * 3, clocks.device,
                  *(common.ptr(t) for t in (clocks, can_l, can_r, bound)),
                  common.ptr(raddr) if remote_cap else ctypes.c_void_p(),
                  BIG if horizon is None else float(horizon),
                  int(remote_cap), n,
                  *(common.ptr(t) for t in (lmask, rmask, wg)))
    trip_plan.launches += 1
    return TripPlan(lmask, rmask, wg)


def trip_plan(clocks, can_l, can_r, bound, raddr, horizon, *,
              remote_cap: bool) -> TripPlan:
    """One batched-trip plan (`trip_plan_ref`'s contract).  `raddr` may
    be None when remote_cap is False; `horizon` None means no fence."""
    tensors = [clocks, can_l, can_r, bound] + ([raddr] if remote_cap else [])
    if common.on_cuda(*tensors):
        return _plan_launch(clocks, can_l, can_r, bound,
                            raddr if remote_cap else None, horizon,
                            remote_cap)
    return trip_plan_ref(clocks, can_l, can_r, bound,
                         raddr if remote_cap else None, horizon)


trip_plan.launches = 0


def plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty):
    """Plain version: pre-op valid/dirty bits of word o[i] of block b[i]
    in lane i, then the set_valid / set_dirty bits ORed in.  Planes are
    [n, nb, L] int32 bit patterns or [n, nb, W] bool flags; `set_dirty`
    None leaves wdirty as it is.  Returns (wvalid', wdirty', was_valid,
    was_dirty).

    As in the Pallas kernel, a block outside [0, nb) is clamped into it,
    and an offset outside the row's L lanes has an empty bit: its was_*
    bits are False and it sets nothing.  The bool layout takes in-range
    targets only, as the reference's does."""
    n, nb, lanes = wvalid.shape
    lane = torch.arange(n, device=wvalid.device)
    b = b.long().clamp(0, nb - 1)
    if wvalid.dtype == torch.bool:
        o = o.long()
        was_valid = wvalid[lane, b, o]
        was_dirty = wdirty[lane, b, o]
        wvalid = wvalid.clone()
        wvalid[lane, b, o] = was_valid | set_valid
        if set_dirty is not None:
            wdirty = wdirty.clone()
            wdirty[lane, b, o] = was_dirty | set_dirty
        return wvalid, wdirty, was_valid, was_dirty
    w = bitmask.word_index(o).long()
    in_row = (w >= 0) & (w < lanes)
    w = torch.where(in_row, w, 0)
    bit = torch.where(in_row, bitmask.word_bit(o), 0)
    wv = wvalid[lane, b, w]
    wd = wdirty[lane, b, w]
    was_valid = (wv & bit) != 0
    was_dirty = (wd & bit) != 0
    wvalid = wvalid.clone()
    wvalid[lane, b, w] = wv | torch.where(set_valid, bit, 0)
    if set_dirty is not None:
        wdirty = wdirty.clone()
        wdirty[lane, b, w] = wd | torch.where(set_dirty, bit, 0)
    return wvalid, wdirty, was_valid, was_dirty


def _commit_launch(wvalid, wdirty, b, o, set_valid, set_dirty):
    n, nb, lanes = wvalid.shape
    common.require(wvalid, "wvalid", I32, (n, nb, lanes))
    common.require(wdirty, "wdirty", I32, (n, nb, lanes))
    for t, name, dt in ((b, "b", I32), (o, "o", I32),
                        (set_valid, "set_valid", torch.bool),
                        (set_dirty, "set_dirty", torch.bool)):
        common.require(t, name, dt, (n,))
    wv2 = torch.empty_like(wvalid)
    wd2 = torch.empty_like(wdirty)
    was_v = torch.empty((n,), dtype=torch.bool, device=wvalid.device)
    was_d = torch.empty_like(was_v)
    common.launch("plane_commit", [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 3, wvalid.device,
                  *(common.ptr(t) for t in (wvalid, wdirty, b, o, set_valid,
                                            set_dirty, wv2, wd2, was_v,
                                            was_d)), n, nb, lanes)
    plane_commit.launches += 1
    return wv2, wd2, was_v, was_d


def plane_commit(wvalid, wdirty, b, o, set_valid, set_dirty):
    """Fused metadata-plane front end (`plane_commit_ref`'s contract);
    returns fresh planes.  The load shape and bool planes take the plain
    version on every device (see the module note)."""
    if set_dirty is not None and wvalid.dtype != torch.bool \
            and common.on_cuda(wvalid, wdirty, b, o, set_valid, set_dirty):
        return _commit_launch(wvalid, wdirty, b, o, set_valid, set_dirty)
    return plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty)


plane_commit.launches = 0
