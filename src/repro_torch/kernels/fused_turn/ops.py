"""The fused-turn kernels: `trip_plan` and `plane_commit` (DESIGN.md §12).

Both dispatch by device (`kernels/common.py`): CPU tensors take the plain
versions `trip_plan_ref` / `plane_commit_ref`, CUDA tensors launch the
hand-written kernels `csrc/trip_plan.cu` and `csrc/plane_commit.cu`,
which replace the Pallas TPU kernels `trip_plan_pallas`
(src/repro/kernels/fused_turn/kernel.py:94) and `plane_commit_pallas`
(:138).  The source notes give each kernel's design and its bound.

Each has a replica instance, `trip_plan_many` and `plane_commit_many`,
for the Pallas kernel's batch grid axis under `jax.vmap` (the harness's
`run_*_many`): a leading [R] axis on every operand, one launch for all
R replicas, each counting its own launches.  The plain versions take
that axis too.  A wrapper called under `torch.func.vmap` on
replica-batched tensors reaches its replica instance through a custom
op's vmap rule (`common.replica_op`).

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
    """Plain version of the `_batched_trip` selection math over the last
    axis: [n] lanes, or [R, n] for R replicas (the replica instance), a
    plan each.  `raddr` None skips the remote dedup (no remote-batching
    capability); `horizon` (0-d, or [R]) None is no event fence."""
    n = clocks.shape[-1]
    wgs = torch.arange(n, dtype=I32, device=clocks.device)
    cand = can_l | can_r
    wg = torch.where(cand, clocks, BIG).argmin(dim=-1).to(I32)
    sclk = torch.where(can_r, clocks, BIG)
    ms = sclk.amin(dim=-1, keepdim=True)
    js = sclk.argmin(dim=-1, keepdim=True).to(I32)
    fence = torch.where(can_l, clocks + bound, BIG).amin(dim=-1, keepdim=True)
    lex = (clocks < ms) | ((clocks == ms) & (wgs < js))
    batch = can_l & lex & (clocks <= fence)
    if horizon is not None:
        batch = batch & (clocks < horizon[..., None])
    # can_l[wg] & (wgs == wg) == can_l & (wgs == wg), without a host read
    lmask = batch | (~batch.any(dim=-1, keepdim=True) & can_l
                     & (wgs == wg[..., None]))
    if raddr is None:
        return TripPlan(lmask, torch.zeros_like(can_l), wg)
    lclk = torch.where(can_l, clocks, BIG)
    ml = lclk.amin(dim=-1, keepdim=True)
    jl = lclk.argmin(dim=-1, keepdim=True).to(I32)
    r0 = can_r & ((clocks < ml) | ((clocks == ml) & (wgs < jl)))
    if horizon is not None:
        r0 = r0 & (clocks < horizon[..., None])
    collide = r0[..., :, None] & r0[..., None, :] \
        & (raddr[..., :, None] == raddr[..., None, :])
    ci, cj = clocks[..., :, None], clocks[..., None, :]
    earlier = (cj < ci) | ((cj == ci) & (wgs[None, :] < wgs[:, None]))
    rmask = r0 & ~(collide & earlier).any(dim=-1)
    return TripPlan(lmask, rmask, wg)


def _plan_check(clocks, can_l, can_r, bound, raddr, remote_cap):
    n = clocks.shape[-1]
    lead = tuple(clocks.shape[:-1])
    if not 1 <= n <= MAX_PLAN_LANES:
        raise ValueError(f"trip_plan kernel takes 1..{MAX_PLAN_LANES} "
                         f"lanes, got {n}")
    for t, name, dt in ((clocks, "clocks", torch.float32),
                        (can_l, "can_l", torch.bool),
                        (can_r, "can_r", torch.bool),
                        (bound, "bound", torch.float32)):
        common.require(t, name, dt, lead + (n,))
    if remote_cap:
        common.require(raddr, "raddr", I32, lead + (n,))


def _plan_launch(clocks, can_l, can_r, bound, raddr, horizon, remote_cap):
    n = clocks.shape[0]
    _plan_check(clocks, can_l, can_r, bound, raddr, remote_cap)
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
    be None when remote_cap is False; `horizon` None means no fence.
    Under vmap, replica-batched inputs take one `trip_plan_many` call
    for every replica."""
    raddr = raddr if remote_cap else None
    if common.batched(clocks, can_l, can_r, bound, raddr, horizon):
        op = common.replica_op(
            "trip_plan", "(Tensor clocks, Tensor can_l, Tensor can_r, "
            "Tensor bound, Tensor? raddr, Tensor? horizon, bool remote_cap)"
            " -> (Tensor, Tensor, Tensor)", _plan_impl, _plan_rule)
        return TripPlan(*op(clocks, can_l, can_r, bound, raddr, horizon,
                            remote_cap))
    tensors = [clocks, can_l, can_r, bound] + ([raddr] if remote_cap else [])
    if common.on_cuda(*tensors):
        return _plan_launch(clocks, can_l, can_r, bound, raddr, horizon,
                            remote_cap)
    return trip_plan_ref(clocks, can_l, can_r, bound, raddr, horizon)


trip_plan.launches = 0


def _plan_many_launch(clocks, can_l, can_r, bound, raddr, horizon,
                      remote_cap):
    reps, n = clocks.shape
    _plan_check(clocks, can_l, can_r, bound, raddr, remote_cap)
    if horizon is not None:
        common.require(horizon, "horizon", torch.float32, (reps,))
    # the solo layout, R rows of each mask and R int32 wg
    off = common.round_up(2 * reps * n, 4)
    buf = torch.empty((off + 4 * reps,), dtype=torch.uint8,
                      device=clocks.device)
    lmask, rmask, _ = buf.view(torch.bool).split(
        (reps * n, reps * n, off + 4 * reps - 2 * reps * n))
    lmask, rmask = lmask.view(reps, n), rmask.view(reps, n)
    wg = buf.view(I32)[off // 4:]
    common.launch("trip_plan", [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
                  clocks.device,
                  *(common.ptr(t) for t in (clocks, can_l, can_r, bound)),
                  common.ptr(raddr) if remote_cap else ctypes.c_void_p(),
                  ctypes.c_void_p() if horizon is None
                  else common.ptr(horizon), int(remote_cap), reps, n,
                  *(common.ptr(t) for t in (lmask, rmask, wg)),
                  entry="trip_plan_many")
    trip_plan_many.launches += 1
    return TripPlan(lmask, rmask, wg)


def trip_plan_many(clocks, can_l, can_r, bound, raddr, horizon, *,
                   remote_cap: bool) -> TripPlan:
    """The replica instance: R plans from [R, n] inputs (`horizon` [R] or
    None), [R, n] masks and [R] wg; CUDA tensors launch one CTA a replica
    in one launch."""
    raddr = raddr if remote_cap else None
    tensors = [clocks, can_l, can_r, bound] + ([raddr] if remote_cap else [])
    if common.on_cuda(*tensors):
        return _plan_many_launch(clocks, can_l, can_r, bound, raddr,
                                 horizon, remote_cap)
    return trip_plan_ref(clocks, can_l, can_r, bound, raddr, horizon)


trip_plan_many.launches = 0


def _plan_impl(clocks, can_l, can_r, bound, raddr, horizon, remote_cap):
    return tuple(trip_plan(clocks, can_l, can_r, bound, raddr, horizon,
                           remote_cap=remote_cap))


def _plan_rule(info, in_dims, clocks, can_l, can_r, bound, raddr, horizon,
               remote_cap):
    args = [common.to_front(info.batch_size, x, d) for x, d in
            zip((clocks, can_l, can_r, bound, raddr, horizon), in_dims)]
    return tuple(trip_plan_many(*args, remote_cap=remote_cap)), (0, 0, 0)


def plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty):
    """Plain version: pre-op valid/dirty bits of word o[i] of block b[i]
    in lane i, then the set_valid / set_dirty bits ORed in.  Planes are
    [n, nb, L] int32 bit patterns or [n, nb, W] bool flags; `set_dirty`
    None leaves wdirty as it is.  Returns (wvalid', wdirty', was_valid,
    was_dirty).  The replica instance takes [R, n, nb, L] planes and
    [R, n] operands: every (replica, lane) is a row of its own.

    As in the Pallas kernel, a block outside [0, nb) is clamped into it,
    and an offset outside the row's L lanes has an empty bit: its was_*
    bits are False and it sets nothing.  The bool layout takes in-range
    targets only, as the reference's does."""
    if wvalid.ndim == 4:
        lead = b.shape
        out = plane_commit_ref(
            wvalid.flatten(0, 1), wdirty.flatten(0, 1), b.flatten(),
            o.flatten(), set_valid.flatten(),
            None if set_dirty is None else set_dirty.flatten())
        return (out[0].view(wvalid.shape), out[1].view(wdirty.shape),
                out[2].view(lead), out[3].view(lead))
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
    """Launch over [n, nb, L] planes, or [R, n, nb, L] ones whose R*n
    (replica, lane) rows the kernel takes as R*n lanes."""
    shape, lead = wvalid.shape, b.shape
    nb, lanes = shape[-2:]
    n = b.numel()
    common.require(wvalid, "wvalid", I32, shape)
    common.require(wdirty, "wdirty", I32, shape)
    if tuple(shape[:-2]) != tuple(lead):
        raise ValueError(f"plane_commit: planes {tuple(shape)} do not "
                         f"match operands {tuple(lead)}")
    for t, name, dt in ((b, "b", I32), (o, "o", I32),
                        (set_valid, "set_valid", torch.bool),
                        (set_dirty, "set_dirty", torch.bool)):
        common.require(t, name, dt, lead)
    # one buffer for both fresh planes and one for both flag vectors: two
    # allocations in place of four, and a shorter kernel at n=256
    # (PERF.md §6).
    # Nothing of the port writes into a plane in place, so the planes may
    # share a storage.
    wv2, wd2 = torch.empty((2,) + tuple(shape), dtype=I32,
                           device=wvalid.device).unbind()
    was_v, was_d = torch.empty((2,) + tuple(lead), dtype=torch.bool,
                               device=wvalid.device).unbind()
    common.launch("plane_commit", [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 3, wvalid.device,
                  *(common.ptr(t) for t in (wvalid, wdirty, b, o, set_valid,
                                            set_dirty, wv2, wd2, was_v,
                                            was_d)), n, nb, lanes)
    return wv2, wd2, was_v, was_d


def plane_commit(wvalid, wdirty, b, o, set_valid, set_dirty):
    """Fused metadata-plane front end (`plane_commit_ref`'s contract);
    returns fresh planes.  The load shape and bool planes take the plain
    version on every device (see the module note).  Under vmap,
    replica-batched inputs of the store shape take one
    `plane_commit_many` call for every replica."""
    if set_dirty is None or wvalid.dtype == torch.bool:
        return plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty)
    if common.batched(wvalid, wdirty, b, o, set_valid, set_dirty):
        op = common.replica_op(
            "plane_commit", "(Tensor wvalid, Tensor wdirty, Tensor b, "
            "Tensor o, Tensor set_valid, Tensor set_dirty) -> (Tensor, "
            "Tensor, Tensor, Tensor)", _commit_impl, _commit_rule)
        return op(wvalid, wdirty, b, o, set_valid, set_dirty)
    if common.on_cuda(wvalid, wdirty, b, o, set_valid, set_dirty):
        out = _commit_launch(wvalid, wdirty, b, o, set_valid, set_dirty)
        plane_commit.launches += 1
        return out
    return plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty)


plane_commit.launches = 0


def plane_commit_many(wvalid, wdirty, b, o, set_valid, set_dirty):
    """The replica instance of the store shape: [R, n, nb, L] planes and
    [R, n] operands; CUDA tensors launch the kernel once over the R*n
    (replica, lane) rows."""
    if common.on_cuda(wvalid, wdirty, b, o, set_valid, set_dirty):
        out = _commit_launch(wvalid, wdirty, b, o, set_valid, set_dirty)
        plane_commit_many.launches += 1
        return out
    return plane_commit_ref(wvalid, wdirty, b, o, set_valid, set_dirty)


plane_commit_many.launches = 0


def _commit_impl(wvalid, wdirty, b, o, set_valid, set_dirty):
    return tuple(plane_commit(wvalid, wdirty, b, o, set_valid, set_dirty))


def _commit_rule(info, in_dims, *args):
    args = [common.to_front(info.batch_size, x, d)
            for x, d in zip(args, in_dims)]
    return tuple(plane_commit_many(*args)), (0, 0, 0, 0)
