"""Seeded inputs for checking each kernel against its plain version.

One list of cases per kernel: the main path's shapes at n=64 and n=256
plus the edge cases (duplicate destinations, pads, out-of-range indices
and offsets, dirty bit 31, a ragged last lane, remote_cap, fences, empty
masks).  `chip_smoke.py` and `tests/test_torch_cuda.py` run these lists
on the card; `tests/test_torch_kernels.py` feeds the same generators to
the JAX package's Pallas kernels.  Generators return numpy arrays, packed
planes as uint32; `to_torch` views those as the port's int32 bit
patterns.
"""
from __future__ import annotations

import numpy as np
import torch


def words(rng, shape, w):
    """Random packed lanes for width w: every real bit random (bit 31
    included when w >= 32), padding bits zero."""
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    keep = np.array([(1 << min(32, max(0, w - 32 * k))) - 1
                     for k in range(shape[-1])], np.uint64).astype(np.uint32)
    return x & keep


def to_torch(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def dw_inputs(seed, nb, w, m, *, dup=True, pad=True, oor=False):
    """drain_writeback (l2, rows, dirty, idx).  dup=False draws distinct
    destinations (the b_writeback shape); pads are -1; out-of-range
    destinations are >= nb."""
    rng = np.random.default_rng(seed)
    l2 = rng.integers(-2**31, 2**31, (nb, w), dtype=np.int64) \
        .astype(np.int32)
    rows = rng.integers(-2**31, 2**31, (m, w), dtype=np.int64) \
        .astype(np.int32)
    dirty = words(rng, (m, (w + 31) // 32), w)
    if dup:
        idx = rng.integers(0, max(2, nb // 4), m).astype(np.int32)
    else:
        idx = rng.permutation(nb)[:m].astype(np.int32)
    if pad:
        idx[rng.random(m) < 0.25] = -1
    if oor:
        idx[rng.random(m) < 0.15] = nb + rng.integers(0, 3)
    return l2, rows, dirty, idx


def pc_inputs(seed, n, nb, w, *, oor=False):
    """plane_commit (wvalid, wdirty, b, o, set_valid, set_dirty).  A
    quarter of the lanes target the sign bit's word.  oor=True puts some
    blocks outside [0, nb) (clamped) and some offsets outside the row's
    lanes (an empty bit)."""
    rng = np.random.default_rng(seed)
    lanes = (w + 31) // 32
    wv = words(rng, (n, nb, lanes), w)
    wd = words(rng, (n, nb, lanes), w)
    b = rng.integers(0, nb, n).astype(np.int32)
    o = rng.integers(0, w, n).astype(np.int32)
    o[: max(1, n // 4)] = min(31, w - 1)
    if oor:
        b[rng.random(n) < 0.2] = -1
        b[rng.random(n) < 0.2] = nb + 2
        o[rng.random(n) < 0.2] = -5
        o[rng.random(n) < 0.2] = 32 * lanes + 3
    sv = rng.random(n) < 0.7
    sd = rng.random(n) < 0.5
    return wv, wd, b, o, sv, sd


def plan_inputs(seed, n, *, can_l=None, can_r=None):
    """trip_plan (clocks, can_l, can_r, bound, raddr).  Small-integer
    clocks force ties, the lexicographic order's hard case; can_l/can_r
    given as a bool fill the whole mask."""
    rng = np.random.default_rng(seed)
    clocks = rng.integers(0, max(2, n // 3), n).astype(np.float32)
    cl = rng.random(n) < 0.6 if can_l is None else np.full(n, can_l)
    cr = rng.random(n) < 0.4 if can_r is None else np.full(n, can_r)
    bound = rng.integers(1, 5, n).astype(np.float32)
    raddr = rng.integers(0, max(2, n // 4), n).astype(np.int32)
    return clocks, cl, cr, bound, raddr


# (name, keyword arguments of the generator); the seed is the case's index
DRAIN_CASES = [
    ("b_drain n=64", dict(nb=128, w=16, m=1024)),
    ("b_writeback n=64", dict(nb=128, w=16, m=64, dup=False)),
    ("b_drain n=256", dict(nb=512, w=16, m=4096)),
    ("dups+pads+out-of-range, bit 31", dict(nb=32, w=64, m=48, oor=True)),
    ("ragged lane, no pads", dict(nb=16, w=40, m=40, pad=False, oor=True)),
]
COMMIT_CASES = [
    ("n=64", dict(n=64, nb=128, w=16)),
    ("n=256", dict(n=256, nb=512, w=16)),
    ("two lanes, bit 31", dict(n=6, nb=8, w=64)),
    ("ragged lane, out of range", dict(n=8, nb=4, w=40, oor=True)),
]
PLAN_CASES = (
    [(f"n={n} remote_cap={cap} fenced={fenced}",
      dict(n=n), cap, fenced)
     for n in (1, 64, 256, 1024) for cap in (False, True)
     for fenced in (False, True)]
    + [(f"n=64 empty masks can_l={cl} can_r={cr}",
        dict(n=64, can_l=cl, can_r=cr), True, False)
       for cl, cr in ((False, False), (True, False), (False, True))])


def horizon(clocks, fenced):
    """The fenced cases' event horizon: the median clock (None: no fence)."""
    return float(np.sort(clocks)[len(clocks) // 2]) if fenced else None
