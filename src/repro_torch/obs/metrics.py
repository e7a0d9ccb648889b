"""Log-bucketed cycle histograms and bracketing percentiles
(`repro.obs.metrics`, DESIGN.md §11).

    bucket 0      covers [0, 1)
    bucket k >= 1 covers [2^(k-1), 2^k)
    bucket B-1    additionally absorbs everything >= 2^(B-2) (clamp)

`bucket_index` places a sample by an exact `searchsorted` against the
power-of-two edges (no float log), so it is bit for bit the reference's.
The percentile helpers are host-side numpy: `percentile_bounds(hist, q)`
brackets every standard q-quantile of the raw samples, and `summarize`
reports the conservative upper edge as p50/p95/p99.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_BUCKETS = 24

# power-of-two upper edges 1, 2, 4, ..., 2^(B-2); exact in i32/f32
_EDGES = np.asarray([1 << k for k in range(N_BUCKETS - 1)], np.float32)
_EDGES_ON = {}      # the edges on each device they were asked for


def bucket_index(x: torch.Tensor) -> torch.Tensor:
    """Bucket of each non-negative float32 sample (exact edges)."""
    x = x.to(torch.float32)
    edges = _EDGES_ON.get(x.device)
    if edges is None:
        edges = _EDGES_ON[x.device] = torch.from_numpy(_EDGES).to(x.device)
    return torch.searchsorted(edges, x, right=True).to(torch.int32)


def bucket_lo(k: int) -> float:
    return 0.0 if k == 0 else float(2 ** (k - 1))


def bucket_hi(k: int) -> float:
    return math.inf if k >= N_BUCKETS - 1 else float(2 ** k)


def percentile_bounds(hist, q: float) -> tuple:
    """(lo, hi) edges bracketing the q-quantile of the bucketed samples.
    `hist` is a [N_BUCKETS] count vector; q in [0, 1].  Empty histogram
    -> (0.0, 0.0)."""
    h = np.asarray(hist, np.int64)
    c = np.cumsum(h)
    total = int(c[-1]) if h.size else 0
    if total == 0:
        return (0.0, 0.0)
    lo_rank = int(np.floor(q * (total - 1)))   # 0-indexed order statistics
    hi_rank = int(np.ceil(q * (total - 1)))
    klo = int(np.searchsorted(c, lo_rank + 1))
    khi = int(np.searchsorted(c, hi_rank + 1))
    return (bucket_lo(klo), bucket_hi(khi))


def percentile_upper(hist, q: float) -> float:
    """Conservative q-quantile: the bracketing bucket's upper edge, or
    the clamp bucket's finite lower edge (a lower bound there)."""
    lo, hi = percentile_bounds(hist, q)
    return lo if math.isinf(hi) else hi


def summarize(hist) -> dict:
    """{'count', 'p50', 'p95', 'p99'} of a bucketed sample set."""
    h = np.asarray(hist, np.int64)
    return {
        "count": int(h.sum()),
        "p50": percentile_upper(h, 0.50),
        "p95": percentile_upper(h, 0.95),
        "p99": percentile_upper(h, 0.99),
    }
