"""Synthetic CSR graphs standing in for the paper's DIMACS inputs (§5.1);
a copy of `repro.data.graphs` (numpy only), so the port draws the same
graphs bit for bit without importing the JAX package.

This environment is offline, so we generate graphs with the same structural
character as the ones the paper uses:

  * ``collab_like``  — power-law collaboration network (cond-mat-2003; used
    by PageRank in the paper): preferential attachment, heavy-tailed degree
    distribution -> strong per-chunk work imbalance.
  * ``road_like``    — sparse near-planar grid with a small fraction of
    shortcut edges (USA-road-d.BAY; used by SSSP).  Shortcuts keep the
    diameter (== SSSP round count) manageable in the offline simulator;
    the substitution is documented in EXPERIMENTS.md.
  * ``router_like``  — power-law with lower attachment (caidaRouterLevel;
    used by MIS).

All graphs are undirected (symmetrized), weights uniform in [1, 16).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray   # [n+1] int32
    indices: np.ndarray  # [nnz] int32
    weights: np.ndarray  # [nnz] int32
    name: str

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)


def _to_csr(n: int, src: np.ndarray, dst: np.ndarray, rng, name: str) -> CSRGraph:
    # symmetrize + dedup + drop self loops
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keep = u != v
    u, v = u[keep], v[keep]
    key = u.astype(np.int64) * n + v
    _, idx = np.unique(key, return_index=True)
    u, v = u[idx], v[idx]
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, u + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int64).astype(np.int32)
    w = rng.integers(1, 16, size=len(v)).astype(np.int32)
    return CSRGraph(indptr, v.astype(np.int32), w, name)


def collab_like(n: int = 8192, m: int = 6, seed: int = 0) -> CSRGraph:
    """Preferential-attachment graph (Barabási–Albert style)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    src, dst = [], []
    repeated: list[int] = list(range(m))
    for v in range(m, n):
        picks = rng.choice(len(repeated), size=m, replace=True)
        chosen = {repeated[p] for p in picks}
        for t in chosen:
            src.append(v)
            dst.append(t)
            repeated.append(t)
            repeated.append(v)
    return _to_csr(n, np.array(src, np.int64), np.array(dst, np.int64), rng,
                   f"collab_like_n{n}")


def router_like(n: int = 8192, seed: int = 1) -> CSRGraph:
    g = collab_like(n, m=2, seed=seed)
    return g._replace(name=f"router_like_n{n}")


def road_like(n: int = 16384, shortcut_frac: float = 0.01, seed: int = 2) -> CSRGraph:
    """Grid road network with a few express shortcuts (keeps diameter small)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    n = side * side
    ids = np.arange(n).reshape(side, side)
    src, dst = [], []
    # 4-neighborhood with 10% random removals (non-grid irregularity)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], 1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], 1)
    edges = np.concatenate([right, down], 0)
    keep = rng.random(len(edges)) > 0.1
    edges = edges[keep]
    src, dst = edges[:, 0], edges[:, 1]
    # express shortcuts
    k = int(n * shortcut_frac)
    s = rng.integers(0, n, k)
    d = rng.integers(0, n, k)
    return _to_csr(n, np.concatenate([src, s]).astype(np.int64),
                   np.concatenate([dst, d]).astype(np.int64), rng,
                   f"road_like_n{n}")


GRAPHS = {
    "collab_like": collab_like,
    "router_like": router_like,
    "road_like": road_like,
}
