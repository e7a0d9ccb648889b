"""Cost model calibrated to the paper's Table 1 (`repro.core.costmodel`).

Every op charges cycles to the issuing cache's accumulator; makespan is
the max over caches.  `Counters` stay float32, as in the JAX package.
Every increment is integral (the `CostParams` latencies and the counts
they multiply are whole numbers) and every total stays far below 2**24,
so each sum is exact in float32 and the same in any order: the port's
reductions may sum in another order than XLA's and still agree bit for
bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class CostParams:
    # Table 1 latencies (cycles)
    l1_lat: float = 4.0
    l2_lat: float = 24.0
    dram_lat: float = 150.0
    # throughput terms
    wb_per_block: float = 4.0      # pipelined writeback issue per 64B block
    inv_flash: float = 1.0         # single-cycle flash invalidate (§2.2)
    probe_lat: float = 8.0         # selective-flush / inv probe hop
    tbl_lat: float = 1.0           # LR/PA CAM lookup
    # work model for the work-stealing apps (cycles)
    task_base: float = 20.0
    per_edge: float = 6.0


class Counters(NamedTuple):
    cycles: torch.Tensor        # [n_caches] f32 per-cache busy cycles
    l2_accesses: torch.Tensor   # [] f32 data transactions at L2
    wb_blocks: torch.Tensor     # [] f32 blocks written back
    inv_full: torch.Tensor      # [] f32 whole-cache invalidations
    inv_per_cache: torch.Tensor  # [n_caches] f32 invalidations per cache
    probes: torch.Tensor        # [] f32 control probes sent
    promotions: torch.Tensor    # [] f32 promoted local acquires
    local_syncs: torch.Tensor   # [] f32
    remote_syncs: torch.Tensor  # [] f32
    global_syncs: torch.Tensor  # [] f32
    l1_hits: torch.Tensor       # [] f32
    l1_misses: torch.Tensor     # [] f32
    steals: torch.Tensor        # [] f32
    recoveries: torch.Tensor    # [] f32


def make_counters(n_caches: int, device=None) -> Counters:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return Counters(cycles=z(n_caches), l2_accesses=z(), wb_blocks=z(),
                    inv_full=z(), inv_per_cache=z(n_caches), probes=z(),
                    promotions=z(), local_syncs=z(), remote_syncs=z(),
                    global_syncs=z(), l1_hits=z(), l1_misses=z(), steals=z(),
                    recoveries=z())


def makespan(c: Counters) -> torch.Tensor:
    return c.cycles.max()


def charged_since(c: Counters, clock0) -> torch.Tensor:
    """Per-cache cycles charged since a captured clock vector, float32:
    what the event trace and the per-turn latency histograms attribute
    to each lane (DESIGN.md §11).  A lane's delta across an op includes
    what other lanes' ops billed it in the same call."""
    return c.cycles - torch.as_tensor(clock0, dtype=torch.float32,
                                      device=c.cycles.device)
