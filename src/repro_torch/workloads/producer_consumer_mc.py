"""Multi-consumer producer/consumer (`repro.workloads.producer_consumer_mc`).

The `producer_consumer` spec with ``max(2, n_agents // 8)`` drainers (one
per 8 agents, at least two), so the rare remote work itself
parallelizes: partitioned victims give concurrent drains distinct lock
addresses, and protocols with batched remote twins (srsp, global, local)
co-schedule them in one masked remote turn.
"""
from __future__ import annotations

from repro_torch.core import protocol as P
from repro_torch.workloads import harness, producer_consumer as _pc

VMAPPABLE = True
Config = _pc.Config
PCState = _pc.PCState
init_state = _pc.init_state
self_check = _pc.self_check
build_workload = _pc.build_workload


def default_consumers(n_agents: int) -> int:
    """One drainer per 8 agents, at least two, and at most n_agents - 1
    (tiny machines degrade to the single-consumer shape)."""
    return max(1, min(n_agents - 1, max(2, n_agents // 8)))


def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Bench for one scenario; runs on `device` (default: the GPU)."""
    kw.setdefault("n_consumers", default_consumers(n_agents))
    return _pc.build(scenario, n_agents, seed, proto=proto, device=device,
                     **kw)
