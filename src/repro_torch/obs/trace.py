"""The Store's event-trace leaf, disabled part only (`repro.obs.trace`).

In the JAX package a disabled trace is a log of zero capacity, and every
`record_*` helper returns its input unchanged by a Python-level branch
(DESIGN.md §11), so no traced op changes a result.  The port carries the
same zero-capacity log, so Store leaves line up with the JAX package's
one for one; a nonzero capacity is not ported yet and raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs.metrics import N_BUCKETS

# event kinds
ACQUIRE, RELEASE, LOAD, STORE, CHURN, RECOVER = range(6)
# op outcomes
OC_NONE, OC_HIT, OC_PROMOTE, OC_PROBE, OC_NACK, OC_GLOBAL, OC_MISS, \
    OC_RECOVER = range(8)


class TraceLog(NamedTuple):
    head: torch.Tensor       # [] i32 monotonic event count
    clock: torch.Tensor      # [cap] f32
    agent: torch.Tensor      # [cap] i32
    kind: torch.Tensor       # [cap] i32
    scope: torch.Tensor      # [cap] i32
    addr: torch.Tensor       # [cap] i32
    cycles: torch.Tensor     # [cap] f32
    outcome: torch.Tensor    # [cap] i32
    op_hist: torch.Tensor    # [3, n, B] i32
    turn_hist: torch.Tensor  # [n, B] i32


def make(cap: int = 0, n_agents: int = 0, device=None) -> TraceLog:
    """The disabled (zero-capacity) log."""
    if cap:
        raise NotImplementedError("the port carries disabled traces only")
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TraceLog(head=torch.zeros((), **i32), clock=torch.zeros(0, **f32),
                    agent=torch.zeros(0, **i32), kind=torch.zeros(0, **i32),
                    scope=torch.zeros(0, **i32), addr=torch.zeros(0, **i32),
                    cycles=torch.zeros(0, **f32),
                    outcome=torch.zeros(0, **i32),
                    op_hist=torch.zeros((3, 0, N_BUCKETS), **i32),
                    turn_hist=torch.zeros((0, N_BUCKETS), **i32))


def enabled(tl: TraceLog) -> bool:
    return tl.clock.shape[0] > 0


def record_op(st, active, kind, scope, addrs, clock0, outcome=None):
    """Identity: the port's traces are disabled."""
    return st


def record_event(st, mask, kind, outcome, *, addr=None, clock=None,
                 cycles=0.0):
    """Identity: the port's traces are disabled."""
    return st


def record_turn(st, clock0):
    """Identity: the port's traces are disabled."""
    return st
