"""In-engine event tracing: a fixed-capacity ring buffer carried in the
protocol `Store` (`repro.obs.trace`, DESIGN.md §11).

`TraceLog` holds parallel [cap] event columns, per-scope / per-agent
cycle histograms and a per-agent turn-latency histogram:

* every scoped-ISA op (`repro_torch.core.ops`) appends one event per
  active lane: the lane's clock when the op issued, agent, op kind,
  scope, address, the cycles charged to the lane, and a protocol outcome
  (hit / promote / probe / NACK / ...) classified from the table state
  before the op;
* the elastic engines append churn (leave/crash/join) and recovery
  events; every engine buckets each agent's charged cycles per turn.

Ring overflow: `head` counts events and an event's slot is
`position % cap`, so the buffer holds the newest `cap` events and
`dropped = max(head - cap, 0)`.  An append whose active lanes outnumber
`cap` writes only its newest `cap` lanes (the others would be
overwritten in the same append), so no slot is written twice and the
card keeps what the CPU keeps.

Enablement is carried by shape, not by a flag: a disabled log has
zero-capacity columns and every `record_*` returns its input object
unchanged by a Python-level branch, so a run without tracing launches
exactly what it launched before.  `REPRO_TRACE=1` (read once at import,
as `protocol.PACKED` reads `REPRO_NO_PACK`) makes `make_store` allocate
`REPRO_TRACE_CAP` (default 4096) slots; `with_trace` enables tracing on
an existing state in-process.

Every append is plain PyTorch on the state's device, with no host read
and no data-dependent shape (inactive lanes write one spare slot past
the end, which is sliced off), so the same code runs under
`torch.func.vmap` on the replica engines.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.obs import metrics

TRACE = os.environ.get("REPRO_TRACE", "0") == "1"
DEFAULT_CAP = int(os.environ.get("REPRO_TRACE_CAP", "4096"))

# event kinds
ACQUIRE, RELEASE, LOAD, STORE, CHURN, RECOVER = range(6)
KIND_NAMES = {ACQUIRE: "acquire", RELEASE: "release", LOAD: "load",
              STORE: "store", CHURN: "churn", RECOVER: "recover"}

# op outcomes (CHURN events carry the harness LEAVE/CRASH/JOIN code in
# the outcome column instead; decoding dispatches on kind)
OC_NONE, OC_HIT, OC_PROMOTE, OC_PROBE, OC_NACK, OC_GLOBAL, OC_MISS, \
    OC_RECOVER = range(8)
OUTCOME_NAMES = {OC_NONE: "none", OC_HIT: "hit", OC_PROMOTE: "promote",
                 OC_PROBE: "probe", OC_NACK: "nack", OC_GLOBAL: "global",
                 OC_MISS: "miss", OC_RECOVER: "recover"}
CHURN_NAMES = {0: "leave", 1: "crash", 2: "join"}   # harness.KIND_CODES

I32 = torch.int32
F32 = torch.float32


class TraceLog(NamedTuple):
    """Ring-buffer event log and latency histograms.  cap == 0 (the
    `clock` extent) is the disabled state; the histograms' agent axis is
    0 with it."""
    head: torch.Tensor       # [] i32 monotonic event count
    clock: torch.Tensor      # [cap] f32 issuing lane's cycles at issue
    agent: torch.Tensor      # [cap] i32
    kind: torch.Tensor       # [cap] i32 ACQUIRE..RECOVER
    scope: torch.Tensor      # [cap] i32 ops.LOCAL/REMOTE/GLOBAL
    addr: torch.Tensor       # [cap] i32 (-1: no address)
    cycles: torch.Tensor     # [cap] f32 charged to the lane by the op
    outcome: torch.Tensor    # [cap] i32 OC_* (or churn code for CHURN)
    op_hist: torch.Tensor    # [3, n, B] i32 per-scope/agent charged cycles
    turn_hist: torch.Tensor  # [n, B] i32 per-agent per-turn latency


def make(cap: int = 0, n_agents: int = 0, device=None) -> TraceLog:
    """A log of `cap` slots for `n_agents` agents (cap 0: disabled)."""
    b = metrics.N_BUCKETS
    m = n_agents if cap else 0

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=device)

    return TraceLog(head=full((), 0, I32), clock=full((cap,), 0.0, F32),
                    agent=full((cap,), -1, I32), kind=full((cap,), -1, I32),
                    scope=full((cap,), 0, I32), addr=full((cap,), -1, I32),
                    cycles=full((cap,), 0.0, F32),
                    outcome=full((cap,), 0, I32),
                    op_hist=full((3, m, b), 0, I32),
                    turn_hist=full((m, b), 0, I32))


def default_cap() -> int:
    return DEFAULT_CAP if TRACE else 0


def capacity(tl: TraceLog) -> int:
    """Slots of the log (of each replica's, on a stacked state)."""
    return tl.clock.shape[-1]


def enabled(tl: TraceLog) -> bool:
    """Shape-level enablement: safe to branch on in Python."""
    return capacity(tl) > 0


def with_trace(state, cap: int = None):
    """Enable (or resize, or with cap 0 disable) tracing on a Store, a
    workload state or an `ElasticState`, on the state's device.  On a
    stacked replica state every replica gets its own log."""
    cap = DEFAULT_CAP if cap is None else cap
    if hasattr(state, "trace") and hasattr(state, "counters"):   # Store
        cyc = state.counters.cycles
        tl = make(cap, cyc.shape[-1], cyc.device)
        lead = cyc.shape[:-1]
        if lead:
            tl = TraceLog(*(x.expand(lead + x.shape).clone() for x in tl))
        return state._replace(trace=tl)
    if hasattr(state, "store"):
        return state._replace(store=with_trace(state.store, cap))
    return state._replace(s=with_trace(state.s, cap))   # ElasticState


def strip(state):
    """The state with the disabled log: for comparisons across paths
    whose event order legitimately differs."""
    return with_trace(state, 0)


# --------------------------------------------------------------------------
# recording (every helper returns its input when tracing is off)
# --------------------------------------------------------------------------

def _col(v, n: int, dtype, device) -> torch.Tensor:
    """An event field as an [n] column: a tensor broadcast, a Python
    number filled on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).broadcast_to((n,))
    return torch.full((n,), v, dtype=dtype, device=device)


def _append(tl: TraceLog, active, *, clock, agent, kind, scope, addr,
            cycles, outcome) -> TraceLog:
    """Masked ring append: one event per active lane, in lane order.
    Only the newest `cap` active lanes are written; `head` advances by
    every active lane.  The int32 columns are written in one scatter and
    the float32 ones in another (the new columns are views of them)."""
    cap = capacity(tl)
    n = active.shape[0]
    dev = tl.clock.device
    act = active.to(I32)
    rank = torch.cumsum(act, 0, dtype=I32) - 1
    cnt = act.sum(dtype=I32)
    keep = active & (rank >= cnt - cap)
    # lanes not written target the spare row `cap`, sliced off below
    idx = torch.where(keep, (tl.head + rank) % cap, cap).long()

    def put(bufs, vals, dtype):
        vals = torch.stack([_col(v, n, dtype, dev) for v in vals], 1)
        # a fresh tensor: written in place, no input buffer changes
        ext = torch.cat([torch.stack(bufs, 1), vals.new_zeros(1, len(bufs))])
        ext.index_put_((idx,), vals)
        return ext[:-1].unbind(1)

    agent, kind, scope, addr, outcome = put(
        (tl.agent, tl.kind, tl.scope, tl.addr, tl.outcome),
        (agent, kind, scope, addr, outcome), I32)
    clock, cycles = put((tl.clock, tl.cycles), (clock, cycles), F32)
    return tl._replace(head=tl.head + cnt, clock=clock, agent=agent,
                       kind=kind, scope=scope, addr=addr, cycles=cycles,
                       outcome=outcome)


def _bump(hist: torch.Tensor, ix: tuple, add: torch.Tensor) -> torch.Tensor:
    """`hist` with `add` added at the index tuple `ix`, whose entries are
    distinct (one per lane), so a plain scatter of gathered sums is
    exact and needs no sort."""
    return hist.index_put(ix, hist[ix] + add)


def _lanes(cyc: torch.Tensor) -> torch.Tensor:
    return torch.arange(cyc.shape[0], device=cyc.device)


def record_op(st, active, kind, scope, addrs, clock0, outcome):
    """Append one op event per active lane and bucket its charged cycles
    into the per-scope histogram.  `clock0` is the per-lane cycle vector
    captured before the op; the charge is the lane's own delta across
    it.  `outcome` may be a function of no arguments, called only when
    the log is enabled, so an untraced op classifies nothing."""
    tl = st.trace
    if not enabled(tl):
        return st
    if callable(outcome):
        outcome = outcome()
    cyc = st.counters.cycles
    n = cyc.shape[0]
    active = _col(active, n, torch.bool, cyc.device)
    delta = costmodel.charged_since(st.counters, clock0)
    scope_a = _col(scope, n, I32, cyc.device).clamp(0, 2)
    lanes = _lanes(cyc)
    tl = _append(tl, active, clock=clock0, agent=lanes, kind=kind,
                 scope=scope_a, addr=addrs, cycles=delta, outcome=outcome)
    op_hist = _bump(tl.op_hist, (scope_a.long(), lanes,
                                 metrics.bucket_index(delta).long()),
                    active.to(I32))
    return st._replace(trace=tl._replace(op_hist=op_hist))


def record_event(st, mask, kind, outcome, *, addr=None, clock=None,
                 cycles=0.0):
    """Append a scheduler event (churn, recovery) per masked lane."""
    tl = st.trace
    if not enabled(tl):
        return st
    cyc = st.counters.cycles
    tl = _append(tl, _col(mask, cyc.shape[0], torch.bool, cyc.device),
                 clock=cyc if clock is None else clock, agent=_lanes(cyc),
                 kind=kind, scope=0, addr=-1 if addr is None else addr,
                 cycles=cycles, outcome=outcome)
    return st._replace(trace=tl)


def record_turn(st, clock0):
    """Bucket each agent's charged cycles across one scheduler turn or
    trip (a lane whose clock did not move did not act)."""
    tl = st.trace
    if not enabled(tl):
        return st
    delta = costmodel.charged_since(st.counters, clock0)
    turn_hist = _bump(tl.turn_hist, (_lanes(delta),
                                     metrics.bucket_index(delta).long()),
                      (delta > 0).to(I32))
    return st._replace(trace=tl._replace(turn_hist=turn_hist))


# --------------------------------------------------------------------------
# host-side summaries (sweep columns)
# --------------------------------------------------------------------------

def dropped(tl: TraceLog) -> int:
    return max(int(tl.head) - capacity(tl), 0)


def summary(store) -> dict:
    """The sweep's latency columns for one run's final store:
    conservative upper-edge percentiles of the pooled per-turn latency
    histogram, and ring occupancy.  None/0 when tracing is off."""
    tl = store.trace
    if not enabled(tl):
        return {"latency_p50": None, "latency_p95": None,
                "latency_p99": None, "latency_turns": 0,
                "trace_events": 0, "trace_dropped": 0}
    pooled = np.asarray(tl.turn_hist.cpu().numpy(), np.int64).sum(axis=0)
    s = metrics.summarize(pooled)
    return {"latency_p50": s["p50"], "latency_p95": s["p95"],
            "latency_p99": s["p99"], "latency_turns": s["count"],
            "trace_events": int(tl.head), "trace_dropped": dropped(tl)}
