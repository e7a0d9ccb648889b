"""Protocol fault injection as protocol derivation
(`repro.workloads.faults`, the faults that need no crash).

Every workload's self-check reads values through the simulated memory
and compares them with bookkeeping the protocol cannot see.  These
helpers derive deliberately weakened `Protocol` objects, renamed copies
with op-table entries overridden, from any registered protocol; a
workload whose check stays green under them is not checking anything.
Derived protocols stay unregistered.  The crash faults
(`crash_holding_lock`, `crash_dirty`, `lease_never_expires`) need the
elastic engines and are not ported yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import protocol as P


def derive(proto: P.Protocol, suffix: str, **overrides) -> P.Protocol:
    """A renamed copy of `proto` with op-table fields overridden
    (`acquire_rem`, `release_loc_b`, `acquire_rem_b`, ...)."""
    return dataclasses.replace(proto, name=f"{proto.name}+{suffix}",
                               **overrides)


def _skip_promotion_acquire(cfg, st, cid, addr, expect, new):
    """Remote acquire with the promotion machinery ripped out: CAS at L2,
    but no probe or selective flush of remote sharers and no own-cache
    invalidation (paper §4.2 steps 1-3 skipped)."""
    st, old = P._atomic_l2(cfg, st, cid, addr, expect, new, True)
    c = st.counters
    return st._replace(
        counters=c._replace(remote_syncs=c.remote_syncs + 1.0)), old


def no_promotion(proto: P.Protocol) -> P.Protocol:
    """`proto` with remote acquires no longer promoting (the canonical
    injected bug).  The batched remote twins are stripped too, so scoped
    REMOTE dispatch reaches the injected scalar op."""
    return derive(proto, "no_promotion",
                  acquire_rem=_skip_promotion_acquire,
                  acquire_rem_b=None, release_rem_b=None)


def serialize_remote(proto: P.Protocol) -> P.Protocol:
    """`proto` with the batched remote twins stripped: scoped REMOTE
    dispatch takes the scalar serializing ops and the harness never
    co-schedules remote turns.  The same final state on address-disjoint
    schedules (DESIGN.md §9)."""
    return derive(proto, "serial_remote",
                  acquire_rem_b=None, release_rem_b=None)
