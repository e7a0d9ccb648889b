"""Protocol fault injection as protocol derivation
(`repro.workloads.faults`).

Every workload's self-check reads values through the simulated memory
and compares them with bookkeeping the protocol cannot see.  These
helpers derive deliberately weakened `Protocol` objects, renamed copies
with op-table entries overridden, from any registered protocol; a
workload whose check stays green under them is not checking anything.
Derived protocols stay unregistered.  The crash faults
(`crash_holding_lock`, `crash_dirty`, `lease_never_expires`) pair with a
CRASH event of the elastic engines (`harness.make_elastic`).
"""
from __future__ import annotations

import dataclasses

import torch

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


def crash_holding_lock(proto: P.Protocol, victim: int,
                       at: float) -> P.Protocol:
    """`proto` with agent `victim` dying inside a critical section at
    clock `at`: from then on its releases never execute (`ops.py`'s
    crash gate), while its acquires stay live.  The lock stays held, its
    lease survives for the recovery drain, and the section's data writes
    stay dirty in its L1.  Pair with a CRASH event a little after `at`."""
    return derive(proto, f"crash_lock@{victim}",
                  crash_gate=(int(victim), float(at)))


def crash_dirty(proto: P.Protocol, victim: int, at: float) -> P.Protocol:
    """`proto` with agent `victim` dying at clock `at` between the data
    publish and its visibility plumbing: its local-scope releases after
    `at` store the released value into its L1 but skip the real release
    path (no LR-TBL insert), so no remote probe finds the dirty words.
    Only the recovery drain's unconditional `b_invalidate` reclaims
    them."""
    inner = proto.release_loc_b
    victim, at = int(victim), float(at)

    def rel(cfg, st, active, addrs, vals):
        active = P._bool(cfg, st, active)
        cycles = st.counters.cycles
        lanes = torch.arange(cfg.n_caches, device=cycles.device)
        dying = active & (lanes == victim) & (cycles >= torch.tensor(
            at, dtype=torch.float32, device=cycles.device))
        st = inner(cfg, st, active & ~dying, addrs, vals)
        st, _ = P.b_store_word(cfg, st, dying, addrs, vals)
        return st

    return derive(proto, f"crash_dirty@{victim}", release_loc_b=rel)


def lease_never_expires(proto: P.Protocol) -> P.Protocol:
    """`proto` with the recovery capability stripped: a dead agent's lease
    never expires, so nothing reclaims its lock or dirty words.  The
    elastic run still ends (its guard exits when no live agent can act)
    and the self-check reports the loss."""
    return derive(proto, "lease_never_expires", recover_b=None)
