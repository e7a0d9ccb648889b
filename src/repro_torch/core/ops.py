"""Scope-parametric synchronization ISA (`repro.core.ops`, DESIGN.md §9).

Four masked multi-agent entry points,

    acquire(proto, cfg, st, active, addrs, expect, new, scope=LOCAL)
    release(proto, cfg, st, active, addrs, vals,        scope=LOCAL)
    load(cfg, st, active, addrs,                        scope=LOCAL)
    store(cfg, st, active, addrs, vals,                 scope=LOCAL)

where `scope` is a static int or a per-agent {LOCAL, REMOTE, GLOBAL}
array.  Dispatch goes into the protocol's per-scope op table.  REMOTE
lanes use the protocol's batched remote twin when it declares one, else
the scalar serializing op, which takes at most one active lane.  Data
ops are scope-invariant: they always route through the issuing agent's
L1.
"""
from __future__ import annotations

import torch

from repro_torch.core import protocol as P
from repro_torch.core import tables
from repro_torch.obs import trace as T

LOCAL = 0    # own-L1 synchronization (atomic_*_wg)
REMOTE = 1   # promoted cross-agent synchronization (atomic_*_rem_cmp)
GLOBAL = 2   # heavyweight everyone-pays synchronization (atomic_*_cmp)

SCOPE_NAMES = {LOCAL: "loc", REMOTE: "rem", GLOBAL: "glob"}


def _check_static(scope: int) -> None:
    if scope not in SCOPE_NAMES:
        raise ValueError(f"unknown scope {scope!r}; "
                         f"valid: {sorted(SCOPE_NAMES)} "
                         f"(ops.LOCAL / ops.REMOTE / ops.GLOBAL)")


def _gate_crashed(proto: P.Protocol, st: P.Store, active):
    """Crash-fault lane kill: once the victim's clock passes the crash
    time its releases stop executing.  No-op for a healthy protocol."""
    if proto.crash_gate is None:
        return active
    victim, at = proto.crash_gate
    lanes = torch.arange(st.counters.cycles.shape[0], device=active.device)
    return active & ~((lanes == victim) & (st.counters.cycles >= at))


def _acquire_rem(proto: P.Protocol, cfg, st, rem, addrs, expect, new):
    """REMOTE acquire lanes: the batched twin, else the scalar op on the
    one active lane."""
    if proto.acquire_rem_b is not None:
        return proto.acquire_rem_b(cfg, st, rem, addrs, expect, new)
    lanes = torch.arange(cfg.n_caches, device=rem.device)
    cid = rem.to(torch.int32).argmax()
    st, old_c = P.cond(
        rem.any(),
        lambda s: proto.acquire_rem(cfg, s, cid, addrs[cid], expect[cid],
                                    new[cid]),
        lambda s: (s, torch.zeros((), dtype=torch.int32, device=rem.device)),
        st)
    return st, torch.where(lanes == cid, old_c, torch.zeros_like(addrs))


def _release_rem(proto: P.Protocol, cfg, st, rem, addrs, vals):
    if proto.release_rem_b is not None:
        return proto.release_rem_b(cfg, st, rem, addrs, vals)
    cid = rem.to(torch.int32).argmax()
    return P.cond(rem.any(),
                  lambda s: proto.release_rem(cfg, s, cid, addrs[cid],
                                              vals[cid]),
                  lambda s: s, st)


def _acquire_outcome(cfg, st, addrs, scope):
    """Trace outcome per lane from the tables before the op (`record_op`
    calls it only when tracing is on): a LOCAL lane promotes iff its PA-TBL holds
    the address, a REMOTE lane probes iff another cache's LR-TBL records
    it (else the probe round NACKs), a GLOBAL lane pays the full
    invalidate."""
    n = cfg.n_caches
    promote = tables.pa_contains(st.pa, addrs)
    # ptrs[c, i]: cache c's LR-TBL record of lane i's address
    ptrs = tables.lr_lookup(st.lr, addrs[None, :].expand(n, n))
    lanes = torch.arange(n, device=addrs.device)
    sharer = ((ptrs >= 0) & (lanes[:, None] != lanes[None, :])).any(dim=0)
    scope_a = P._i32(cfg, st, scope)
    loc = torch.where(promote, T.OC_PROMOTE, T.OC_HIT)
    rem = torch.where(sharer, T.OC_PROBE, T.OC_NACK)
    return torch.where(scope_a == LOCAL, loc,
                       torch.where(scope_a == REMOTE, rem, T.OC_GLOBAL))


def _release_outcome(cfg, st, scope):
    scope_a = P._i32(cfg, st, scope)
    return torch.where(scope_a == LOCAL, T.OC_HIT,
                       torch.where(scope_a == REMOTE, T.OC_PROBE,
                                   T.OC_GLOBAL))


def _l1_state(cfg, st, addrs, plane):
    """The L1 metadata bit of each lane at `addrs` before the op (trace
    classification)."""
    b, o = P._split(cfg, P._i32(cfg, st, addrs))
    return P._pl_get(plane, P._lanes(cfg, st), b, o)


def acquire(proto: P.Protocol, cfg: P.ProtoConfig, st: P.Store, active,
            addrs, expect, new, scope=LOCAL):
    """Scoped acquire: CAS(expect -> new) on addrs[i] at scope[i] for
    every active lane.  Returns (store', old [n])."""
    active = P._bool(cfg, st, active)
    addrs, expect, new = (P._i32(cfg, st, a) for a in (addrs, expect, new))
    st0 = st
    if isinstance(scope, int):
        _check_static(scope)
        if scope == LOCAL:
            st, old = proto.acquire_loc_b(cfg, st, active, addrs, expect,
                                          new)
        elif scope == GLOBAL:
            st, old = proto.acquire_glob_b(cfg, st, active, addrs, expect,
                                           new)
        else:
            st, old = _acquire_rem(proto, cfg, st, active, addrs, expect,
                                   new)
    else:
        scope_a = P._i32(cfg, st, scope)
        rem = active & (scope_a == REMOTE)
        glob = active & (scope_a == GLOBAL)
        st, old_l = proto.acquire_loc_b(cfg, st, active & (scope_a == LOCAL),
                                        addrs, expect, new)
        st, old_g = proto.acquire_glob_b(cfg, st, glob, addrs, expect, new)
        st, old_r = _acquire_rem(proto, cfg, st, rem, addrs, expect, new)
        old = torch.where(rem, old_r, torch.where(glob, old_g, old_l))
    # clock-stamped lease bookkeeping: pure metadata, charges nothing
    st = P.lease_stamp(st, active, addrs)
    st = T.record_op(st, active, T.ACQUIRE, scope, addrs,
                     st0.counters.cycles,
                     lambda: _acquire_outcome(cfg, st0, addrs, scope))
    return st, old


def release(proto: P.Protocol, cfg: P.ProtoConfig, st: P.Store, active,
            addrs, vals, scope=LOCAL):
    """Scoped release: store vals[i] to addrs[i] with release semantics
    at scope[i] for every active lane.  Returns store'."""
    addrs, vals = (P._i32(cfg, st, a) for a in (addrs, vals))
    active = _gate_crashed(proto, st, P._bool(cfg, st, active))
    clock0 = st.counters.cycles
    if isinstance(scope, int):
        _check_static(scope)
        if scope == LOCAL:
            st = proto.release_loc_b(cfg, st, active, addrs, vals)
        elif scope == GLOBAL:
            st = proto.release_glob_b(cfg, st, active, addrs, vals)
        else:
            st = _release_rem(proto, cfg, st, active, addrs, vals)
    else:
        scope_a = P._i32(cfg, st, scope)
        st = proto.release_loc_b(cfg, st, active & (scope_a == LOCAL),
                                 addrs, vals)
        st = proto.release_glob_b(cfg, st, active & (scope_a == GLOBAL),
                                  addrs, vals)
        st = _release_rem(proto, cfg, st, active & (scope_a == REMOTE),
                          addrs, vals)
    st = P.lease_clear(st, active)
    return T.record_op(st, active, T.RELEASE, scope, addrs, clock0,
                       lambda: _release_outcome(cfg, st, scope))


def load(cfg: P.ProtoConfig, st: P.Store, active, addrs, scope=LOCAL):
    """Ordinary scoped read, one per active agent."""
    if isinstance(scope, int):
        _check_static(scope)
    st0 = st
    st, val = P.b_load(cfg, st, active, addrs)
    st = T.record_op(st, active, T.LOAD, scope, addrs, st0.counters.cycles,
                     lambda: torch.where(_l1_state(cfg, st0, addrs,
                                                   st0.wvalid),
                                         T.OC_HIT, T.OC_MISS))
    return st, val


def store(cfg: P.ProtoConfig, st: P.Store, active, addrs, vals,
          scope=LOCAL, *, force_tail=False):
    """Ordinary scoped write, one per active agent."""
    if isinstance(scope, int):
        _check_static(scope)
    st0 = st
    st, pos = P.b_store_word(cfg, st, active, addrs, vals, force_tail)
    # write-combining: a "hit" merges into an already-dirty word
    st = T.record_op(st, active, T.STORE, scope, addrs, st0.counters.cycles,
                     lambda: torch.where(_l1_state(cfg, st0, addrs,
                                                   st0.wdirty),
                                         T.OC_HIT, T.OC_MISS))
    return st, pos
