"""KV directory: owner-local updates, rare cross-owner remote lookups
(`repro.workloads.kv_directory`).

A shared directory of lock-protected buckets; bucket b is owned by agent
b % n_agents.  Local turn: owner i round-robins over its own buckets
(acquire the bucket lock at LOCAL scope, read the value through the
store, store value + delta and version + 1, release).  Remote turn: after
its update quota an agent looks up a deterministic non-owned bucket at
REMOTE scope and compares version and value with the bookkept truth.
Self-check: in-run mismatches plus a drained-L2 audit of every bucket.
The workload draws no random numbers; the seed only jitters quotas and
the delta/lookup salt.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ops as O
from repro_torch.core import protocol as P
from repro_torch.core import tables
from repro_torch.core.costmodel import CostParams
from repro_torch.kernels import common
from repro_torch.workloads import harness

I32 = torch.int32
VMAPPABLE = True    # init_state draws on the device: replicas stack


@dataclasses.dataclass(frozen=True)
class Config:
    n_agents: int = 8
    buckets_per_agent: int = 2
    updates_per_agent: int = 6   # seed-jittered by +0/1 in init_state
    lookups_per_agent: int = 2
    task_cost: float = 20.0      # compute cycles charged per update turn
    fifo_cap: int = 16
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    params: CostParams = dataclasses.field(default_factory=CostParams)

    @property
    def n_buckets(self) -> int:
        return self.n_agents * self.buckets_per_agent

    @property
    def bstride(self) -> int:
        return 16   # lock / version / value in one block

    @property
    def n_words(self) -> int:
        return self.n_buckets * self.bstride

    def proto_cfg(self) -> P.ProtoConfig:
        return P.ProtoConfig(n_caches=self.n_agents, n_words=self.n_words,
                             fifo_cap=self.fifo_cap, lr_tbl=self.lr_tbl,
                             pa_tbl=self.pa_tbl, params=self.params)


class KVState(NamedTuple):
    store: P.Store
    upd_done: torch.Tensor     # [n] i32 updates completed per agent
    look_done: torch.Tensor    # [n] i32 lookups completed per agent
    upd_quota: torch.Tensor    # [n] i32 per-agent update target
    ver: torch.Tensor          # [n_buckets] i32 bookkeeping: true version
    val: torch.Tensor          # [n_buckets] i32 bookkeeping: true value
    salt: torch.Tensor         # [] i32 seed-derived delta/lookup salt
    check_fails: torch.Tensor  # [] i32
    rounds: torch.Tensor       # [] i32


def _max_events(cfg: Config) -> int:
    return cfg.n_agents * (cfg.updates_per_agent + 1
                           + cfg.lookups_per_agent) + 4 * cfg.n_agents


def _lanes(cfg: Config, device) -> torch.Tensor:
    return torch.arange(cfg.n_agents, dtype=I32, device=device)


def _can_local(wl, s: KVState):
    return s.upd_done < s.upd_quota


def _can_remote(wl, s: KVState):
    return (s.upd_done >= s.upd_quota) \
        & (s.look_done < wl.cfg.lookups_per_agent)


def _remote_bound(wl, s: KVState):
    left = (s.upd_quota - s.upd_done).to(torch.float32)
    return left.clamp(min=0.0) * wl.cfg.task_cost


def _live(wl, s: KVState):
    work = (s.upd_done < s.upd_quota).any() \
        | (s.look_done < wl.cfg.lookups_per_agent).any()
    return work & (s.rounds < _max_events(wl.cfg))


def _retire(wl, s: KVState, dead, *ops) -> KVState:
    """Elastic retirement (DESIGN.md §10): a dead owner stops owing
    updates and lookups; its buckets keep their bookkept truth, so the
    drained-L2 audit still checks every committed update.  The identity
    when `dead` is all False."""
    return s._replace(
        upd_quota=torch.where(dead, torch.minimum(s.upd_quota, s.upd_done),
                              s.upd_quota),
        look_done=torch.where(
            dead, s.look_done.clamp(min=wl.cfg.lookups_per_agent),
            s.look_done))


def _admit(wl, s: KVState, join, *ops) -> KVState:
    """Elastic (re-)admission: a joining owner owes one more update."""
    return s._replace(
        upd_quota=torch.where(join, s.upd_done + 1, s.upd_quota))


def _delta(lanes, upd_done, salt):
    return (lanes + 1) + torch.remainder(upd_done * 7 + salt, 5)


def _local_turn(wl, s: KVState, mask) -> KVState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    lanes = _lanes(cfg, mask.device)
    # round-robin over own buckets: disjoint across agents by ownership
    b = lanes + torch.remainder(s.upd_done, cfg.buckets_per_agent) \
        * cfg.n_agents
    lockb = b * cfg.bstride
    delta = _delta(lanes, s.upd_done, s.salt)
    newval = s.val[b.long()] + delta

    st = s.store
    st, _ = O.acquire(wl.proto, pc, st, mask, lockb, 0, 1, scope=O.LOCAL)
    st, vcur = O.load(pc, st, mask, lockb + 2)
    st, _ = O.store(pc, st, mask, lockb + 2, newval)
    st, _ = O.store(pc, st, mask, lockb + 1, s.ver[b.long()] + 1)
    st = O.release(wl.proto, pc, st, mask, lockb, 0, scope=O.LOCAL)
    st = harness.charge(st, mask, cfg.task_cost)

    # owner stale-read check: the value read through the store must be
    # the bookkept one
    fails = (mask & (vcur != s.val[b.long()])).sum(dtype=I32)
    tgt = torch.where(mask, b, cfg.n_buckets)
    return KVState(
        store=st,
        upd_done=s.upd_done + mask.to(I32),
        look_done=s.look_done,
        upd_quota=s.upd_quota,
        ver=harness.add_at(s.ver, tgt, torch.ones_like(b)),
        val=harness.add_at(s.val, tgt, delta),
        salt=s.salt,
        check_fails=s.check_fails + fails,
        rounds=s.rounds + mask.sum(dtype=I32))


def _remote_turn(wl, s: KVState, wg) -> KVState:
    # the scheduler's own predicate: a lane that cannot go remote idles
    return P.cond(_can_remote(wl, s)[wg], _lookup,
                  lambda wl, s, wg: s._replace(rounds=s.rounds + 1),
                  wl, s, wg)


def _lookup(wl, s: KVState, wg) -> KVState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    nb = cfg.n_buckets
    t = torch.remainder(wg + 1 + s.look_done[wg] * 5 + s.salt, nb)
    t = torch.where(torch.remainder(t, cfg.n_agents) == wg,
                    torch.remainder(t + 1, nb), t)
    lockt = t * cfg.bstride
    st = s.store
    hot = harness.one_hot(cfg.n_agents, wg, st.l2.device)
    st, old_v = O.acquire(wl.proto, pc, st, hot, lockt, 0, 1,
                          scope=O.REMOTE)
    st, rv = P.load(pc, st, wg, lockt + 1)
    st, vv = P.load(pc, st, wg, lockt + 2)
    st = O.release(wl.proto, pc, st, hot, lockt, 0, scope=O.REMOTE)
    fails = (old_v[wg] != 0).to(I32) + (rv != s.ver[t]).to(I32) \
        + (vv != s.val[t]).to(I32)
    look_done = s.look_done + hot.to(I32)
    return s._replace(store=st, look_done=look_done,
                      check_fails=s.check_fails + fails,
                      rounds=s.rounds + 1)


def build_workload(cfg: Config, proto: P.Protocol) -> harness.Workload:
    return harness.Workload(
        name="kv_directory", cfg=cfg, proto=proto, has_remote=True,
        can_local=_can_local, can_remote=_can_remote,
        local_turn=_local_turn, remote_turn=_remote_turn,
        remote_bound=_remote_bound, live=_live,
        retire=_retire, admit=_admit)


def init_state(wl, seed, device=None) -> KVState:
    cfg = wl.cfg
    dev = common.resolve_device(device)
    lanes = _lanes(cfg, dev)
    seed = torch.tensor(seed, dtype=I32, device=dev)
    n = cfg.n_agents
    zeros = torch.zeros((n,), dtype=I32, device=dev)
    return KVState(
        store=P.make_store(cfg.proto_cfg(), dev),
        upd_done=zeros, look_done=zeros.clone(),
        upd_quota=cfg.updates_per_agent
        + torch.remainder(seed * 17 + lanes * 11, 2),
        ver=torch.zeros((cfg.n_buckets,), dtype=I32, device=dev),
        val=torch.zeros((cfg.n_buckets,), dtype=I32, device=dev),
        salt=torch.remainder(seed * 7919, 97),
        check_fails=torch.zeros((), dtype=I32, device=dev),
        rounds=torch.zeros((), dtype=I32, device=dev))


def self_check(wl, final: KVState) -> dict:
    """In-run mismatches + drained-L2 per-bucket lost-update audit."""
    cfg = wl.cfg
    fails = int(final.check_fails)
    done = bool((final.upd_done >= final.upd_quota).all()) \
        and bool((final.look_done >= cfg.lookups_per_agent).all())
    st = harness.drain_all(cfg.proto_cfg(), final.store)
    l2 = st.l2.cpu().numpy().reshape(-1)
    base = np.arange(cfg.n_buckets) * cfg.bstride
    fails += int((l2[base + 1] != final.ver.cpu().numpy()).sum()) \
        + int((l2[base + 2] != final.val.cpu().numpy()).sum())
    return {"ok": fails == 0 and done, "check_fails": fails,
            "done": done, "events": int(final.rounds)}


def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Bench for one scenario; runs on `device` (default: the GPU)."""
    return harness.make_bench(Config(n_agents=n_agents, **kw),
                              build_workload, init_state, self_check,
                              scenario, seed, proto, device)
