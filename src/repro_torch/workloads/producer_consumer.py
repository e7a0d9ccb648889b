"""Producer/consumer drains: remote consumers, many local producers
(`repro.workloads.producer_consumer`).

Every producer appends items to its own ring region under LOCAL-scope
synchronization; `n_consumers` consumer agents (lanes [0, n_consumers))
now and then drain a producer of their own partition (producer p belongs
to consumer p % n_consumers) at REMOTE scope.  With one consumer (the
default) the single always-hot drainer is the makespan; with more
(`producer_consumer_mc`) concurrent drains target distinct locks and the
workload declares the remote-batching capability (DESIGN.md §9):
`remote_turn` is the one-hot instance of `remote_turn_b`, and
`remote_addr` names each consumer's next victim lock.

Victim choice and the consumed bookkeeping use ground truth the protocol
cannot see, so the schedule does not depend on a protocol bug; the bug
shows in the checked values.  Self-check: each drain's count word equals
the victim's true produced count at the drain's serial position, the sum
of item values read equals the bookkept sum, and after the run the
drained L2 image holds every item.
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
    n_consumers: int = 1        # lanes [0, n_consumers) drain, rest produce
    max_items: int = 8          # static per-producer quota bound
    min_items: int = 4
    warmup: int = 3             # consumer scratch turns between drains
    scratch_cost: float = 20.0  # compute cycles charged per local turn
    fifo_cap: int = 16
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    params: CostParams = dataclasses.field(default_factory=CostParams)

    @property
    def stride(self) -> int:
        return (2 + self.max_items + 15) // 16 * 16

    @property
    def n_words(self) -> int:
        return self.n_agents * self.stride

    def proto_cfg(self) -> P.ProtoConfig:
        return P.ProtoConfig(n_caches=self.n_agents, n_words=self.n_words,
                             fifo_cap=self.fifo_cap, lr_tbl=self.lr_tbl,
                             pa_tbl=self.pa_tbl, params=self.params)


class PCState(NamedTuple):
    store: P.Store
    produced: torch.Tensor     # [n] i32 bookkeeping: items appended
    consumed: torch.Tensor     # [n] i32 bookkeeping: items drained
    quota: torch.Tensor        # [n] i32 per-producer target (0: consumer)
    credit: torch.Tensor       # [n] i32 consumer scratch turns before drain
    sum_seen: torch.Tensor     # [] i32 sum of item values read
    sum_expect: torch.Tensor   # [] i32 sum of expected values drained
    check_fails: torch.Tensor  # [] i32 in-run consistency violations
    rounds: torch.Tensor       # [] i32


def _item_val(agent, j):
    """Deterministic item payload, what the self-check replays."""
    return (agent + 1) * 131 + 7 * j + 1


def _max_events(cfg: Config) -> int:
    return (cfg.warmup + 3) * cfg.n_agents * cfg.max_items + 4 * cfg.n_agents


def _lanes(cfg: Config, device) -> torch.Tensor:
    return torch.arange(cfg.n_agents, dtype=I32, device=device)


def _is_consumer(cfg: Config, device) -> torch.Tensor:
    return _lanes(cfg, device) < cfg.n_consumers


def _partition(cfg: Config, device) -> torch.Tensor:
    """[n, n] bool: row k marks consumer k's producers."""
    lanes = _lanes(cfg, device)
    return (lanes[None, :] >= cfg.n_consumers) \
        & (torch.remainder(lanes[None, :], cfg.n_consumers)
           == lanes[:, None])


def _own_live(wl, s: PCState):
    """Per consumer lane: does its partition still have undrained quota?"""
    mine = _partition(wl.cfg, s.quota.device) \
        & (s.consumed < s.quota)[None, :]
    return mine.any(dim=1)


def _victims(wl, s: PCState):
    """Per consumer lane: the producer of its partition with the largest
    produced-consumed gap (first index on ties)."""
    gm = torch.where(_partition(wl.cfg, s.quota.device),
                     (s.produced - s.consumed)[None, :], -1)
    return gm.argmax(dim=1).to(I32)


def _can_local(wl, s: PCState):
    cons = _is_consumer(wl.cfg, s.quota.device)
    return torch.where(cons, (s.credit > 0) & _own_live(wl, s),
                       s.produced < s.quota)


def _can_remote(wl, s: PCState):
    return _is_consumer(wl.cfg, s.quota.device) & (s.credit == 0) \
        & _own_live(wl, s)


def _remote_bound(wl, s: PCState):
    return torch.where(_is_consumer(wl.cfg, s.quota.device),
                       s.credit.to(torch.float32) * wl.cfg.scratch_cost,
                       harness.BIG)


def _remote_addr(wl, s: PCState):
    """Next drain's lock address per consumer lane (the harness's
    co-scheduling dedup input)."""
    return _victims(wl, s) * wl.cfg.stride


def _live(wl, s: PCState):
    return (s.consumed < s.quota).any() & (s.rounds < _max_events(wl.cfg))


def _retire(wl, s: PCState, dead, *ops) -> PCState:
    """Elastic retirement (DESIGN.md §10): a dead producer stops owing
    items (quota := produced; its produced items are still drained and
    audited); a dead consumer orphans its partition, whose producers'
    undrained obligations are forgiven too (the drained-L2 audit still
    checks every produced item).  The identity when `dead` is all
    False."""
    cfg = wl.cfg
    cons = _is_consumer(cfg, dead.device)
    lanes = _lanes(cfg, dead.device)
    orphan = ~cons & (dead & cons)[torch.remainder(lanes, cfg.n_consumers)
                                   .long()]
    fold = (dead & ~cons) | orphan
    quota = torch.where(fold, torch.minimum(s.quota, s.produced), s.quota)
    consumed = torch.where(orphan, torch.maximum(s.consumed, quota),
                           s.consumed)
    return s._replace(quota=quota, consumed=consumed)


def _admit(wl, s: PCState, join, *ops) -> PCState:
    """Elastic (re-)admission: a joining producer owes one more item,
    bounded by the ring's capacity."""
    cfg = wl.cfg
    join = join & ~_is_consumer(cfg, join.device)
    return s._replace(quota=torch.where(
        join, (s.produced + 1).clamp(max=cfg.max_items), s.quota))


def _local_turn(wl, s: PCState, mask) -> PCState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    lanes = _lanes(cfg, mask.device)
    is_cons = _is_consumer(cfg, mask.device)
    cons = mask & is_cons
    prod = mask & ~is_cons
    locks = lanes * cfg.stride

    st = s.store
    # producers: append inside their own critical section (LOCAL scope)
    st, _ = O.acquire(wl.proto, pc, st, prod, locks, 0, 1, scope=O.LOCAL)
    slot = s.produced.clamp(0, cfg.max_items - 1)
    st, _ = O.store(pc, st, prod, locks + 2 + slot,
                    _item_val(lanes, s.produced))
    st, _ = O.store(pc, st, prod, locks + 1, s.produced + 1)
    st = O.release(wl.proto, pc, st, prod, locks, 0, scope=O.LOCAL)
    # consumers: scratch write in their own regions
    st, _ = O.store(pc, st, cons,
                    locks + 2 + torch.remainder(s.credit, cfg.max_items),
                    s.credit)
    st = harness.charge(st, mask, cfg.scratch_cost)

    return s._replace(
        store=st,
        produced=s.produced + prod.to(I32),
        credit=s.credit - cons.to(I32),
        rounds=s.rounds + mask.sum(dtype=I32))


def _remote_turn_b(wl, s: PCState, rmask) -> PCState:
    """Masked multi-consumer drain: every masked consumer drains its own
    partition's fullest producer in one set of scoped ops.  Lanes whose
    precondition fails do nothing.  The reference's `lax.scan` over the
    ring's slots is a loop of masked loads here."""
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    n = cfg.n_agents
    do = rmask & _can_remote(wl, s)
    victim = _victims(wl, s)
    lockv = victim * cfg.stride
    start = s.consumed[victim.long()]
    end = s.produced[victim.long()]

    st = s.store
    st, old = O.acquire(wl.proto, pc, st, do, lockv, 0, 1, scope=O.REMOTE)
    st, cnt = O.load(pc, st, do, lockv + 1)
    seen = torch.zeros((n,), dtype=I32, device=do.device)
    for j in range(cfg.max_items):
        st, v = O.load(pc, st, do, lockv + 2 + j)
        seen = seen + torch.where(do & (j >= start) & (j < end), v, 0)
    st = O.release(wl.proto, pc, st, do, lockv, 0, scope=O.REMOTE)

    m = end - start
    # sum of item_val(victim, j) for j in [start, end), closed form
    expect = m * ((victim + 1) * 131 + 1) \
        + torch.div(7 * (start + end - 1) * m, 2, rounding_mode="floor")
    fails = torch.where(do, (cnt != end).to(I32) + (old != 0).to(I32), 0)
    consumed = torch.cat([s.consumed, s.consumed.new_zeros(1)])
    consumed[torch.where(do, victim, n).long()] = end
    return s._replace(
        store=st,
        consumed=consumed[:n],
        credit=torch.where(do, cfg.warmup, s.credit),
        sum_seen=s.sum_seen + torch.where(do, seen, 0).sum(dtype=I32),
        sum_expect=s.sum_expect + torch.where(do, expect, 0).sum(dtype=I32),
        check_fails=s.check_fails + fails.sum(dtype=I32),
        rounds=s.rounds + do.sum(dtype=I32))


def _remote_turn(wl, s: PCState, wg) -> PCState:
    """The serializing turn: the one-hot batched turn."""
    return _remote_turn_b(wl, s, harness.one_hot(wl.cfg.n_agents, wg,
                                                 s.quota.device))


def build_workload(cfg: Config, proto: P.Protocol) -> harness.Workload:
    if not 1 <= cfg.n_consumers < cfg.n_agents:
        raise ValueError(f"n_consumers must be in [1, n_agents); got "
                         f"{cfg.n_consumers} of {cfg.n_agents} agents")
    return harness.Workload(
        name="producer_consumer", cfg=cfg, proto=proto, has_remote=True,
        can_local=_can_local, can_remote=_can_remote,
        local_turn=_local_turn, remote_turn=_remote_turn,
        remote_bound=_remote_bound, live=_live,
        remote_turn_b=_remote_turn_b, remote_addr=_remote_addr,
        retire=_retire, admit=_admit)


def init_state(wl, seed, device=None) -> PCState:
    """Per-producer quotas jittered by the seed, in int32 arithmetic with
    a floor modulus, as the reference computes them."""
    cfg = wl.cfg
    dev = common.resolve_device(device)
    lanes = _lanes(cfg, dev)
    seed = torch.tensor(seed, dtype=I32, device=dev)
    spread = cfg.max_items - cfg.min_items + 1
    quota = cfg.min_items + torch.remainder(seed * 40503 + lanes * 1000003,
                                            spread)
    quota = torch.where(lanes < cfg.n_consumers, 0, quota).to(I32)
    n = cfg.n_agents
    zero = torch.zeros((), dtype=I32, device=dev)
    return PCState(
        store=P.make_store(cfg.proto_cfg(), dev),
        produced=torch.zeros((n,), dtype=I32, device=dev),
        consumed=torch.zeros((n,), dtype=I32, device=dev),
        quota=quota,
        credit=torch.full((n,), cfg.warmup, dtype=I32, device=dev),
        sum_seen=zero, sum_expect=zero.clone(),
        check_fails=zero.clone(), rounds=zero.clone())


def self_check(wl, final: PCState) -> dict:
    """In-run failures + drained-L2 lost-update audit."""
    cfg = wl.cfg
    fails = int(final.check_fails)
    fails += int(int(final.sum_seen) != int(final.sum_expect))
    quota = final.quota.cpu().numpy()
    done = bool(np.all(final.consumed.cpu().numpy() >= quota))
    st = harness.drain_all(cfg.proto_cfg(), final.store)
    l2 = st.l2.cpu().numpy().reshape(-1)
    for i in range(cfg.n_consumers, cfg.n_agents):
        base = i * cfg.stride
        if l2[base + 1] != quota[i]:
            fails += 1
        want = _item_val(i, np.arange(quota[i]))
        fails += int(np.sum(l2[base + 2:base + 2 + quota[i]] != want))
    return {"ok": fails == 0 and done, "check_fails": fails,
            "done": done, "events": int(final.rounds)}


def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Bench for one scenario; runs on `device` (default: the GPU)."""
    return harness.make_bench(Config(n_agents=n_agents, **kw),
                              build_workload, init_state, self_check,
                              scenario, seed, proto, device)
