"""KV serving tier: trace-driven hot-page ownership under Zipf skew
(`repro.workloads.kv_serving`).

Every cache owns a shard of hot KV pages and requests arrive from the
traffic subsystem (`repro_torch.traffic`): Zipf-skewed key popularity,
Poisson or bursty arrivals, a read/write mix.  Each agent serves its
stream in arrival order:

  * local turns: the owner serves a request for one of its own pages:
    wait for the arrival clock, acquire the page lock at LOCAL scope,
    read the value through the store (stale-read check), apply the write
    if the request is one, release, charge `task_cost`.  Ownership
    partitions the pages, so local turns of distinct agents commute;
  * remote turns: a cross-owner lookup of a page at REMOTE scope, its
    version and value compared with the bookkept truth.  Distinct-page
    lookups share a trip (`remote_turn_b`, `remote_addr`; the fused
    engine's `trip_plan(remote_cap=True)` branch).  A lookup whose CAS
    loses retries: the cursor stays;
  * each request's completion latency (completion clock - arrival clock)
    goes into a log2 histogram in the state (`obs.metrics`).

Self-checks: in-run stale reads, offered against completed requests,
and a drained-L2 audit of every page.  The schedule depends only on the
trace and the bookkeeping, never on store reads.

`init_state` draws the trace with the port's `traffic.trace.generate` on
the state's device; its arrival clocks agree with the reference's to a
few ulps, not bit for bit (`traffic.samplers`).  A run held bit for bit
to a JAX run replaces the bench's streams with `driver.from_trace` of
the trace the reference generated (`traffic.trace.load`).
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
from repro_torch.obs import metrics
from repro_torch.traffic import driver as D
from repro_torch.traffic import samplers as S
from repro_torch.traffic import trace as TR
from repro_torch.workloads import harness

I32 = torch.int32
VMAPPABLE = True    # init_state draws on the device: replicas stack


@dataclasses.dataclass(frozen=True)
class Config:
    n_agents: int = 8
    pages_per_agent: int = 2
    traffic: S.TrafficConfig = S.TrafficConfig()
    task_cost: float = 20.0      # serving compute per completed request
    fifo_cap: int = 16
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    params: CostParams = dataclasses.field(default_factory=CostParams)

    @property
    def n_pages(self) -> int:
        return self.n_agents * self.pages_per_agent

    @property
    def bstride(self) -> int:
        return 16   # lock / version / value in one block

    @property
    def n_words(self) -> int:
        return self.n_pages * self.bstride

    def proto_cfg(self) -> P.ProtoConfig:
        return P.ProtoConfig(n_caches=self.n_agents, n_words=self.n_words,
                             fifo_cap=self.fifo_cap, lr_tbl=self.lr_tbl,
                             pa_tbl=self.pa_tbl, params=self.params)


class ServeState(NamedTuple):
    store: P.Store
    streams: D.AgentStreams     # [n, m] request columns (traffic driver)
    cursor: torch.Tensor        # [n] i32 completed requests per agent
    ver: torch.Tensor           # [n_pages] i32 bookkeeping: true version
    val: torch.Tensor           # [n_pages] i32 bookkeeping: true value
    lat_hist: torch.Tensor      # [metrics.N_BUCKETS] i32 request latencies
    check_fails: torch.Tensor   # [] i32
    rounds: torch.Tensor        # [] i32


def _max_events(cfg: Config) -> int:
    # healthy: one turn per request; slack covers fault-injected retries
    return cfg.n_agents * (cfg.traffic.requests_per_agent + 16) \
        + 16 * cfg.n_agents


def _lanes(cfg: Config, device) -> torch.Tensor:
    return torch.arange(cfg.n_agents, dtype=I32, device=device)


def _charge_wait(st: P.Store, mask, streams, cursor) -> P.Store:
    """Idle until the masked lanes' next requests have arrived."""
    wait = D.wait_cycles(streams, cursor, st.counters.cycles)
    c = st.counters
    return st._replace(counters=c._replace(
        cycles=c.cycles + torch.where(mask, wait, 0.0)))


def _note_latency(lat_hist, st: P.Store, mask, streams, cursor):
    """Completion latency (now - arrival) of the masked lanes' requests,
    bucketed with the log2 edges."""
    arr = D.at_cursor(streams, cursor)[0]
    lat = (st.counters.cycles - arr).clamp(min=0.0)
    idx = metrics.bucket_index(torch.where(mask, lat, 0.0))
    return harness.add_at(lat_hist, idx, mask.to(I32))


def _can_local(wl, s: ServeState):
    return D.can_local(s.streams, s.cursor)


def _can_remote(wl, s: ServeState):
    return D.can_remote(s.streams, s.cursor)


def _remote_bound(wl, s: ServeState):
    return D.remote_bound(s.streams, s.cursor, wl.cfg.task_cost)


def _remote_addr(wl, s: ServeState):
    return D.at_cursor(s.streams, s.cursor)[1] * wl.cfg.bstride


def _live(wl, s: ServeState):
    return D.pending(s.streams, s.cursor).any() \
        & (s.rounds < _max_events(wl.cfg))


def _retire(wl, s: ServeState, dead, *ops) -> ServeState:
    """Elastic retirement (DESIGN.md §10): a dead shard's unserved tail is
    forgiven; its pages keep their bookkept truth, so the audit still
    scores every committed write."""
    return s._replace(streams=D.retire(s.streams, s.cursor, dead))


def _admit(wl, s: ServeState, join, *ops) -> ServeState:
    return s._replace(streams=D.admit(s.streams, s.cursor, join))


def _delta(lanes, cursor, page):
    return (lanes + 1) + torch.remainder(cursor * 7 + page, 5)


def _local_turn(wl, s: ServeState, mask) -> ServeState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    lanes = _lanes(cfg, mask.device)
    _, page, kind, _ = D.at_cursor(s.streams, s.cursor)
    lockp = page * cfg.bstride
    delta = _delta(lanes, s.cursor, page)
    newval = s.val[page.long()] + delta

    st = _charge_wait(s.store, mask, s.streams, s.cursor)
    st, old = O.acquire(wl.proto, pc, st, mask, lockp, 0, 1, scope=O.LOCAL)
    # a lost CAS (only when a fault strands a lock) leaves the request
    # in place for a retry turn
    ok = mask & (old == 0)
    st, vcur = O.load(pc, st, ok, lockp + 2)
    wr = ok & (kind == 1)
    st, _ = O.store(pc, st, wr, lockp + 2, newval)
    st, _ = O.store(pc, st, wr, lockp + 1, s.ver[page.long()] + 1)
    st = O.release(wl.proto, pc, st, ok, lockp, 0, scope=O.LOCAL)
    st = harness.charge(st, ok, cfg.task_cost)

    fails = (ok & (vcur != s.val[page.long()])).sum(dtype=I32)
    tgt = torch.where(wr, page, cfg.n_pages)
    return ServeState(
        store=st,
        streams=s.streams,
        cursor=s.cursor + ok.to(I32),
        ver=harness.add_at(s.ver, tgt, 1),
        val=harness.add_at(s.val, tgt, delta),
        lat_hist=_note_latency(s.lat_hist, st, ok, s.streams, s.cursor),
        check_fails=s.check_fails + fails,
        rounds=s.rounds + mask.sum(dtype=I32))


def _remote_turn_b(wl, s: ServeState, rmask) -> ServeState:
    """Masked multi-agent cross-owner lookup: every masked lane resolves
    its request's page in one set of scoped ops.  The harness's dedup
    gives distinct lanes distinct pages, and a lookup changes only its
    own lane's cursor and latency sample."""
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    do = rmask & _can_remote(wl, s)
    page = D.at_cursor(s.streams, s.cursor)[1]
    lockp = page * cfg.bstride

    st = _charge_wait(s.store, do, s.streams, s.cursor)
    st, old = O.acquire(wl.proto, pc, st, do, lockp, 0, 1, scope=O.REMOTE)
    ok = do & (old == 0)      # lost CAS -> retry next turn (cursor stays)
    st, rv = O.load(pc, st, ok, lockp + 1)
    st, vv = O.load(pc, st, ok, lockp + 2)
    st = O.release(wl.proto, pc, st, ok, lockp, 0, scope=O.REMOTE)
    st = harness.charge(st, ok, cfg.task_cost)

    fails = torch.where(ok, (rv != s.ver[page.long()]).to(I32)
                        + (vv != s.val[page.long()]).to(I32), 0)
    return s._replace(
        store=st,
        cursor=s.cursor + ok.to(I32),
        lat_hist=_note_latency(s.lat_hist, st, ok, s.streams, s.cursor),
        check_fails=s.check_fails + fails.sum(dtype=I32),
        rounds=s.rounds + do.sum(dtype=I32))


def _remote_turn(wl, s: ServeState, wg) -> ServeState:
    """The serializing turn: the one-hot batched turn."""
    return _remote_turn_b(wl, s, harness.one_hot(wl.cfg.n_agents, wg,
                                                 s.cursor.device))


def build_workload(cfg: Config, proto: P.Protocol) -> harness.Workload:
    return harness.Workload(
        name="kv_serving", cfg=cfg, proto=proto, has_remote=True,
        can_local=_can_local, can_remote=_can_remote,
        local_turn=_local_turn, remote_turn=_remote_turn,
        remote_bound=_remote_bound, live=_live,
        remote_turn_b=_remote_turn_b, remote_addr=_remote_addr,
        retire=_retire, admit=_admit)


def init_state(wl, seed, device=None) -> ServeState:
    """The initial state on `device` (default: the GPU), its request
    trace drawn from (seed, config) by `traffic.trace.generate` there."""
    cfg = wl.cfg
    dev = common.resolve_device(device)
    tr = TR.generate(cfg.traffic, cfg.n_agents, cfg.n_pages, seed, dev)
    zeros = torch.zeros((cfg.n_pages,), dtype=I32, device=dev)
    return ServeState(
        store=P.make_store(cfg.proto_cfg(), dev),
        streams=D.from_trace(tr, cfg.n_agents,
                             cfg.traffic.requests_per_agent),
        cursor=torch.zeros((cfg.n_agents,), dtype=I32, device=dev),
        ver=zeros, val=zeros.clone(),
        lat_hist=torch.zeros((metrics.N_BUCKETS,), dtype=I32, device=dev),
        check_fails=torch.zeros((), dtype=I32, device=dev),
        rounds=torch.zeros((), dtype=I32, device=dev))


def self_check(wl, final: ServeState) -> dict:
    """In-run stale reads + offered/completed accounting + drained-L2
    per-page audit, plus the request-latency histogram."""
    cfg = wl.cfg
    fails = int(final.check_fails)
    cursor = final.cursor.cpu().numpy()
    quota = final.streams.quota.cpu().numpy()
    done = bool(np.all(cursor >= quota))
    st = harness.drain_all(cfg.proto_cfg(), final.store)
    l2 = st.l2.cpu().numpy().reshape(-1)
    ver = final.ver.cpu().numpy()
    val = final.val.cpu().numpy()
    for p in range(cfg.n_pages):
        base = p * cfg.bstride
        fails += int(l2[base + 1] != ver[p]) + int(l2[base + 2] != val[p])
    hist = final.lat_hist.cpu().numpy().astype(np.int64)
    lat = metrics.summarize(hist)
    offered = cfg.n_agents * cfg.traffic.requests_per_agent
    completed = int(cursor.sum())
    # completed requests carry exactly one latency sample each
    fails += int(lat["count"] != completed)
    return {"ok": fails == 0 and done, "check_fails": fails,
            "done": done, "events": int(final.rounds),
            "offered": offered, "completed": completed,
            "latency_hist": hist.tolist(), "latency": lat}


def with_trace(bench: harness.Bench, tr: TR.RequestTrace) -> harness.Bench:
    """`bench` with its streams regrouped from `tr` (a trace the
    reference generated, loaded by `traffic.trace.load`) in place of its
    own draw: the bitwise replay of a JAX run."""
    cfg = bench.wl.cfg
    dev = bench.state.cursor.device
    tr = TR.RequestTrace(*(c.to(dev) for c in tr))
    streams = D.from_trace(tr, cfg.n_agents, cfg.traffic.requests_per_agent)
    return bench._replace(state=bench.state._replace(streams=streams))


def with_traces(bench: harness.Bench, traces, states=None) -> harness.Bench:
    """`bench` with a stacked state of R = len(traces) replicas for the
    replica engines: replica r's streams regrouped from traces[r] (a
    trace the reference generated, `traffic.trace.load`), the rest of its
    state `bench.state`, or lane r of `states` (a stacked state, e.g.
    `harness.init_many` over seeds) where given; a None trace keeps that
    lane's own streams.  The replay of a JAX `run_*_many` run."""
    if states is None:
        states = harness.stack([bench.state] * len(traces))
    lanes = [harness.lane(states, r) for r in range(len(traces))]
    lanes = [s if tr is None else with_trace(bench._replace(state=s),
                                             tr).state
             for s, tr in zip(lanes, traces)]
    return bench._replace(state=harness.stack(lanes))


def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Bench for one scenario; runs on `device` (default: the GPU)."""
    return harness.make_bench(Config(n_agents=n_agents, **kw),
                              build_workload, init_state, self_check,
                              scenario, seed, proto, device)
