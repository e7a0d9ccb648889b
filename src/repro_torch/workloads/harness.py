"""Workload-agnostic asymmetric-sharing harness (`repro.workloads.harness`,
DESIGN.md §7).

A workload is a `Workload`: a frozen bundle of module-level functions
plus its static config and protocol op table,

  can_local(wl, s, *ops)        -> [n] bool agents with a commuting turn
  can_remote(wl, s, *ops)       -> [n] bool agents whose next turn conflicts
  local_turn(wl, s, mask, *ops) -> s'       one turn per masked agent
  remote_turn(wl, s, wg, *ops)  -> s'       one serializing turn for wg
  remote_bound(wl, s, *ops)     -> [n] f32  lower bound on cycles before
                                            agent i's next remote turn
  live(wl, s, *ops)             -> bool     loop guard

over a NamedTuple state whose first field is the protocol `Store`.
Optional remote-batching capability (DESIGN.md §9):

  remote_turn_b(wl, s, mask, *ops) -> s'    one remote turn per masked
                                            agent, in one set of ops
  remote_addr(wl, s, *ops)  -> [n] i32      the L2 sync address of agent
                                            i's next remote turn

and the optional elastic hooks (DESIGN.md §10), each a bitwise identity
on an all-False mask:

  retire(wl, s, dead, *ops)   -> s'         forgive dying agents' work
  admit(wl, s, joined, *ops)  -> s'         give re-admitted agents work

Engines, each the JAX engine trip for trip: `run_serial` (smallest clock
acts next, ties to the lowest index), `run_batched` (every local turn
that provably precedes every remote turn that could observe it) and
`run_fused` (the batched schedule with the decision made by one
`trip_plan` call and the serial local fallback folded into the same
masked local turn, DESIGN.md §12).  When the workload declares the
remote-batching capability and its protocol `remote_batchable`, a trip
with an empty local batch co-schedules every remote candidate that
precedes every local candidate (clock-lex), minus any lane whose address
collides with an earlier (clock, index) one, in one `remote_turn_b`; an
empty remote batch falls back to one serial turn.  The batched engine
computes that batch in plain torch, the fused engine in `trip_plan`'s
remote branch.  Each `lax.while_loop`/`lax.cond` becomes a host loop or
branch on a scalar read back from the device: one synchronisation per
decision.

The elastic engines `run_serial_elastic` and `run_batched_elastic` run
any workload over a churning alive set: `make_elastic` wraps a bench's
state in an `ElasticState` and prepends a `ChurnSchedule` of LEAVE /
CRASH / JOIN events to its ops.  An event at clock T fires before every
turn at clock >= T in both engines (the batched trip is fenced at the
event horizon), so the two stay bitwise equal under churn; a CRASH is
reclaimed by the protocol's `recover_b` once its lease expires.  With an
empty schedule each is bitwise its plain engine.

The replica engines `run_batched_many` and `run_fused_many` (`runner_many`)
run R replicas of one cell at once over a stacked state, every leaf with
a leading [R] axis (`stack`, `init_many`), as the reference's
`jax.vmap` of `run_batched`/`run_fused` does: the loop runs on the host
while any replica is live, and the turn functions run under
`torch.func.vmap`, so every kernel call is one replica-axis launch and
every branch inside a turn a per-replica select (`protocol.cond`).
Each trip reads the decision flags of all replicas from the device once
and runs each turn form (the masked local turn, the co-scheduled remote
batch, the serial remote turn) only if some replica takes it; each
replica keeps the result of its own form, and a replica that is no
longer live keeps its state, as JAX's batched `while_loop` freezes it.
A traced replica (a solo state given `obs.trace.with_trace`, then
stacked) buckets each of its turns into its own trace.
Each lane ends bitwise equal to the solo run of its seed, `rounds`
included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import costmodel
from repro_torch.core import protocol as P
from repro_torch.kernels import common, fused_turn
from repro_torch.obs import trace as T

BIG = 3e38      # float32(3e38): above every real clock

SCENARIO_PROTOCOLS = P.Registry("scenario")


def register_scenario(name: str, proto_name: str) -> None:
    """Map a scenario name onto a registered protocol name."""
    if proto_name not in P.PROTOCOLS:
        raise KeyError(f"cannot register scenario {name!r}: unknown "
                       f"protocol {proto_name!r}; registered protocols: "
                       f"{sorted(P.PROTOCOLS)}")
    SCENARIO_PROTOCOLS[name] = proto_name


register_scenario("baseline", "global")
register_scenario("scope_only", "local")  # NOT remote-safe: staleness demo
register_scenario("steal_only", "global")
register_scenario("rsp", "rsp")
register_scenario("srsp", "srsp")


def resolve_proto(scenario: str, proto: P.Protocol = None) -> P.Protocol:
    if proto is not None:
        return proto
    return P.get_protocol(SCENARIO_PROTOCOLS[scenario])


class Bench(NamedTuple):
    """Uniform handle a caller drives a workload through."""
    wl: "Workload"
    state: Any
    ops: tuple
    check: Callable     # (final_state) -> dict(ok, check_fails, ...)


def make_bench(cfg, build_workload, init_state, self_check, scenario,
               seed=0, proto: P.Protocol = None, device=None) -> Bench:
    wl = build_workload(cfg, resolve_proto(scenario, proto))
    return Bench(wl, init_state(wl, seed, device), (),
                 lambda final: self_check(wl, final))


@dataclasses.dataclass(frozen=True)
class Workload:
    """Declarative workload spec bound to a config and a protocol."""
    name: str
    cfg: Any
    proto: P.Protocol
    has_remote: bool            # False: every turn commutes
    can_local: Callable
    can_remote: Callable
    local_turn: Callable
    remote_turn: Callable
    remote_bound: Callable
    live: Callable
    remote_turn_b: Callable = None   # masked multi-agent remote turn
    remote_addr: Callable = None     # [n] i32 next-remote target address
    retire: Callable = None          # masked retirement bookkeeping
    admit: Callable = None           # masked (re-)admission bookkeeping

    @property
    def remote_cap(self) -> bool:
        """Remote turns of distinct addresses may share a trip."""
        return self.remote_turn_b is not None \
            and self.remote_addr is not None and self.proto.remote_batchable


def one_hot(n: int, wg, device) -> torch.Tensor:
    return torch.arange(n, device=device) == torch.as_tensor(wg,
                                                             device=device)


def add_at(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`x.at[idx].add(vals, mode="drop")` for indices in [0, len(x)]:
    repeated indices accumulate, index len(x) drops."""
    ext = torch.cat([x, x.new_zeros(1)])
    ext.index_put_((idx.long(),), torch.as_tensor(vals, dtype=x.dtype,
                                                  device=x.device)
                   .expand(idx.shape), accumulate=True)
    return ext[:-1]


def charge(st: P.Store, mask, cycles) -> P.Store:
    """Add per-agent compute cycles outside the protocol ops."""
    c = st.counters
    return st._replace(counters=c._replace(
        cycles=c.cycles + torch.where(mask, float(cycles), 0.0)))


def _note_turn(s0, s1):
    """Bucket each agent's charged cycles across one scheduler turn or
    trip into the trace's per-turn latency histogram (DESIGN.md §11);
    `record_turn` leaves an untraced store as it is."""
    return s1._replace(store=T.record_turn(s1.store,
                                           s0.store.counters.cycles))


def _serial_turn(wl: Workload, s, wg, can_l, ops):
    if bool(can_l[wg]):
        n = can_l.shape[0]
        return wl.local_turn(wl, s, one_hot(n, wg, can_l.device), *ops)
    return wl.remote_turn(wl, s, wg, *ops)


def run_serial(wl: Workload, state, *ops):
    """Event-driven reference scheduler: smallest clock acts next."""
    s = state
    while bool(wl.live(wl, s, *ops)):
        can_l = wl.can_local(wl, s, *ops)
        can_r = wl.can_remote(wl, s, *ops)
        clocks = torch.where(can_l | can_r, s.store.counters.cycles, BIG)
        wg = clocks.argmin().to(torch.int32)
        s = _note_turn(s, _serial_turn(wl, s, wg, can_l, ops))
    return s


def _lex_before(clocks, wgs, mask):
    """Lanes whose (clock, index) precedes the first (clock, index) of
    `mask`'s lanes: clock < min, or clock == min and index < argmin."""
    mclk = torch.where(mask, clocks, BIG)
    m = mclk.min()
    j = mclk.argmin().to(torch.int32)
    return (clocks < m) | ((clocks == m) & (wgs < j))


def _fenced(mask, clocks, horizon):
    """`mask` without the lanes at or past the event horizon (None: no
    fence)."""
    return mask if horizon is None else mask & (clocks < horizon)


def _remote_batch(wl: Workload, s, can_l, can_r, clocks, wgs, horizon,
                  ops):
    """The co-scheduled remote batch of a trip whose local batch is empty:
    remote candidates before every local candidate and the horizon, minus
    any lane whose address collides with an earlier (clock, index)
    candidate's."""
    r0 = _fenced(can_r & _lex_before(clocks, wgs, can_l), clocks, horizon)
    raddr = wl.remote_addr(wl, s, *ops)
    collide = r0[:, None] & r0[None, :] & (raddr[:, None] == raddr[None, :])
    earlier = (clocks[None, :] < clocks[:, None]) \
        | ((clocks[None, :] == clocks[:, None])
           & (wgs[None, :] < wgs[:, None]))
    return r0 & ~(collide & earlier).any(dim=1)


def _batched_trip(wl: Workload, s, can_l, can_r, horizon, ops):
    """One `run_batched` trip: the local batch if nonempty, else the
    co-scheduled remote batch if the capability allows one and it is
    nonempty, else one serial turn.  `horizon` (a 0-d float32 tensor) is
    the elastic engines' event fence: no batched turn at a clock >= it
    runs this trip; the serial fallback is not fenced.  The plain engines
    pass None."""
    clocks_all = s.store.counters.cycles
    if not wl.has_remote:
        return wl.local_turn(wl, s, _fenced(can_l, clocks_all, horizon),
                             *ops)
    n = clocks_all.shape[0]
    wgs = torch.arange(n, dtype=torch.int32, device=clocks_all.device)
    wg_min = torch.where(can_l | can_r, clocks_all, BIG).argmin() \
        .to(torch.int32)
    fence = torch.where(can_l, clocks_all + wl.remote_bound(wl, s, *ops),
                        BIG).min()
    batch = _fenced(can_l & _lex_before(clocks_all, wgs, can_r)
                    & (clocks_all <= fence), clocks_all, horizon)
    if bool(batch.any()):
        return wl.local_turn(wl, s, batch, *ops)
    if wl.remote_cap:
        rbatch = _remote_batch(wl, s, can_l, can_r, clocks_all, wgs,
                               horizon, ops)
        if bool(rbatch.any()):
            return wl.remote_turn_b(wl, s, rbatch, *ops)
    return _serial_turn(wl, s, wg_min, can_l, ops)


def run_batched(wl: Workload, state, *ops):
    """Vectorized scheduler: every provably-commuting local turn per trip
    (DESIGN.md §4); otherwise one serial turn."""
    s = state
    while bool(wl.live(wl, s, *ops)):
        can_l = wl.can_local(wl, s, *ops)
        can_r = wl.can_remote(wl, s, *ops) if wl.has_remote else None
        s = _note_turn(s, _batched_trip(wl, s, can_l, can_r, None, ops))
    return s


def _fused_trip(wl: Workload, s, can_l, can_r, ops):
    """`_batched_trip` with the decision in one `trip_plan` call: lmask is
    the batch, or the one-hot serial-local fallback; when it is empty the
    trip is the co-scheduled remote batch rmask (remote-batching
    capability only) or, when that is empty too, the first-argmin agent's
    remote turn."""
    if not wl.has_remote:
        return _batched_trip(wl, s, can_l, can_r, None, ops)
    cap = wl.remote_cap
    plan = fused_turn.trip_plan(s.store.counters.cycles, can_l, can_r,
                                wl.remote_bound(wl, s, *ops),
                                wl.remote_addr(wl, s, *ops) if cap else None,
                                None, remote_cap=cap)
    if bool(plan.lmask.any()):
        return wl.local_turn(wl, s, plan.lmask, *ops)
    if cap and bool(plan.rmask.any()):
        return wl.remote_turn_b(wl, s, plan.rmask, *ops)
    return wl.remote_turn(wl, s, plan.wg, *ops)


def run_fused(wl: Workload, state, *ops):
    """`run_batched` with the fused trip: the same schedule and final
    state, one `trip_plan` launch and at most one masked local turn per
    trip."""
    s = state
    while bool(wl.live(wl, s, *ops)):
        can_l = wl.can_local(wl, s, *ops)
        can_r = wl.can_remote(wl, s, *ops) if wl.has_remote else None
        s = _note_turn(s, _fused_trip(wl, s, can_l, can_r, ops))
    return s


# --------------------------------------------------------------------------
# The replica axis: R replicas of one cell in one run (the reference's
# `jax.vmap` of an engine over a stacked state)
# --------------------------------------------------------------------------

def stack(states) -> Any:
    """One state whose every leaf stacks the given states' leaves on a
    new leading [R] axis."""
    return P.tree_map(lambda *x: torch.stack(x), *states)


def lane(states, k: int) -> Any:
    """Replica k of a stacked state."""
    return P.tree_map(lambda x: x[k], states)


def init_many(init_state: Callable, wl: Workload, seeds, device=None):
    """R replicas of a workload whose `init_state` draws on the device
    (the modules with `VMAPPABLE`), stacked over `seeds`: the port's
    twin of `jax.vmap(lambda s: mod.init_state(wl, s))(seeds)`."""
    return stack([init_state(wl, int(seed), device) for seed in seeds])


def _rows(pred, yes, no):
    """Per-replica select of two stacked states by pred [R]."""
    return P.tree_map(
        lambda a, b: torch.where(
            pred.reshape(pred.shape + (1,) * (a.ndim - 1)), a, b), yes, no)


def _run_many(wl: Workload, states, ops, plan_fn, engine):
    """The replica loop.  A trip computes every replica's readiness and
    plan under vmap (`plan_fn`: the `trip_plan` contract), then reads
    from the device once whether any replica is live and which of the
    three turn forms some live replica takes (a nonempty local mask;
    else, with the remote-batching capability, a nonempty remote batch;
    else the serial remote turn of the plan's wg), with the largest
    remote batch.  A form runs, under vmap over every replica, only if
    some replica takes it; each replica keeps its own form's result.
    A remote form's lane scans (`protocol.lane_bound`) take at most the
    form's largest mask; a replica whose scans needed more raises at the
    next read.  Each pass adds one to `engine.passes`: a run of t trips makes t + 1
    passes (the last finds no replica live)."""
    vmap = torch.func.vmap
    cap = wl.remote_cap

    def decide(s):
        can_l = wl.can_local(wl, s, *ops)
        live = torch.as_tensor(wl.live(wl, s, *ops), device=can_l.device)
        if not wl.has_remote:
            # nothing ever conflicts: every ready agent acts each trip
            return live, can_l, torch.zeros_like(can_l), \
                torch.zeros((), dtype=torch.int32, device=can_l.device)
        can_r = wl.can_remote(wl, s, *ops)
        plan = plan_fn(s.store.counters.cycles, can_l, can_r,
                       wl.remote_bound(wl, s, *ops),
                       wl.remote_addr(wl, s, *ops) if cap else None, None,
                       remote_cap=cap)
        return live, plan.lmask, plan.rmask, plan.wg

    def bounded(turn):
        # a remote form's ops act for its masked agents only: its lane
        # scans take at most `lanes` lanes (the largest batch, one when
        # serial), and each replica says whether its scans needed more
        def run(s, arg, lanes):
            with P.lane_bound(lanes) as over:
                out = turn(wl, s, arg, *ops)
            return out, torch.stack(over).any() if over \
                else torch.zeros((), dtype=torch.bool, device=arg.device)
        return vmap(run, in_dims=(0, 0, None))

    local = vmap(lambda s, m: wl.local_turn(wl, s, m, *ops))
    forms = [lambda s, m, lanes: (local(s, m), None)]
    if wl.has_remote:
        forms += [bounded(wl.remote_turn_b) if cap else None,
                  bounded(wl.remote_turn)]
    decide = vmap(decide)
    note = vmap(_note_turn)
    traced = T.enabled(states.store.trace)
    s = states
    # whether a replica of the last trip took a remote form that needed
    # more lanes than its bound: read with this trip's flags
    over = torch.zeros((), dtype=torch.bool,
                       device=s.store.counters.cycles.device)
    while True:
        engine.passes += 1
        live, lmask, rmask, wg = decide(s)
        if wl.has_remote:
            go_l = live & lmask.any(dim=1)
            go_b = live & ~go_l & rmask.any(dim=1) if cap \
                else torch.zeros_like(live)
            go_r = live & ~go_l & ~go_b
        else:
            go_l, go_b, go_r = live, torch.zeros_like(live), \
                torch.zeros_like(live)
        # the one host read: which forms run, the largest remote batch,
        # and whether the last trip's lane scans left lanes out
        takes = torch.cat([
            torch.stack([live, go_l, go_b, go_r]).any(dim=1).to(torch.int64),
            torch.where(go_b, rmask.sum(dim=1), 0).amax()[None],
            over[None].to(torch.int64)]).tolist()
        if takes[5]:
            raise RuntimeError(
                "a remote turn scanned more lanes than its form's mask "
                "holds: protocol.lane_bound left some out")
        if not takes[0]:
            return s
        out = s
        over = torch.zeros_like(over)
        for take, go, form, arg, lanes in zip(
                takes[1:4], (go_l, go_b, go_r), forms, (lmask, rmask, wg),
                (None, takes[4], 1)):
            if take:
                res, bad = form(s, arg, lanes)
                out = _rows(go, res, out)
                if bad is not None:
                    over = over | (go & bad).any()
        # each live replica's turn into its own histogram; a replica no
        # longer live kept its state, so its clocks did not move
        s = note(s, out) if traced else out


def run_batched_many(wl: Workload, states, *ops):
    """`run_batched` over a leading replica axis of `states` (the
    reference's `jax.vmap` of it): every lane is its seed's solo run.
    The trip's decision is the plain `trip_plan_ref` under vmap."""
    return _run_many(wl, states, ops,
                     lambda *a, remote_cap: fused_turn.trip_plan_ref(*a),
                     run_batched_many)


def run_fused_many(wl: Workload, states, *ops):
    """`run_fused` over a leading replica axis of `states`: one
    `trip_plan` launch a trip decides for every replica."""
    return _run_many(wl, states, ops, fused_turn.trip_plan, run_fused_many)


run_batched_many.passes = 0
run_fused_many.passes = 0


# --------------------------------------------------------------------------
# Elastic alive-set scheduling (DESIGN.md §10)
#
# LEAVE retires an agent (the workload's `retire` hook forgives its
# remaining work) and reclaims its cache at once.  CRASH retires it too,
# but the directory reclaims only once the agent's lease expires, at
# T + lease, through `Protocol.recover_b`; with `recover_b` None
# (`faults.lease_never_expires`) nothing is ever reclaimed.  JOIN
# re-admits the agent (`admit` may give it work).
# --------------------------------------------------------------------------

LEAVE, CRASH, JOIN = 0, 1, 2
KIND_CODES = {"leave": LEAVE, "crash": CRASH, "join": JOIN}


class ChurnSchedule(NamedTuple):
    """Churn events, carried as the first scheduler op."""
    clock: torch.Tensor   # [k] f32 fire time (BIG: padding, never fires)
    agent: torch.Tensor   # [k] i32 subject agent
    kind: torch.Tensor    # [k] i32 LEAVE / CRASH / JOIN
    lease: torch.Tensor   # [] f32 lease a CRASH waits out (cycles)


class ElasticState(NamedTuple):
    """Workload state plus the alive-set bookkeeping."""
    s: Any                     # workload state (first field is the Store)
    alive: torch.Tensor        # [n] bool scheduling-eligible agents
    recover_at: torch.Tensor   # [n] f32 pending reclaim clock (BIG: none)
    fired: torch.Tensor        # [k] bool events already replayed


def make_churn(events=(), lease=0.0, device=None) -> ChurnSchedule:
    """A schedule on `device` (default: the GPU) from (clock, agent, kind)
    triples, kind a `KIND_CODES` name or code.  It always has at least
    one (inert) row, so its reductions never see an empty axis."""
    dev = common.resolve_device(device)
    k = max(len(events), 1)
    clock = [float(BIG)] * k
    agent = [0] * k
    kind = [LEAVE] * k
    for j, (t, a, kd) in enumerate(events):
        clock[j] = float(t)
        agent[j] = int(a)
        kind[j] = KIND_CODES[kd] if isinstance(kd, str) else int(kd)
    return ChurnSchedule(
        clock=torch.tensor(clock, dtype=torch.float32, device=dev),
        agent=torch.tensor(agent, dtype=torch.int32, device=dev),
        kind=torch.tensor(kind, dtype=torch.int32, device=dev),
        lease=torch.tensor(float(lease), dtype=torch.float32, device=dev))


def make_elastic(bench: Bench, events=(), lease=0.0) -> Bench:
    """`bench` for the elastic engines: an `ElasticState` state on the
    bench's device, the schedule prepended to its ops, its check applied
    to the inner state."""
    cycles = bench.state.store.counters.cycles
    sched = make_churn(events, lease, cycles.device)
    n = cycles.shape[0]
    es = ElasticState(
        s=bench.state,
        alive=torch.ones((n,), dtype=torch.bool, device=cycles.device),
        recover_at=torch.full((n,), BIG, dtype=torch.float32,
                              device=cycles.device),
        fired=sched.clock >= BIG)
    return Bench(bench.wl, es, (sched,) + bench.ops,
                 lambda final: bench.check(final.s))


def _elastic_ready(wl: Workload, es: ElasticState, ops):
    """Readiness masked by the alive set (can_r all False for workloads
    without remote turns)."""
    can_l = wl.can_local(wl, es.s, *ops) & es.alive
    if wl.has_remote:
        can_r = wl.can_remote(wl, es.s, *ops) & es.alive
    else:
        can_r = torch.zeros_like(es.alive)
    return can_l, can_r


def _event_horizon(sched: ChurnSchedule, es: ElasticState) -> torch.Tensor:
    """Earliest unfired event or pending reclaim, 0-d f32 (BIG: none)."""
    ec = torch.where(es.fired, BIG, sched.clock).min()
    return torch.minimum(ec, es.recover_at.min())


def _fire_events(wl: Workload, sched: ChurnSchedule, es: ElasticState,
                 mcc, ops) -> ElasticState:
    """Replay every event and reclaim due at clock <= `mcc` (the next
    turn's clock), in schedule order.  Like the reference's scan, every
    row runs, a row that is not due with all-False masks (the hooks'
    identity); `recover_b` runs only when some reclaim is due, and a due
    reclaim is cleared even without `recover_b`."""
    s, alive, recover_at, fired = es
    lanes = torch.arange(alive.shape[0], dtype=torch.int32,
                         device=alive.device)
    due = ~fired & (sched.clock <= mcc)
    for j in range(sched.clock.shape[0]):
        hot = (lanes == sched.agent[j]) & due[j]
        kind = sched.kind[j]
        dead = hot & (kind != JOIN)
        join = hot & (kind == JOIN)
        if wl.retire is not None:
            s = wl.retire(wl, s, dead, *ops)
        if wl.admit is not None:
            s = wl.admit(wl, s, join, *ops)
        s = s._replace(store=T.record_event(s.store, hot, T.CHURN, kind,
                                            clock=sched.clock[j]))
        alive = (alive & ~dead) | join
        due_at = torch.where(kind == CRASH, sched.clock[j] + sched.lease,
                             sched.clock[j])
        recover_at = torch.where(dead, due_at, recover_at)
    fired = fired | due
    reclaim = (recover_at <= mcc) & (recover_at < BIG)
    if wl.proto.recover_b is not None and bool(reclaim.any()):
        s = s._replace(store=wl.proto.recover_b(wl.cfg.proto_cfg(),
                                                s.store, reclaim))
    recover_at = torch.where(reclaim, BIG, recover_at)
    return ElasticState(s, alive, recover_at, fired)


def _elastic_trip(wl: Workload, sched: ChurnSchedule, es: ElasticState,
                  ops, batched: bool):
    """One pass of an elastic engine's loop: (go, es').  go is False when
    no work remains or no progress is possible (no live agent can act and
    no event or reclaim is pending: a crashed agent's leftovers that
    nobody may take end the run instead of wedging it).  Otherwise the
    pass fires the events and reclaims due at or before the next turn's
    clock mcc (mcc is BIG when no live agent can act), or runs one turn
    (serial) or one trip fenced at the event horizon (batched).  The loop
    decision is one host read."""
    can_l, can_r = _elastic_ready(wl, es, ops)
    ready = can_l | can_r
    clocks = torch.where(ready, es.s.store.counters.cycles, BIG)
    mcc = clocks.min()
    ec = _event_horizon(sched, es)
    pending = ec < BIG
    go = torch.as_tensor(wl.live(wl, es.s, *ops)) & (ready.any() | pending)
    go, fire = torch.stack([go, (ec <= mcc) & pending]).tolist()
    if not go:
        return False, es
    if fire:
        return True, _fire_events(wl, sched, es, mcc, ops)
    if batched:
        s = _batched_trip(wl, es.s, can_l, can_r if wl.has_remote else None,
                          ec, ops)
    else:
        s = _serial_turn(wl, es.s, clocks.argmin().to(torch.int32), can_l,
                         ops)
    return True, es._replace(s=_note_turn(es.s, s))


def run_serial_elastic(wl: Workload, es: ElasticState,
                       sched: ChurnSchedule, *ops):
    """`run_serial` over a churning alive set.  With an empty schedule
    its turns are bitwise `run_serial`'s."""
    go = True
    while go:
        go, es = _elastic_trip(wl, sched, es, ops, batched=False)
    return es


def run_batched_elastic(wl: Workload, es: ElasticState,
                        sched: ChurnSchedule, *ops):
    """`run_batched` over a churning alive set: each trip is fenced at the
    event horizon, so no turn at a clock >= the next event runs before
    the event fires.  With an empty schedule its trips are bitwise
    `run_batched`'s."""
    go = True
    while go:
        go, es = _elastic_trip(wl, sched, es, ops, batched=True)
    return es


ENGINES = P.Registry("engine")


def register_engine(name: str, fn: Callable) -> Callable:
    ENGINES[name] = fn
    return fn


def engines() -> tuple:
    return tuple(sorted(ENGINES))


register_engine("serial", run_serial)
register_engine("batched", run_batched)
register_engine("fused", run_fused)
register_engine("serial_elastic", run_serial_elastic)
register_engine("batched_elastic", run_batched_elastic)


# the replica twins of the engines the sweep packs replicas through
ENGINES_MANY = P.Registry("vmapped engine")
ENGINES_MANY["batched"] = run_batched_many
ENGINES_MANY["fused"] = run_fused_many


def runner(engine: str):
    """Registered scheduler by name; unknown names raise with the list."""
    return ENGINES[engine]


def runner_many(engine: str):
    """Replica twin of an engine by name (the sweep's replica packing)."""
    return ENGINES_MANY[engine]


def drain_all(cfg: P.ProtoConfig, st: P.Store) -> P.Store:
    """Flush every cache completely (post-run memory audits)."""
    st, _ = P.b_drain(cfg, st, P.DRAIN_ALL, True)
    return st


def counters_dict(st: P.Store) -> dict:
    """The standard counter summary every workload reports."""
    c = st.counters
    return {
        "makespan": float(costmodel.makespan(c)),
        "l2_accesses": float(c.l2_accesses),
        "wb_blocks": float(c.wb_blocks),
        "inv_full": float(c.inv_full),
        "probes": float(c.probes),
        "promotions": float(c.promotions),
        "local_syncs": float(c.local_syncs),
        "remote_syncs": float(c.remote_syncs),
        "global_syncs": float(c.global_syncs),
        "steals": float(c.steals),
        "l1_hits": float(c.l1_hits),
        "l1_misses": float(c.l1_misses),
        "recoveries": float(c.recoveries),
    }
