"""Work-stealing load balancing, the paper's evaluation harness (§5.1)
(`repro.workloads.worksteal`).

A lock-free-style work-stealing runtime (Cederman & Tsigas [10]): each
work-group owns a task queue; owners pop from the tail with local-scope
synchronization and thieves steal from the head with remote-scope (or
global-scope) synchronization.  Queue words (lock, head, tail, task
entries) live in the protocol's simulated memory, so a protocol bug
shows as stale task ids or lost or duplicated chunks (`proc_errors`).

Five scenarios (paper §5.1):
    baseline     no stealing, global-scope sync on every queue op
    scope_only   no stealing, local-scope sync (cheap but imbalanced)
    steal_only   stealing with global-scope sync everywhere
    rsp          local sync for owners; flush-all/inv-all RSP promotion
                 for steals
    srsp         local sync for owners; selective promotion

Tasks are chunks of graph nodes; a chunk's work is task_base + per_edge *
chunk_edges cycles, and its outputs are written through the simulated
memory, so flush traffic is real.  Pops of distinct owners commute
(`local_turn`), steals serialize (`remote_turn`; no batched twin, so the
fused engine plans with `remote_cap=False`), and `rem`, the base work
still queued per owner, is the batched engine's fence.

Where the reference uses JAX control flow: the steal's `lax.cond` is a
host branch, its `lax.scan` of chunk-output writes a loop of
`P.store_word` calls, and the enqueue's sFIFO `touch` scan a loop over
blocks of the all-cache `sfifo.push`.  Graphs, chunk plans and the
queue enqueue order are host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ops as O
from repro_torch.core import protocol as P
from repro_torch.core import costmodel, prng, sfifo, tables
from repro_torch.data.graphs import CSRGraph, collab_like
from repro_torch.kernels import common
from repro_torch.workloads import harness

QMETA = 16  # words reserved at the head of each queue (lock/head/tail block)

VMAPPABLE = False   # the enqueue chunks on the host (numpy)

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class WSConfig:
    n_wgs: int = 64
    chunk_cap: int = 32          # nodes per task chunk
    n_chunks_max: int = 512      # static bound on chunks per iteration
    fifo_cap: int = 16
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    cold_factor: float = 1.0     # refill penalty scale after an invalidation
    params: costmodel.CostParams = dataclasses.field(
        default_factory=costmodel.CostParams)

    @property
    def qcap(self) -> int:
        return self.n_chunks_max  # worst-case skew bound

    @property
    def qstride(self) -> int:
        s = QMETA + self.qcap
        return (s + 15) // 16 * 16

    @property
    def data_base(self) -> int:
        return self.n_wgs * self.qstride

    @property
    def n_words(self) -> int:
        w = self.data_base + self.n_chunks_max * self.chunk_cap
        return (w + 15) // 16 * 16

    def proto_cfg(self) -> P.ProtoConfig:
        return P.ProtoConfig(n_caches=self.n_wgs, n_words=self.n_words,
                             fifo_cap=self.fifo_cap, lr_tbl=self.lr_tbl,
                             pa_tbl=self.pa_tbl, params=self.params)


# name -> (protocol, steal?)
SCENARIOS = P.Registry("worksteal scenario")
SCENARIOS.update({
    "baseline":   ("global", False),
    "scope_only": ("local", False),
    "steal_only": ("global", True),
    "rsp":        ("rsp", True),
    "srsp":       ("srsp", True),
})


class SimState(NamedTuple):
    store: P.Store
    qsize: torch.Tensor      # [n_wgs] i32 bookkeeping occupancy
    processed: torch.Tensor  # [n_chunks_max] i32, from values read THROUGH the store
    last_inv: torch.Tensor   # [n_wgs] f32 inv_per_cache at the last chunk
    rounds: torch.Tensor     # [] i32
    rem: torch.Tensor        # [n_wgs] f32 base work still queued: a lower
                             # bound on cycles before this wg can steal


ENGINES = ("batched", "serial", "fused")


# --------------------------------------------------------------------------
# workload spec functions
# --------------------------------------------------------------------------

def _max_events(ws: WSConfig) -> int:
    return 2 * ws.n_chunks_max + 4 * ws.n_wgs


def _can_pop(wl, s: SimState, chunk_count, chunk_edges):
    return s.qsize > 0


def _can_steal(wl, s: SimState, chunk_count, chunk_edges):
    if not wl.has_remote:
        return torch.zeros_like(s.qsize, dtype=torch.bool)
    return (s.qsize == 0) & (s.qsize.sum() > 0)


def _steal_bound(wl, s: SimState, chunk_count, chunk_edges):
    return s.rem


def _live(wl, s: SimState, chunk_count, chunk_edges):
    return (s.qsize.sum() > 0) & (s.rounds < _max_events(wl.cfg))


def _process(ws: WSConfig, state: SimState, st: P.Store, hot, chunk,
             chunk_count, chunk_edges):
    """Charge and write out the chunks `chunk [n]` (-1: none) that the
    lanes of `hot` took: mark them processed, take their base work off
    `rem`, add the work (plus the cold-cache refill penalty where the
    lane's L1 was invalidated since its last chunk) to the lane's
    clock, and write the chunk outputs through the store."""
    p = ws.params
    valid = hot & (chunk >= 0) & (chunk < ws.n_chunks_max)
    safe = chunk.clamp(0, ws.n_chunks_max - 1)
    processed = harness.add_at(state.processed, safe, valid.to(I32))
    count = torch.where(valid, chunk_count[safe.long()], 0)
    edges = torch.where(valid, chunk_edges[safe.long()], 0.0)
    base_work = p.task_base + p.per_edge * edges
    inv_now = st.counters.inv_per_cache
    was_cold = inv_now > state.last_inv
    touched_lines = count.to(F32) + edges / 4.0
    work = base_work + torch.where(
        was_cold, ws.cold_factor * touched_lines * (p.l2_lat / 4.0), 0.0)
    c = st.counters
    st = st._replace(counters=c._replace(
        cycles=c.cycles + torch.where(valid, work, 0.0)))
    last_inv = torch.where(valid, inv_now, state.last_inv)
    # chunk output writes go through the memory system (flushable dirt)
    cfg = ws.proto_cfg()
    for kk in range(ws.chunk_cap // 16 + 1):
        a = ws.data_base + safe * ws.chunk_cap + kk * 16
        st, _ = P.b_store_word(cfg, st, valid & ((kk * 16) < count),
                               a.clamp(0, cfg.n_words - 1), chunk)
    return st, processed, torch.where(valid, base_work, 0.0), last_inv


def _steal_or_idle_turn(wl, state: SimState, wg, chunk_count, chunk_edges
                        ) -> SimState:
    """One serial turn of a work-group with an empty queue: steal from
    the fullest victim (remote-scope sync) or idle.  Steals broadcast
    probes and flushes to other caches, so they never batch."""
    ws, proto = wl.cfg, wl.proto
    cfg = ws.proto_cfg()
    n = ws.n_wgs
    dev = state.qsize.device
    hot = harness.one_hot(n, wg, dev)
    sizes_others = torch.where(hot, 0, state.qsize)
    victim = sizes_others.argmax().to(I32)
    if not (wl.has_remote and bool(sizes_others[victim] > 0)):
        return state._replace(rounds=state.rounds + 1)      # idle

    st = state.store
    lock = victim * ws.qstride
    st, oldv = O.acquire(proto, cfg, st, hot, lock, 0, 1, scope=O.REMOTE)
    # lock-sensitive: a steal that loses the CAS takes nothing and leaves
    # the queue intact (healthy runs never lose it)
    got = oldv[wg] == 0
    st, head = P.load(cfg, st, wg, lock + 1)
    st, tail = P.load(cfg, st, wg, lock + 2)
    has = got & (head < tail)
    slot = head.clamp(0, ws.qcap - 1)
    st, task = P.load(cfg, st, wg, lock + QMETA + slot)
    st, _ = P.store_word(cfg, st, wg, lock + 1, head + 1, guard=has)
    st = O.release(proto, cfg, st, hot & got, lock, 0, scope=O.REMOTE)
    c = st.counters
    st = st._replace(counters=c._replace(steals=c.steals + has.to(F32)))
    chunk = torch.where(has, task - 1, -1)

    # the victim's queue shrinks only on an actual take
    at_victim = harness.one_hot(n, victim, dev)
    took = at_victim & (chunk >= 0)
    qsize = (state.qsize - took.to(I32)).clamp(min=0)
    # the thief pays for the stolen chunk; it leaves the victim's `rem`
    st, processed, done, last_inv = _process(
        ws, state, st, hot, torch.where(hot, chunk, -1), chunk_count,
        chunk_edges)
    rem = (state.rem - torch.where(at_victim, done.sum(), 0.0)).clamp(min=0)
    return SimState(st, qsize, processed, last_inv, state.rounds + 1, rem)


def _pop_batch_turn(wl, state: SimState, mask, chunk_count, chunk_edges
                    ) -> SimState:
    """One pop turn for every work-group in `mask` at once, each op a
    masked multi-cache protocol op."""
    ws, proto = wl.cfg, wl.proto
    cfg = ws.proto_cfg()
    locks = torch.arange(ws.n_wgs, dtype=I32, device=mask.device) \
        * ws.qstride

    st = state.store
    st, oldv = O.acquire(proto, cfg, st, mask, locks, 0, 1, scope=O.LOCAL)
    # lock-sensitive pops: a lane that loses its own-queue CAS takes
    # nothing and releases nothing
    got = mask & (oldv == 0)
    st, tail = O.load(cfg, st, mask, locks + 2)
    st, head = O.load(cfg, st, mask, locks + 1)
    has = got & (head < tail)
    slot = (tail - 1).clamp(0, ws.qcap - 1)
    st, task = O.load(cfg, st, mask, locks + QMETA + slot)
    st, _ = O.store(cfg, st, has, locks + 2, tail - 1)
    st = O.release(proto, cfg, st, got, locks, 0, scope=O.LOCAL)
    chunk = torch.where(has, task - 1, -1)

    qsize = (state.qsize - has.to(I32)).clamp(min=0)
    st, processed, done, last_inv = _process(
        ws, state, st, mask, chunk, chunk_count, chunk_edges)
    rem = (state.rem - done).clamp(min=0.0)
    return SimState(st, qsize, processed, last_inv,
                    state.rounds + mask.sum(dtype=I32), rem)


def build_workload(ws: WSConfig, proto: P.Protocol, steal: bool
                   ) -> harness.Workload:
    """Bind the work-steal spec: pops commute, steals serialize, `rem`
    fences future thieves."""
    return harness.Workload(
        name="worksteal", cfg=ws, proto=proto, has_remote=steal,
        can_local=_can_pop, can_remote=_can_steal,
        local_turn=_pop_batch_turn, remote_turn=_steal_or_idle_turn,
        remote_bound=_steal_bound, live=_live)


# --------------------------------------------------------------------------
# chunking and enqueue
# --------------------------------------------------------------------------

class ChunkPlan(NamedTuple):
    owner: np.ndarray
    slot: np.ndarray
    count: np.ndarray
    edges: np.ndarray   # f32
    valid: np.ndarray
    n_enq: np.ndarray
    rem: np.ndarray     # f32 per-owner sum of base work (the fence bound)
    n_chunks: int


def _chunk_plan(ws: WSConfig, frontier_nodes: np.ndarray, degrees: np.ndarray,
                owner_of) -> ChunkPlan:
    """Host-side chunking; `owner_of(c, sel, n_chunks)` is the ownership
    policy."""
    nf = len(frontier_nodes)
    n_chunks = min((nf + ws.chunk_cap - 1) // ws.chunk_cap, ws.n_chunks_max)
    owner = np.zeros(ws.n_chunks_max, np.int32)
    count = np.zeros(ws.n_chunks_max, np.int32)
    edges = np.zeros(ws.n_chunks_max, np.float32)
    valid = np.zeros(ws.n_chunks_max, bool)
    for c in range(n_chunks):
        sel = frontier_nodes[c * ws.chunk_cap:(c + 1) * ws.chunk_cap]
        owner[c] = owner_of(c, sel, n_chunks)
        count[c] = len(sel)
        edges[c] = float(degrees[sel].sum())
        valid[c] = True
    # slot index within owner's queue
    slot = np.zeros(ws.n_chunks_max, np.int32)
    n_enq = np.zeros(ws.n_wgs, np.int32)
    for c in range(n_chunks):
        slot[c] = n_enq[owner[c]]
        n_enq[owner[c]] += 1
    p = ws.params
    # f32 arithmetic to match the engine's per-pop decrements exactly
    base_work = np.where(valid, np.float32(p.task_base)
                         + np.float32(p.per_edge) * edges, np.float32(0))
    rem = np.zeros(ws.n_wgs, np.float32)
    np.add.at(rem, owner, base_work.astype(np.float32))
    return ChunkPlan(owner, slot, count, edges.astype(np.float32), valid,
                     n_enq, rem, n_chunks)


def _enqueue(ws: WSConfig, oacq_b, orel_b, store: P.Store,
             plan: ChunkPlan) -> P.Store:
    """All owners enqueue at once, each in its own critical section on
    its own queue words and cache: the acquire first (a promoted acquire
    invalidates the cache, so the task words must land inside the
    section), one write-combining scatter of every task word, the
    task-word blocks recorded in each sFIFO block by block (all caches
    pushing in lockstep), then head/tail and the release."""
    cfg = ws.proto_cfg()
    n, w = ws.n_wgs, cfg.block_words
    dev = store.l2.device
    owner, slot, valid, n_enq = (torch.from_numpy(x).to(dev) for x in (
        plan.owner, plan.slot, plan.valid, plan.n_enq))
    chunk_ids = torch.arange(ws.n_chunks_max, dtype=I32, device=dev)
    locks = torch.arange(n, dtype=I32, device=dev) * ws.qstride
    every = torch.ones((n,), dtype=torch.bool, device=dev)

    st, _ = oacq_b(cfg, store, every, locks, 0, 1)
    # out-of-range address -> dropped
    addr = torch.where(valid, owner * ws.qstride + QMETA + slot,
                       cfg.n_blocks * w)
    ab, ao = addr // w, addr % w
    flat = torch.where(valid, (owner * cfg.n_blocks + ab) * w + ao,
                       n * cfg.n_blocks * w)
    st = st._replace(
        l1=P._scatter_rows(st.l1, 3, flat, chunk_ids + 1),
        wvalid=P.plane_scatter_set(st.wvalid, owner, ab, ao),
        wdirty=P.plane_scatter_set(st.wdirty, owner, ab, ao))
    first_blk = (locks + QMETA) // w
    no_tail = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(ws.qcap // 16 + 2):
        guard = (i * w) < n_enq
        f2, evicted, _ = sfifo.push(st.fifo, first_blk + i, no_tail)
        st = st._replace(fifo=P._mask_rows(guard, f2, st.fifo))
        evicted = torch.where(guard, evicted, P.INVALID)
        st, _ = P.b_writeback(cfg, st, evicted, evicted >= 0)
    st, _ = P.b_store_word(cfg, st, every, locks + 1, 0)
    st, _ = P.b_store_word(cfg, st, every, locks + 2, n_enq)
    st = orel_b(cfg, st, every, locks, 0)
    c = st.counters
    return st._replace(counters=c._replace(
        cycles=c.cycles + n_enq.to(F32) * cfg.params.l1_lat))


def _initial_state(ws: WSConfig, store: P.Store, plan: ChunkPlan,
                   last_inv) -> SimState:
    dev = store.l2.device
    return SimState(store=store, qsize=torch.from_numpy(plan.n_enq).to(dev),
                    processed=torch.zeros(ws.n_chunks_max, dtype=I32,
                                          device=dev),
                    last_inv=last_inv,
                    rounds=torch.zeros((), dtype=I32, device=dev),
                    rem=torch.from_numpy(plan.rem).to(dev))


def _ops(plan: ChunkPlan, device) -> tuple:
    return (torch.from_numpy(plan.count).to(device),
            torch.from_numpy(plan.edges).to(device))


def _proc_errors(processed, plan: ChunkPlan) -> int:
    proc = processed.cpu().numpy()
    return int(np.abs(proc[plan.valid] - 1).sum() + proc[~plan.valid].sum())


class WorkStealSim:
    """Round-based simulator for one scenario on one device."""

    def __init__(self, ws: WSConfig, scenario: str, engine: str = "batched",
                 device=None):
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}; "
                             f"registered: {sorted(SCENARIOS)}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"registered: {sorted(ENGINES)}")
        self.ws = ws
        self.scenario = scenario
        self.engine = engine
        self.device = common.resolve_device(device)
        proto_name, steal = SCENARIOS[scenario]
        self.proto = P.get_protocol(proto_name)
        self.steal = steal
        self.cfg = ws.proto_cfg()
        self.workload = build_workload(ws, self.proto, steal)
        self._run_rounds = harness.runner(engine)

    def make_store(self) -> P.Store:
        return P.make_store(self.cfg, self.device)

    def run_iteration(self, store: P.Store, frontier_nodes: np.ndarray,
                      degrees: np.ndarray, last_inv: torch.Tensor):
        """Distribute `frontier_nodes` as chunks, enqueue, run rounds.

        Returns (store', last_inv', proc_errors, n_chunks)."""
        ws = self.ws
        n = len(degrees)
        plan = _chunk_plan(ws, frontier_nodes, degrees,
                           # ownership by node range
                           lambda c, sel, nc: int(sel[0]) * ws.n_wgs // n)
        store = _enqueue(ws, self.proto.acquire_loc_b,
                         self.proto.release_loc_b, store, plan)
        state = self._run_rounds(self.workload,
                                 _initial_state(ws, store, plan, last_inv),
                                 *_ops(plan, self.device))
        return state.store, state.last_inv, \
            _proc_errors(state.processed, plan), plan.n_chunks


# --------------------------------------------------------------------------
# applications (paper §5.1: PageRank, SSSP; MIS also mentioned)
# --------------------------------------------------------------------------

class AppResult(NamedTuple):
    name: str
    scenario: str
    makespan: float
    counters: dict
    proc_errors: int
    iterations: int
    wall_s: float
    solution: np.ndarray


def _edge_arrays(g: CSRGraph):
    rows = np.repeat(np.arange(g.n, dtype=np.int32), g.degrees)
    return rows, g.indices, g.weights


class _Bulk:
    """The apps' bulk-synchronous math on one device: PageRank's pull,
    SSSP's relaxation and Luby's MIS round (the reference's jitted
    `bulk` functions)."""
    INF = 2**30

    def __init__(self, g: CSRGraph, device):
        rows, cols, w = _edge_arrays(g)
        self.n = g.n
        self.dev = device
        self.rows = torch.from_numpy(rows).to(device).long()
        self.cols = torch.from_numpy(cols).to(device).long()
        self.w = torch.from_numpy(w).to(device)
        self.deg = torch.from_numpy(np.maximum(g.degrees, 1)).to(device)

    def pagerank(self, r):
        contrib = r[self.cols] / self.deg[self.cols]
        s = torch.zeros((self.n,), dtype=F32, device=self.dev) \
            .index_add_(0, self.rows, contrib)
        return 0.15 / self.n + 0.85 * s

    def sssp(self, d, fmask):
        cand = torch.where(fmask[self.rows], d[self.rows] + self.w, self.INF)
        nd = d.scatter_reduce(0, self.cols, cand, "amin")
        return nd, nd < d

    def mis(self, st, key):
        und = st == 0
        prio = prng.uniform(key, (self.n,)) + torch.where(und, 0.0, -10.0)
        nb_max = torch.full((self.n,), -20.0, device=self.dev).scatter_reduce(
            0, self.rows, torch.where(und[self.cols], prio[self.cols], -20.0),
            "amax")
        join = und & (prio > nb_max)
        st = torch.where(join, 1, st)
        excl = torch.zeros((self.n,), dtype=I32, device=self.dev) \
            .scatter_reduce(0, self.rows, join[self.cols].to(I32), "amax")
        return torch.where((st == 0) & (excl > 0), 2, st)


def run_app(app: str, g: CSRGraph, scenario: str, ws: WSConfig,
            max_iters: int = 8, seed: int = 0, engine: str = "batched",
            device=None) -> AppResult:
    """One app over `g` through the simulator on `device` (default: the
    GPU): each iteration's frontier is chunked, enqueued and worked off
    by the scenario's scheduler; the bulk math runs beside it."""
    sim = WorkStealSim(ws, scenario, engine, device)
    dev = sim.device
    store = sim.make_store()
    last_inv = torch.zeros((ws.n_wgs,), dtype=F32, device=dev)
    bulk = _Bulk(g, dev)
    n = g.n
    t0 = time.perf_counter()
    errors = 0
    iters = 0

    if app == "pagerank":
        ranks = torch.full((n,), 1.0 / n, dtype=F32, device=dev)
        frontier = np.arange(n, dtype=np.int32)
        for _ in range(max_iters):
            store, last_inv, e, _ = sim.run_iteration(store, frontier,
                                                      g.degrees, last_inv)
            errors += e
            ranks = bulk.pagerank(ranks)
            iters += 1
        solution = ranks.cpu().numpy()

    elif app == "sssp":
        dist = torch.full((n,), bulk.INF, dtype=I32, device=dev)
        dist[0] = 0
        frontier_mask = np.zeros(n, bool)
        frontier_mask[0] = True
        for _ in range(max_iters):
            fnodes = np.nonzero(frontier_mask)[0].astype(np.int32)
            if len(fnodes) == 0:
                break
            store, last_inv, e, _ = sim.run_iteration(store, fnodes,
                                                      g.degrees, last_inv)
            errors += e
            dist, improved = bulk.sssp(
                dist, torch.from_numpy(frontier_mask).to(dev))
            frontier_mask = improved.cpu().numpy()
            iters += 1
        solution = dist.cpu().numpy()

    elif app == "mis":
        # Luby's algorithm: 0 undecided / 1 in MIS / 2 excluded
        status = torch.zeros((n,), dtype=I32, device=dev)
        key = prng.PRNGKey(seed, dev)
        for _ in range(max_iters * 3):
            und_nodes = np.nonzero(status.cpu().numpy() == 0)[0] \
                .astype(np.int32)
            if len(und_nodes) == 0:
                break
            store, last_inv, e, _ = sim.run_iteration(store, und_nodes,
                                                      g.degrees, last_inv)
            errors += e
            key, sub = prng.split(key)
            status = bulk.mis(status, sub)
            iters += 1
        solution = status.cpu().numpy()
    else:
        raise ValueError(f"unknown app {app!r}")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counters = harness.counters_dict(store)
    return AppResult(app, scenario, counters["makespan"], counters, errors,
                     iters, wall, solution)


def reference_solution(app: str, g: CSRGraph, max_iters: int = 8,
                       seed: int = 0) -> np.ndarray:
    """Single-threaded oracle: the same bulk math with no scheduler or
    protocol, in numpy (MIS draws its priorities from `core.prng` on the
    CPU, the same sequence as `run_app`'s)."""
    rows, cols, w = _edge_arrays(g)
    n = g.n
    deg = np.maximum(g.degrees, 1)
    if app == "pagerank":
        r = np.full(n, 1.0 / n, np.float32)
        for _ in range(max_iters):
            s = np.zeros(n, np.float32)
            np.add.at(s, rows, r[cols] / deg[cols])
            r = (0.15 / n + 0.85 * s).astype(np.float32)
        return r
    if app == "sssp":
        INF = np.int64(2**30)
        d = np.full(n, INF, np.int64)
        d[0] = 0
        fmask = np.zeros(n, bool)
        fmask[0] = True
        for _ in range(max_iters):
            if not fmask.any():
                break
            cand = np.where(fmask[rows], d[rows] + w, INF)
            nd = d.copy()
            np.minimum.at(nd, cols, cand)
            fmask = nd < d
            d = nd
        return d.astype(np.int32)
    if app == "mis":
        bulk = _Bulk(g, torch.device("cpu"))
        status = torch.zeros((n,), dtype=I32)
        key = prng.PRNGKey(seed)
        for _ in range(max_iters * 3):
            if not bool((status == 0).any()):
                break
            key, sub = prng.split(key)
            status = bulk.mis(status, sub)
        return status.numpy()
    raise ValueError(app)


# --------------------------------------------------------------------------
# registry contract (workloads/__init__.py): build and check
# --------------------------------------------------------------------------

def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Standard-contract bench on `device` (default: the GPU): a
    one-iteration work-steal round over a synthetic collab graph sized so
    queues start half-full (steals happen).  `proto` overrides the
    scenario's protocol table (fault injection)."""
    _, steal = SCENARIOS[scenario]
    p = harness.resolve_proto(scenario, proto)
    dev = common.resolve_device(device)
    kw.setdefault("chunk_cap", 8)
    kw.setdefault("n_chunks_max", max(2 * n_agents, 8))
    ws = WSConfig(n_wgs=n_agents, **kw)
    g = collab_like(n=ws.n_chunks_max * ws.chunk_cap // 2, m=3,
                    seed=1 + seed)
    wl = build_workload(ws, p, steal)

    frontier = np.arange(g.n, dtype=np.int32)
    # skewed ownership: agent 0 owns half the chunks, the rest spread
    # round-robin, which guarantees the imbalance that makes steals happen
    plan = _chunk_plan(ws, frontier, g.degrees,
                       lambda c, sel, nc: 0 if c < nc // 2 else c % ws.n_wgs)
    store = _enqueue(ws, p.acquire_loc_b, p.release_loc_b,
                     P.make_store(ws.proto_cfg(), dev), plan)
    state = _initial_state(ws, store, plan,
                           torch.zeros((ws.n_wgs,), dtype=F32, device=dev))

    def check(final: SimState) -> dict:
        fails = _proc_errors(final.processed, plan)
        return {"ok": fails == 0, "check_fails": fails,
                "events": int(final.rounds)}

    return harness.Bench(wl, state, _ops(plan, dev), check)
