"""Reader-heavy lock: one hot local writer, many rare remote readers
(`repro.workloads.reader_lock`).

Agent 0 publishes version `writes_done + 1` into every payload word
behind its lock with LOCAL-scope synchronization; every other agent burns
scratch turns in its own region and now and then remote-acquires the
writer's lock to read the payload.  A read is checked in-run: every
payload word must equal the bookkept `writes_done` at the read's serial
position.  The workload declares no remote batching (every read targets
the one lock), so its remote turns serialize.  Self-check: in-run
torn/stale reads plus a drained-L2 audit of the payload.
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
    n_writes: int = 10          # writer publishes this many versions
    reads_per_reader: int = 2
    gap: int = 3                # reader scratch turns before each read
    payload_w: int = 4          # payload words behind the lock
    scratch_cost: float = 20.0
    fifo_cap: int = 16
    lr_tbl: tables.TableGeometry = tables.LR_GEOMETRY
    pa_tbl: tables.TableGeometry = tables.PA_GEOMETRY
    params: CostParams = dataclasses.field(default_factory=CostParams)

    @property
    def stride(self) -> int:
        return 16

    @property
    def n_words(self) -> int:
        return self.n_agents * self.stride

    def proto_cfg(self) -> P.ProtoConfig:
        return P.ProtoConfig(n_caches=self.n_agents, n_words=self.n_words,
                             fifo_cap=self.fifo_cap, lr_tbl=self.lr_tbl,
                             pa_tbl=self.pa_tbl, params=self.params)


class RLState(NamedTuple):
    store: P.Store
    writes_done: torch.Tensor  # [] i32 bookkeeping: versions published
    reads_done: torch.Tensor   # [n] i32 per-reader completed reads
    credit: torch.Tensor       # [n] i32 scratch turns before next read
    gapv: torch.Tensor         # [n] i32 per-reader (seed-jittered) gap
    w_target: torch.Tensor     # [] i32 writer obligation
    r_target: torch.Tensor     # [n] i32 per-reader obligation
    check_fails: torch.Tensor  # [] i32
    rounds: torch.Tensor       # [] i32


def _max_events(cfg: Config) -> int:
    return cfg.n_writes + cfg.n_agents * cfg.reads_per_reader * (cfg.gap + 4) \
        + 4 * cfg.n_agents


def _lanes(cfg: Config, device) -> torch.Tensor:
    return torch.arange(cfg.n_agents, dtype=I32, device=device)


def _can_local(wl, s: RLState):
    lanes = _lanes(wl.cfg, s.credit.device)
    reader = (s.reads_done < s.r_target) & (s.credit > 0)
    return torch.where(lanes == 0, s.writes_done < s.w_target, reader)


def _can_remote(wl, s: RLState):
    lanes = _lanes(wl.cfg, s.credit.device)
    return (lanes > 0) & (s.reads_done < s.r_target) & (s.credit == 0)


def _remote_bound(wl, s: RLState):
    lanes = _lanes(wl.cfg, s.credit.device)
    return torch.where(lanes > 0,
                       s.credit.to(torch.float32) * wl.cfg.scratch_cost,
                       harness.BIG)


def _live(wl, s: RLState):
    lanes = _lanes(wl.cfg, s.credit.device)
    work = (s.writes_done < s.w_target) \
        | ((lanes > 0) & (s.reads_done < s.r_target)).any()
    return work & (s.rounds < _max_events(wl.cfg))


def _retire(wl, s: RLState, dead, *ops) -> RLState:
    """Elastic retirement (DESIGN.md §10): a dead writer (lane 0) stops
    owing versions, and the payload audit still checks the published
    ones; a dead reader stops owing reads.  The identity when `dead` is
    all False."""
    return s._replace(
        w_target=torch.where(dead[0],
                             torch.minimum(s.w_target, s.writes_done),
                             s.w_target),
        r_target=torch.where(dead, torch.minimum(s.r_target, s.reads_done),
                             s.r_target))


def _admit(wl, s: RLState, join, *ops) -> RLState:
    """Elastic (re-)admission: a joining writer owes one more version, a
    joining reader one more read."""
    lanes = _lanes(wl.cfg, join.device)
    return s._replace(
        w_target=torch.where(join[0], s.writes_done + 1, s.w_target),
        r_target=torch.where(join & (lanes > 0), s.reads_done + 1,
                             s.r_target))


def _local_turn(wl, s: RLState, mask) -> RLState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    n = cfg.n_agents
    lanes = _lanes(cfg, mask.device)
    is0 = lanes == 0
    wmask = mask & is0
    rmask = mask & ~is0
    zeros = torch.zeros((n,), dtype=I32, device=mask.device)

    st = s.store
    # writer: publish version writes_done+1 to every payload word inside
    # its own critical section (LOCAL-scope sync)
    st, _ = O.acquire(wl.proto, pc, st, wmask, zeros, 0, 1, scope=O.LOCAL)
    ver = (s.writes_done + 1).expand(n)
    for j in range(cfg.payload_w):
        st, _ = O.store(pc, st, wmask, zeros + 2 + j, ver)
    st = O.release(wl.proto, pc, st, wmask, zeros, 0, scope=O.LOCAL)
    # readers: scratch write in their own regions
    scr = lanes * cfg.stride + 2 + torch.remainder(s.credit, 8)
    st, _ = O.store(pc, st, rmask, scr, s.credit)
    st = harness.charge(st, mask, cfg.scratch_cost)

    return s._replace(
        store=st,
        writes_done=s.writes_done + wmask[0].to(I32),
        credit=s.credit - rmask.to(I32),
        rounds=s.rounds + mask.sum(dtype=I32))


def _remote_turn(wl, s: RLState, wg) -> RLState:
    # the scheduler's own predicate: a lane that cannot go remote idles
    return P.cond(_can_remote(wl, s)[wg], _read,
                  lambda wl, s, wg: s._replace(rounds=s.rounds + 1),
                  wl, s, wg)


def _read(wl, s: RLState, wg) -> RLState:
    cfg = wl.cfg
    pc = cfg.proto_cfg()
    st = s.store
    hot = harness.one_hot(cfg.n_agents, wg, st.l2.device)
    st, old_v = O.acquire(wl.proto, pc, st, hot, 0, 0, 1, scope=O.REMOTE)
    st, v0 = P.load(pc, st, wg, 2)
    fails = (old_v[wg] != 0).to(I32) + (v0 != s.writes_done).to(I32)
    for j in range(1, cfg.payload_w):
        st, vj = P.load(pc, st, wg, 2 + j)
        fails = fails + (vj != v0).to(I32)      # torn read
    st = O.release(wl.proto, pc, st, hot, 0, 0, scope=O.REMOTE)
    return s._replace(
        store=st,
        reads_done=s.reads_done + hot.to(I32),
        credit=torch.where(hot, s.gapv, s.credit),
        check_fails=s.check_fails + fails,
        rounds=s.rounds + 1)


def build_workload(cfg: Config, proto: P.Protocol) -> harness.Workload:
    return harness.Workload(
        name="reader_lock", cfg=cfg, proto=proto, has_remote=True,
        can_local=_can_local, can_remote=_can_remote,
        local_turn=_local_turn, remote_turn=_remote_turn,
        remote_bound=_remote_bound, live=_live,
        retire=_retire, admit=_admit)


def init_state(wl, seed, device=None) -> RLState:
    cfg = wl.cfg
    dev = common.resolve_device(device)
    lanes = _lanes(cfg, dev)
    seed = torch.tensor(seed, dtype=I32, device=dev)
    gapv = cfg.gap + torch.remainder(seed * 31 + lanes * 7, 3)
    gapv = torch.where(lanes == 0, 0, gapv).to(I32)
    n = cfg.n_agents
    return RLState(
        store=P.make_store(cfg.proto_cfg(), dev),
        writes_done=torch.zeros((), dtype=I32, device=dev),
        reads_done=torch.zeros((n,), dtype=I32, device=dev),
        credit=gapv.clone(),
        gapv=gapv,
        w_target=torch.tensor(cfg.n_writes, dtype=I32, device=dev),
        r_target=torch.where(lanes == 0, 0, cfg.reads_per_reader).to(I32),
        check_fails=torch.zeros((), dtype=I32, device=dev),
        rounds=torch.zeros((), dtype=I32, device=dev))


def self_check(wl, final: RLState) -> dict:
    """In-run torn/stale failures + drained-L2 final-version audit."""
    cfg = wl.cfg
    fails = int(final.check_fails)
    reads = final.reads_done.cpu().numpy()
    done = int(final.writes_done) >= int(final.w_target) and bool(
        np.all(reads[1:] >= final.r_target.cpu().numpy()[1:]))
    st = harness.drain_all(cfg.proto_cfg(), final.store)
    l2 = st.l2.cpu().numpy().reshape(-1)
    fails += int(np.sum(l2[2:2 + cfg.payload_w] != int(final.writes_done)))
    return {"ok": fails == 0 and done, "check_fails": fails,
            "done": done, "events": int(final.rounds)}


def build(scenario: str, n_agents: int, seed: int = 0, *,
          proto: P.Protocol = None, device=None, **kw) -> harness.Bench:
    """Bench for one scenario; runs on `device` (default: the GPU)."""
    return harness.make_bench(Config(n_agents=n_agents, **kw),
                              build_workload, init_state, self_check,
                              scenario, seed, proto, device)
