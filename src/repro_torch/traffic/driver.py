"""Trace -> harness adapter (`repro.traffic.driver`, DESIGN.md §13).

Regroups a `RequestTrace` into per-agent streams plus a cursor and
derives every scheduler predicate the harness needs from (streams,
cursor) alone, so a workload can be traffic-driven by carrying an
`AgentStreams` and a cursor in its state.

Driver contract (what a traffic-driven workload's turns must do):

  * an agent's NEXT request is `streams.<col>[i, cursor[i]]`; the turn
    that completes it advances `cursor[i]` by 1 (a retried turn leaves
    the cursor in place);
  * `remote[i, j]` is True iff the request's key is owned by another
    agent: the can_local/can_remote split is this bit at the cursor;
  * a turn first waits for the request: it charges
    `max(0, arrival - clock)` idle cycles before the protocol ops;
  * every completing turn charges at least `min_turn_cost` compute
    cycles, which makes `remote_bound` a sound fence: with `lbnr[i, j]`
    the run length of local requests starting at j, lane i's next remote
    turn is at least `lbnr * min_turn_cost` cycles away;
  * `quota[i]` is the retirement-adjustable stream length (`retire`,
    `admit`); offered load stays the streams' full length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.traffic import trace as TR

BIG = 3e38      # float32(3e38): the bound of an exhausted lane
I32 = torch.int32


class AgentStreams(NamedTuple):
    """Per-agent request matrices, [n_agents, m] each (+ [n] quota)."""
    arrival: torch.Tensor  # f32 arrival clocks, sorted along axis 1
    key: torch.Tensor      # i32 requested key
    kind: torch.Tensor     # i32 0=read / 1=write
    remote: torch.Tensor   # bool key owned by another agent
    lbnr: torch.Tensor     # i32 local-run length starting here (0 if remote)
    quota: torch.Tensor    # i32 serviceable stream length per agent


def _local_runs(remote: torch.Tensor) -> torch.Tensor:
    """lbnr[i, j]: consecutive local requests starting at column j, the
    distance to the first remote column at or after j (the reference's
    reverse scan, as a reverse cumulative minimum)."""
    m = remote.shape[1]
    col = torch.arange(m, dtype=I32, device=remote.device)
    nxt = torch.where(remote, col, m).flip(1).cummin(dim=1).values.flip(1)
    return (nxt - col).to(I32)


def from_trace(tr: TR.RequestTrace, n_agents: int, m: int) -> AgentStreams:
    """Regroup a flat trace into per-agent streams of exactly `m`
    requests each, on the trace's device: rows by agent, then arrival
    (the reference's lexsort, as two stable sorts)."""
    order = torch.sort(tr.arrival, stable=True).indices
    order = order[torch.sort(tr.agent[order], stable=True).indices]

    def take(c):
        return c[order].reshape(n_agents, m)

    key = take(tr.key)
    lanes = torch.arange(n_agents, dtype=I32, device=key.device)
    remote = TR.owner(key, n_agents) != lanes[:, None]
    return AgentStreams(arrival=take(tr.arrival), key=key,
                        kind=take(tr.kind), remote=remote,
                        lbnr=_local_runs(remote),
                        quota=torch.full((n_agents,), m, dtype=I32,
                                         device=key.device))


def at_cursor(streams: AgentStreams, cursor: torch.Tensor):
    """(arrival, key, kind, remote) of each agent's next request.
    Exhausted lanes return their last request's columns; callers gate on
    `pending` before acting on them."""
    m = streams.arrival.shape[1]
    cur = cursor.clamp(0, m - 1).long()[:, None]
    return tuple(c.gather(1, cur)[:, 0] for c in (
        streams.arrival, streams.key, streams.kind, streams.remote))


def pending(streams: AgentStreams, cursor: torch.Tensor) -> torch.Tensor:
    """[n] bool: lanes with unserved requests inside their quota."""
    return cursor < streams.quota


def can_local(streams: AgentStreams, cursor: torch.Tensor) -> torch.Tensor:
    return pending(streams, cursor) & ~at_cursor(streams, cursor)[3]


def can_remote(streams: AgentStreams, cursor: torch.Tensor) -> torch.Tensor:
    return pending(streams, cursor) & at_cursor(streams, cursor)[3]


def remote_bound(streams: AgentStreams, cursor: torch.Tensor,
                 min_turn_cost: float) -> torch.Tensor:
    """[n] f32 lower bound on cycles before each lane's next remote turn
    (the harness fence input; BIG for exhausted lanes)."""
    m = streams.arrival.shape[1]
    cur = cursor.clamp(0, m - 1).long()[:, None]
    run = streams.lbnr.gather(1, cur)[:, 0].to(torch.float32)
    return torch.where(pending(streams, cursor), run * float(min_turn_cost),
                       BIG)


def wait_cycles(streams: AgentStreams, cursor: torch.Tensor,
                clocks: torch.Tensor) -> torch.Tensor:
    """[n] f32 idle cycles each lane charges before serving its next
    request: the request may not have arrived yet."""
    return (at_cursor(streams, cursor)[0] - clocks).clamp(min=0.0)


def retire(streams: AgentStreams, cursor: torch.Tensor,
           dead: torch.Tensor) -> AgentStreams:
    """Forgive a dead agent's unserved tail (the identity when `dead` is
    all False)."""
    return streams._replace(quota=torch.where(
        dead, torch.minimum(streams.quota, cursor), streams.quota))


def admit(streams: AgentStreams, cursor: torch.Tensor,
          join: torch.Tensor) -> AgentStreams:
    """Re-open one request for a (re-)joining agent, bounded by the
    stream's physical length."""
    m = streams.arrival.shape[1]
    return streams._replace(quota=torch.where(
        join, (cursor + 1).clamp(max=m), streams.quota))
