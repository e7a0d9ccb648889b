"""Columnar request traces (`repro.traffic.trace`, DESIGN.md §13).

A `RequestTrace` is four flat, equal-length columns:

    arrival  [M] f32  simulated arrival clock (cycles)
    key      [M] i32  requested key in [0, n_keys)
    kind     [M] i32  0 = read, 1 = write
    agent    [M] i32  issuing agent (front-end shard) in [0, n_agents)

Key `k` is owned by agent `k % n_agents`.  Each request draws its key
from the requesting agent's own shard with probability `1 - remote_frac` (Zipf
over own ranks) and from the global Zipf otherwise; cross-owner requests
are forced to reads.

`generate` draws a trace from the samplers on a device, with the
reference's keys and layout.  Its integer draws are the reference's; its
arrival clocks agree to a few ulps (`samplers`), so a golden run replays
the trace the reference generated instead: `save`/`load` use the
reference's `.npz` format (the four columns plus a JSON provenance
record as uint8), so a trace written by either package loads in the
other.  `save_set`/`load_set` keep several named traces in one
compressed file of the same records (the golden traces).
"""
from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import common
from repro_torch.traffic import samplers as S

I32 = torch.int32


class RequestTrace(NamedTuple):
    arrival: torch.Tensor  # [M] f32 sorted-within-agent arrival clocks
    key: torch.Tensor      # [M] i32 requested key
    kind: torch.Tensor     # [M] i32 0=read / 1=write
    agent: torch.Tensor    # [M] i32 issuing agent


def owner(key: torch.Tensor, n_agents: int) -> torch.Tensor:
    """Canonical placement: key k lives on agent k % n_agents."""
    return torch.remainder(key.to(I32), n_agents)


def generate(cfg: S.TrafficConfig, n_agents: int, n_keys: int, seed,
             device=None) -> RequestTrace:
    """Draw the trace for (cfg, n_agents, n_keys, seed) on `device`
    (default: the GPU): one key fold per agent, one sub-key per column,
    every agent's streams drawn at once.  Rows come out sorted by
    arrival clock (ties: agent, then request order)."""
    if n_keys % n_agents != 0:
        raise ValueError(f"n_keys ({n_keys}) must be a multiple of "
                         f"n_agents ({n_agents}) for the canonical "
                         f"interleaved placement")
    dev = common.resolve_device(device)
    m = cfg.requests_per_agent
    lanes = torch.arange(n_agents, dtype=I32, device=dev)
    ka = prng.fold_in(prng.PRNGKey(seed, dev), lanes)          # [n, 2]
    sub = [prng.fold_in(ka, j) for j in range(5)]
    arr = S.arrival_clocks(sub[0], m, cfg)                     # [n, m]
    gkey = S.zipf_ranks(sub[1], m, n_keys, cfg.zipf_s)
    lrank = S.zipf_ranks(sub[2], m, n_keys // n_agents, cfg.zipf_s)
    rem = S.remote_draws(sub[3], m, cfg.remote_frac)
    wr = S.request_kinds(sub[4], m, cfg.write_frac)
    key = torch.where(rem, gkey, lanes[:, None] + lrank * n_agents)
    kind = torch.where(owner(key, n_agents) == lanes[:, None], wr, 0)
    agent = lanes[:, None].expand(n_agents, m)
    # rows flatten agent-major in request order, so one stable sort by
    # arrival is the reference's lexsort by (arrival, agent, position)
    order = torch.sort(arr.reshape(-1), stable=True).indices
    return RequestTrace(arrival=arr.reshape(-1)[order],
                        key=key.reshape(-1)[order].to(I32),
                        kind=kind.reshape(-1)[order].to(I32),
                        agent=agent.reshape(-1)[order].contiguous())


def arrival_rtol(m: int) -> float:
    """Relative tolerance between two float32 drafts of an m-request
    arrival stream: any summation order of m non-negative gaps, each off
    by an ulp, rounds within (m + 2) * 2**-24 of the exact sum, and the
    two drafts may lie on opposite sides."""
    return 2 * (m + 2) * 2.0**-24


def compare(got: RequestTrace, want: RequestTrace, n_agents: int,
            m: int) -> dict:
    """How `got` (a `generate` draw) stands against `want` (the
    reference's trace of the same provenance).  `held` is True when every
    agent's stream has the reference's keys and kinds bit for bit and
    every arrival clock, per agent and in the flat arrival-sorted
    column, is within `arrival_rtol(m)`.  Also counted: arrival clocks
    that differ at all, and flat rows whose (agent, key, kind) differ,
    which can only be neighbours that an arrival ulp put in the other
    order."""
    from repro_torch.traffic import driver as D   # driver imports trace

    def streams(tr):
        return D.from_trace(RequestTrace(*(torch.as_tensor(c).cpu()
                                           for c in tr)), n_agents, m)

    a, b = streams(got), streams(want)
    rtol = arrival_rtol(m)

    def close(x, y):
        return bool(((x - y).abs() <= rtol * y.abs()).all())

    flat = [torch.as_tensor(c).cpu() for c in (got.arrival, want.arrival)]
    moved = torch.zeros(flat[0].shape, dtype=torch.bool)
    for f in ("agent", "key", "kind"):
        moved |= torch.as_tensor(getattr(got, f)).cpu() \
            != torch.as_tensor(getattr(want, f)).cpu()
    return {"held": bool(torch.equal(a.key, b.key)
                         and torch.equal(a.kind, b.kind)
                         and close(a.arrival, b.arrival)
                         and close(*flat)),
            "arrival_rtol": rtol,
            "arrivals_differing": int((a.arrival != b.arrival).sum()),
            "max_rel_arrival": float(((a.arrival - b.arrival).abs()
                                      / b.arrival.abs().clamp(min=1e-30))
                                     .max()),
            "rows_reordered": int(moved.sum()), "rows": int(moved.numel())}


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def _record(tr, cfg: S.TrafficConfig, n_agents: int, n_keys: int,
            seed: int) -> dict:
    """The `.npz` arrays of one trace: its columns (a RequestTrace of
    either package) and a JSON provenance record as uint8."""
    meta = {"config": dataclasses.asdict(cfg), "n_agents": int(n_agents),
            "n_keys": int(n_keys), "seed": int(seed)}
    rec = {f: _np(getattr(tr, f), np.float32 if f == "arrival" else np.int32)
           for f in RequestTrace._fields}
    rec["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    return rec


def _from_record(get, device):
    meta = json.loads(bytes(get("meta")).decode())
    meta["config"] = S.TrafficConfig(**meta["config"])
    dev = common.resolve_device(device)
    return RequestTrace(*(torch.from_numpy(np.array(get(f))).to(dev)
                          for f in RequestTrace._fields)), meta


def save(path: str, tr: RequestTrace, *, cfg: S.TrafficConfig,
         n_agents: int, n_keys: int, seed: int) -> None:
    """One .npz: the four columns + a JSON provenance record."""
    np.savez(path, **_record(tr, cfg, n_agents, n_keys, seed))


def load(path: str, device=None):
    """-> (RequestTrace on `device` (default: the GPU), meta dict with
    'config' as a `TrafficConfig`)."""
    with np.load(path) as z:
        return _from_record(lambda k: z[k], device)


def save_set(path: str, traces: dict) -> None:
    """Several named traces in one compressed .npz, each as `save` writes
    one, its arrays under `<name>/`: `traces` maps a name to a dict of
    `tr`, `cfg`, `n_agents`, `n_keys` and `seed`."""
    arrays = {}
    for name, t in traces.items():
        for k, v in _record(**t).items():
            arrays[f"{name}/{k}"] = v
    np.savez_compressed(path, **arrays)


def load_set(path: str, device=None) -> dict:
    """{name: (RequestTrace, meta)} of a `save_set` file."""
    with np.load(path) as z:
        names = sorted({k.rsplit("/", 1)[0] for k in z.files})
        return {n: _from_record(lambda k, n=n: z[f"{n}/{k}"], device)
                for n in names}
