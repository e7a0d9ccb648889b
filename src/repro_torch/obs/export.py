"""Host-side trace decode and Chrome-trace/Perfetto export
(`repro.obs.export`, DESIGN.md §11).

`decode` reorders the ring buffer oldest-first and reports how many
events overflow dropped; `chrome_trace` renders the result in the Chrome
trace-event JSON object format that Perfetto loads (one thread track per
agent, modeled cycles mapped 1:1 onto trace microseconds), with churn,
recovery and straggler instants on a scheduler track; `write_trace`
wraps both and keeps the latency summary under a top-level "srsp" key,
so that `python -m repro_torch.obs.report FILE` prints a text report
from the JSON alone.  For the same store it writes the same document as
the JAX package.  The columns may be tensors on any device or numpy
arrays.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.obs import metrics
from repro_torch.obs import trace as T

SCHED_TID = 10_000   # instants track, clear of any real agent id
SCOPE_NAMES = {0: "loc", 1: "rem", 2: "glob"}


def _np(x) -> np.ndarray:
    """A column as a numpy array (from a tensor on any device)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def decode(tl) -> dict:
    """Ring buffer -> numpy event columns, oldest-first.

    Returns {"events": {col: np.ndarray}, "count", "dropped"}."""
    head = int(tl.head)
    cap = tl.clock.shape[0]
    count = min(head, cap)
    start = head % cap if head > cap else 0
    order = (np.arange(count) + start) % cap if count else np.arange(0)
    cols = {k: _np(getattr(tl, k))[order]
            for k in ("clock", "agent", "kind", "scope", "addr",
                      "cycles", "outcome")}
    return {"events": cols, "count": count,
            "dropped": max(head - cap, 0)}


def _outcome_name(kind: int, outcome: int) -> str:
    if kind == T.CHURN:
        return T.CHURN_NAMES.get(outcome, str(outcome))
    return T.OUTCOME_NAMES.get(outcome, str(outcome))


def chrome_trace(dec: dict, *, n_agents: int = None, meta: dict = None,
                 stragglers=()) -> dict:
    """Chrome trace-event object format (Perfetto-loadable)."""
    ev = dec["events"]
    agents = sorted(set(int(a) for a in ev["agent"])) \
        if n_agents is None else list(range(n_agents))
    out = [{"name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "srsp modeled machine"}}]
    for a in agents:
        out.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": a,
                    "args": {"name": f"agent {a}"}})
    out.append({"name": "thread_name", "ph": "M", "pid": 0,
                "tid": SCHED_TID, "args": {"name": "scheduler events"}})
    for i in range(dec["count"]):
        kind = int(ev["kind"][i])
        kname = T.KIND_NAMES.get(kind, str(kind))
        oname = _outcome_name(kind, int(ev["outcome"][i]))
        rec = {"pid": 0, "ts": float(ev["clock"][i]),
               "cat": kname,
               "args": {"addr": int(ev["addr"][i]),
                        "scope": SCOPE_NAMES.get(int(ev["scope"][i]), "?"),
                        "outcome": oname}}
        if kind in (T.CHURN, T.RECOVER):
            # zero-duration scheduler instants on their own track
            rec.update({"name": f"{kname}:{oname} agent "
                                f"{int(ev['agent'][i])}",
                        "ph": "i", "s": "p", "tid": SCHED_TID})
        else:
            rec.update({"name": f"{kname}.{oname}", "ph": "X",
                        "tid": int(ev["agent"][i]),
                        "dur": max(float(ev["cycles"][i]), 0.01)})
        out.append(rec)
    for s in stragglers:
        out.append({"name": f"straggler cell {s.get('cell', '?')}",
                    "ph": "i", "s": "g", "pid": 0, "tid": SCHED_TID,
                    "ts": 0.0, "args": dict(s)})
    doc = {"traceEvents": out, "displayTimeUnit": "ns"}
    if meta:
        doc["srsp"] = meta
    return doc


def trace_meta(store, *, label: str = None, stragglers=()) -> dict:
    """Summary block kept in the exported JSON (the report's input)."""
    tl = store.trace
    dec = decode(tl)
    ev = dec["events"]
    kinds = {}
    for kind in np.unique(ev["kind"]).tolist() if dec["count"] else []:
        kinds[T.KIND_NAMES.get(int(kind), str(kind))] = \
            int((ev["kind"] == kind).sum())
    per_scope = {}
    oh = _np(tl.op_hist).astype(np.int64)
    for s, sname in SCOPE_NAMES.items():
        pooled = oh[s].sum(axis=0)
        if pooled.sum():
            per_scope[sname] = metrics.summarize(pooled)
    return {"label": label,
            "n_agents": int(store.counters.cycles.shape[0]),
            "events": int(tl.head), "dropped": dec["dropped"],
            "capacity": T.capacity(tl),
            "kinds": kinds,
            "turn_latency": T.summary(store),
            "op_cycles_per_scope": per_scope,
            "stragglers": list(stragglers)}


def trace_doc(store, *, label: str = None, stragglers=()) -> dict:
    """The Perfetto-loadable document of a traced store."""
    return chrome_trace(decode(store.trace),
                        n_agents=int(store.counters.cycles.shape[0]),
                        meta=trace_meta(store, label=label,
                                        stragglers=stragglers),
                        stragglers=stragglers)


def write_trace(path: str, store, *, label: str = None,
                stragglers=()) -> dict:
    """Export a traced store to Perfetto-loadable JSON; returns the doc."""
    doc = trace_doc(store, label=label, stragglers=stragglers)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def text_report(doc: dict) -> str:
    """Human-readable report from an exported trace JSON doc."""
    meta = doc.get("srsp") or {}
    lines = []
    label = meta.get("label") or "trace"
    lines.append(f"== sRSP trace report: {label} ==")
    lines.append(f"agents={meta.get('n_agents')} "
                 f"events={meta.get('events')} "
                 f"dropped={meta.get('dropped')} "
                 f"(ring capacity {meta.get('capacity')})")
    if meta.get("kinds"):
        kinds = "  ".join(f"{k}={v}" for k, v in
                          sorted(meta["kinds"].items()))
        lines.append(f"event kinds: {kinds}")
    tl = meta.get("turn_latency") or {}
    if tl.get("latency_turns"):
        lines.append(f"turn latency (modeled cycles, upper-edge): "
                     f"p50={tl['latency_p50']} p95={tl['latency_p95']} "
                     f"p99={tl['latency_p99']} over "
                     f"{tl['latency_turns']} turns")
    for sname, s in (meta.get("op_cycles_per_scope") or {}).items():
        lines.append(f"  {sname:4s} ops: n={s['count']} p50={s['p50']} "
                     f"p95={s['p95']} p99={s['p99']}")
    for s in meta.get("stragglers") or []:
        lines.append(f"straggler: {s}")
    n_spans = sum(1 for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X")
    lines.append(f"{n_spans} spans exported — load the JSON in "
                 f"https://ui.perfetto.dev (or chrome://tracing)")
    return "\n".join(lines)
