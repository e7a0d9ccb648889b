"""The checks and comparisons of a sweep document (the schema-v8
`BENCH_workloads*.json` that `repro_torch.workloads.sweep` writes, and
the reference's): `check_doc`, the port's copy of
`benchmarks/check_smoke.py`'s structural checks with the port's kernel
modes; `modeled` and `diff_modeled`, the columns a run decides and where
two documents differ in them, whole or row against row of two documents
that may hold different grids.
"""
from __future__ import annotations

import json
import os

SCHEMA_VERSION = 8
KERNEL_MODES = ("cuda", "plain")
# the latency and trace columns every row carries
LATENCY_KEYS = ("latency_p50", "latency_p95", "latency_p99", "latency_turns",
                "trace_events", "trace_dropped", "latency_source")
TRAFFIC_KEYS = ("offered_load", "completed", "zipf_s", "burstiness",
                "latency_source")

# what `modeled` leaves out: the wall times, and the columns that name
# the package or the host rather than the modeled run
WALL_KEYS = ("compile_s", "steady_s_per_run", "steady_s_per_replica",
             "bench_wall_s", "steady_s_per_iter")
HOST_KEYS = ("kernel_mode",)
TOP_HOST_KEYS = ("metric_note", "backend", "donate_buffers", "kernel_mode",
                 "stragglers")
SECTIONS = ("runs", "serving", "donation_ab", "pack_ab", "remote_batch_ab",
            "fuse_ab")


def modeled(doc: dict) -> dict:
    """A sweep document's modeled columns, to compare two documents, the
    reference's and the port's, with `==`: every key but the wall times
    (`WALL_KEYS`, the comparisons' `steady_speedup_*`), the kernel mode,
    the top level's note, backend, donation flag and stragglers, and the
    trace file's path."""
    def row(r):
        return {k: v for k, v in r.items()
                if k not in WALL_KEYS + HOST_KEYS}

    out = {k: v for k, v in doc.items() if k not in TOP_HOST_KEYS}
    for sec in SECTIONS:
        out[sec] = [row(r) for r in doc.get(sec, [])]
    out["comparisons"] = {
        name: {k: v for k, v in c.items()
               if not k.startswith("steady_speedup")}
        for name, c in doc.get("comparisons", {}).items()}
    out["trace"] = {k: v for k, v in (doc.get("trace") or {}).items()
                    if k != "file"}
    return out


class _Missing:
    def __repr__(self):
        return "<missing>"


# the columns a row decides: what `diff_modeled(columns=ROW_COLUMNS)`
# holds between documents that may hold different grids
ROW_COLUMNS = ("makespan", "counters", "check_ok", "check_fails", "events")
# the sections whose rows `diff_modeled(columns=)` matches by `_label`
LABELED = ("runs", "serving", "remote_batch_ab", "fuse_ab")


def _label(sec: str, r: dict) -> str:
    zipf = f"/zipf={r['zipf_s']}" if sec == "serving" else ""
    churn = "+crash" if r.get("churn_events") else ""
    arm = ("/batched" if r["remote_batch"] else "/serialized") \
        if sec == "remote_batch_ab" else ""
    return (f"{sec}/{r['workload']}/{r['scenario']}{churn}{zipf}"
            f"/n={r['n_agents']}/R={r['n_replicas']}/{r['engine']}{arm}")


def diff_modeled(doc: dict, ref: dict, columns=None) -> list:
    """Where `modeled(doc)` and `modeled(ref)` differ: one
    "path: got != want" line each (empty when they are equal).  With
    `columns`, for documents that may hold different grids: each row of
    `doc`'s `LABELED` sections against the row of `ref` with the same
    section, workload, scenario, churn, skew, size, replica count,
    engine and remote arm, in those columns only (a row `ref` lacks is
    one line)."""
    out, missing = [], _Missing()

    def walk(path, a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b), key=str):
                walk(f"{path}.{k}" if path else str(k), a.get(k, missing),
                     b.get(k, missing))
        elif isinstance(a, list) and isinstance(b, list) \
                and len(a) == len(b):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(f"{path}[{i}]", x, y)
        elif a != b:
            out.append(f"{path}: {a!r} != {b!r}")

    if columns is None:
        walk("", modeled(doc), modeled(ref))
        return out

    def rows(d):
        return {_label(sec, r): {c: r.get(c, missing) for c in columns}
                for sec in LABELED for r in d.get(sec, [])}

    have, want = rows(doc), rows(ref)
    walk("", have, {k: want.get(k, missing) for k in have})
    return out


def check_doc(doc: dict, *, expect_trace: bool, doc_dir: str = ".") -> list:
    """The structural checks of a sweep document (the port's copy of
    `benchmarks/check_smoke.py`'s `check`, with the port's kernel modes):
    a list of failures, empty when the document passes.  `expect_trace`
    (a run under REPRO_TRACE=1) also wants a traced row with latency
    percentiles and a loadable Chrome-trace file at the path the
    document names, relative to `doc_dir`."""
    fails = []
    if doc.get("schema_version") != SCHEMA_VERSION:
        fails.append(f"schema_version {doc.get('schema_version')} != "
                     f"{SCHEMA_VERSION}")
    runs = doc.get("runs", [])
    if not runs:
        fails.append("no runs")

    bad = [r for r in runs if not r.get("check_ok")
           and r.get("scenario") != "scope_only"]
    if bad:
        fails.append(f"check_ok failures: {bad}")
    if not all(r.get("api") == "scoped" for r in runs):
        fails.append("non-scoped api rows present")

    if not [r for r in runs if r.get("remote_batch")]:
        fails.append("no remote-batch-capable cell in the grid")
    ab = doc.get("remote_batch_ab")
    if not ab or not all(r.get("check_ok") for r in ab):
        fails.append(f"remote_batch_ab missing or failed: {ab}")

    ch = [r for r in runs if r.get("churn_events")]
    if not ch:
        fails.append("no churned crash-recovery cell")
    elif not all(r.get("check_ok") and r.get("recovered", 0) > 0
                 and r.get("lost_updates") == 0 for r in ch):
        fails.append(f"churned cell failed: {ch}")

    # v6: every row carries the latency/trace columns (None/0 untraced)
    missing = [r for r in runs if any(k not in r for k in LATENCY_KEYS)]
    if missing:
        fails.append(f"rows missing v6 latency columns: {missing[:3]}")

    # v7: fused rows, the batched schedule, kernel mode on every row
    fused = [r for r in runs if r.get("engine") == "fused"]
    if not fused:
        fails.append("no engine=fused cell in the grid (schema v7)")
    if doc.get("kernel_mode") not in KERNEL_MODES:
        fails.append(f"bad top-level kernel_mode: {doc.get('kernel_mode')}")
    no_mode = [r for r in runs if r.get("kernel_mode") not in KERNEL_MODES]
    if no_mode:
        fails.append(f"rows missing v7 kernel_mode column: {no_mode[:3]}")
    for f_ in fused:
        twin = next((r for r in runs if r.get("engine") == "batched"
                     and (r["workload"], r["scenario"], r["n_agents"])
                     == (f_["workload"], f_["scenario"], f_["n_agents"])),
                    None)
        if twin and twin["makespan"] != f_["makespan"]:
            fails.append(f"fused/batched makespan diverges: {f_} vs {twin}")

    # v8: traffic columns on every row; kv_serving rows account offered
    # against completed requests and carry request latencies
    no_traffic = [r for r in runs if any(k not in r for k in TRAFFIC_KEYS)]
    if no_traffic:
        fails.append(f"rows missing v8 traffic columns: {no_traffic[:3]}")
    kv = [r for r in runs if r.get("workload") == "kv_serving"]
    if not kv:
        fails.append("no kv_serving cell in the grid (schema v8)")
    for r in kv:
        ok_counts = (isinstance(r.get("offered_load"), int)
                     and isinstance(r.get("completed"), int)
                     and 0 < r["completed"] <= r["offered_load"])
        if not ok_counts:
            fails.append(f"kv_serving offered/completed insane: {r}")
        if r.get("latency_source") != "requests" \
                or not r.get("latency_turns") \
                or r.get("latency_p99") is None:
            fails.append(f"kv_serving row lacks request latency: {r}")
        if ok_counts and not r.get("churn_events") and r.get("check_ok") \
                and r["completed"] != r["offered_load"]:
            fails.append(f"kv_serving dropped requests without churn: {r}")

    tr = doc.get("trace")
    if not isinstance(tr, dict) or "enabled" not in tr:
        fails.append(f"missing v6 top-level trace doc: {tr}")
    if "stragglers" not in doc:
        fails.append("missing v6 top-level stragglers list")

    if expect_trace:
        if not (tr and tr.get("enabled")):
            fails.append("expect_trace but the document says tracing was "
                         "off (run the sweep under REPRO_TRACE=1)")
        traced = [r for r in runs if r.get("trace_events")]
        if not traced:
            fails.append("expect_trace but no run row has trace_events > 0")
        elif not [r for r in traced if r.get("latency_p99") is not None
                  and r.get("latency_turns", 0) > 0]:
            fails.append(f"traced rows lack latency percentiles: "
                         f"{traced[:3]}")
        tf = tr.get("file") if tr else None
        if not tf:
            fails.append("expect_trace but the document names no trace "
                         "file")
        else:
            path = tf if os.path.isabs(tf) else os.path.join(doc_dir, tf)
            try:
                with open(path) as f:
                    evs = json.load(f).get("traceEvents")
                if not evs or not any(e.get("ph") == "X" for e in evs):
                    fails.append(f"{tf}: no duration events in traceEvents")
            except (OSError, ValueError) as e:
                fails.append(f"trace file {tf} unreadable: {e}")
    return fails
