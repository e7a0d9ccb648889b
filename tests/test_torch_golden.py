"""Golden simulator counters for the PyTorch port.

`src/repro_torch/golden/<workload>.json` holds the JAX reference's full
`counters_dict`, `events` and self-check verdict for the cells the port's
chip smoke run reproduces bitwise on the card, one file per workload:
kv_directory, reader_lock, producer_consumer, producer_consumer_mc,
worksteal and kv_serving.  Beside them:

* `worksteal.json` also holds the app drivers' records (`run_app` at the
  paper's 64 CUs: pagerank, sssp and mis under srsp and rsp), and
  `worksteal_apps.npz` their solutions;
* `kv_serving_traces.npz` holds the request traces the reference
  generated for the kv_serving cells (`traffic.trace.save_set`), which
  the port replays: its own float samplers agree with XLA's to a few
  ulps, not bit for bit.  It also holds the churn cells' traces, one of
  them drawn under `jax.threefry_partitionable(False)` (`_legacy`);
* `many.json` holds the replica engines' cells (`MANY_CELLS`): the
  reference's `run_fused_many`/`run_batched_many` at n=64 over seeds 4
  and 5 (lane 0 is the committed sweep's lane), each lane's counters,
  `events` and check verdict; its kv_serving cell replays the traces of
  `kv_serving_traces.npz`;
* `churn.json` holds the elastic engines' cells (`CHURN_CELLS`): crash
  red/green pairs (a crash fault with the recovery drain on, and with
  `faults.lease_never_expires`) at n=64 and at the n=4 pins of
  tests/test_churn.py and tests/test_kv_serving.py, a zero-churn cell
  and leave/join cells, each with its counters, check verdict,
  `done`/`completed`/`offered` where the check has them, recoveries and
  the final alive mask;
* `trace.npz` and `trace.json` hold the traced cells (`TRACE_CELLS`,
  srsp at ring capacity TRACE_CAP, and the trace report's demo cell):
  the npz each cell's decoded event columns (oldest first), `head`,
  `op_hist` and `turn_hist`; the json each cell's `trace.summary`,
  `export.trace_meta`, counters and check verdict, and the demo's whole
  Chrome-trace document, its text report and verdict.

Checks:

* tier-1: the golden makespans equal the committed `BENCH_workloads.json`
  rows (seed 4 at n=16 and n=64, kv_directory's n=256 `fuse_ab` cell,
  worksteal's n=64 seed 2 and smoke n=16 seed 1 rows); the golden traces
  are the reference's draws for their provenance;
* tier-1: `many.json`'s seed-4 lanes are the solo golden cells;
* slow: regenerating every file from the JAX package gives the
  committed cells exactly (`trace.*` included).

Regenerate the files with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write [WORKLOAD ...]

(`churn` among the names writes `churn.json`, `many` writes `many.json`,
`trace` writes `trace.npz` and `trace.json`).

A file whose cells come out unchanged is left as it is, provenance
included.
"""
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "src" / "repro_torch" / "golden"

# (scenario, n_agents, seed, engine).  kv_directory: the paper's 64-CU GPU
# for all three protocols at two seeds, plus the sweep's n=256 fused A/B
# cell.  The lock and queue workloads: the three protocols at n=64 and
# n=16, the batched and serial engines, and the scope_only staleness
# demo, whose check is red.
KV_CELLS = ([(s, 64, seed, "fused") for seed in (0, 4)
             for s in ("srsp", "rsp", "baseline")]
            + [("srsp", 256, 4, "fused")])
LOCK_QUEUE_CELLS = ([(s, 64, 4, "fused") for s in ("srsp", "rsp", "baseline")]
                    + [("srsp", 64, 4, "batched"), ("srsp", 16, 4, "serial")]
                    + [(s, 16, 4, "fused") for s in ("rsp", "baseline",
                                                     "scope_only")])
# worksteal is not vmappable, so the sweep runs it on the host-init path,
# whose last timed iteration is seed `iters`: seed 2 in the full sweep,
# seed 1 in the smoke sweep.  steal_only is the fifth scenario.
WS_CELLS = ([(s, 64, 2, "fused") for s in ("srsp", "rsp", "baseline",
                                           "scope_only", "steal_only")]
            + [("srsp", 64, 2, "batched"), ("srsp", 16, 1, "serial")]
            + [(s, 16, 1, "fused") for s in ("rsp", "baseline",
                                             "scope_only")])
# kv_serving: (..., traffic) with the TrafficConfig overrides named by
# TRAFFIC: the lock and queue grid at the default traffic, plus the
# committed sweep's serving-scale shape at full width
TRAFFIC = {"default": {},
           "serving": {"requests_per_agent": 256, "zipf_s": 1.2,
                       "gap_mean": 8.0, "burstiness": 4.0}}
KVS_FULL = ("srsp", 64, 4, "fused", "serving")
KVS_CELLS = [c + ("default",) for c in LOCK_QUEUE_CELLS] + [KVS_FULL]
CELLS = {"kv_directory": KV_CELLS, "reader_lock": LOCK_QUEUE_CELLS,
         "producer_consumer": LOCK_QUEUE_CELLS,
         "producer_consumer_mc": LOCK_QUEUE_CELLS,
         "worksteal": WS_CELLS, "kv_serving": KVS_CELLS}
# the app drivers at the paper's 64 CUs: (app, graph); run_app defaults
APP_WS = {"n_wgs": 64, "chunk_cap": 32, "n_chunks_max": 256}
APPS = [("pagerank", "collab_like"), ("sssp", "road_like"),
        ("mis", "router_like")]
APP_NODES, APP_ITERS = 8192, 2
APP_SCENARIOS = ("srsp", "rsp")
# the committed sweep's makespans at seed 4 (BENCH_workloads.json rows):
# {workload: {(scenario, n): makespan}}
BENCH_MAKESPANS = {
    "reader_lock": {("srsp", 16): 1028.0, ("rsp", 16): 3740.0,
                    ("baseline", 16): 1370.0, ("srsp", 64): 1220.0,
                    ("rsp", 64): 13180.0},
    "producer_consumer": {("srsp", 16): 7920.0, ("rsp", 16): 20312.0,
                          ("baseline", 16): 7225.0, ("srsp", 64): 31680.0,
                          ("rsp", 64): 228728.0},
    "producer_consumer_mc": {("srsp", 16): 3976.0, ("rsp", 16): 10552.0,
                             ("baseline", 16): 3825.0, ("srsp", 64): 4072.0,
                             ("rsp", 64): 31524.0},
}




def churn_cell(workload, n, seed, *, engine="batched_elastic", fault=None,
               recovery=True, churn=(), lease=0.0, build_kw=None,
               layout="partitionable"):
    """One churn cell, srsp: `fault` (name, victim, at) of `faults`,
    `recovery` False for `faults.lease_never_expires`, `churn` the
    (clock, agent, kind) events; kv_serving cells name the request trace
    they replay (`layout` "legacy": drawn under
    `jax.threefry_partitionable(False)`)."""
    build_kw = dict(build_kw or {})
    kind = ("green" if recovery else "red") if fault else \
        ("leave_join" if churn else "zero_churn")
    name = f"{workload} n={n} seed={seed} {engine} " + (
        f"{fault[0]}@{fault[1]}:{fault[2]} crash@{churn[0][0]} {kind}"
        if fault else kind) + ("" if layout == "partitionable" else
                               f" {layout}")
    cell = {"name": name, "workload": workload, "scenario": "srsp",
            "n_agents": n, "seed": seed, "engine": engine,
            "fault": list(fault) if fault else None,
            "recovery": recovery, "churn": [list(e) for e in churn],
            "lease": lease, "build_kw": build_kw, "layout": layout}
    if workload == "kv_serving":
        cell["trace"] = f"n{n}_seed{seed}_ppa{build_kw['pages_per_agent']}" \
            + ("" if layout == "partitionable" else f"_{layout}")
    return cell


def _crash_pair(workload, n, seed, fault, victim, at, evt, build_kw=None,
                layout="partitionable"):
    return [churn_cell(workload, n, seed, fault=(fault, victim, at),
                       recovery=rec, churn=[(evt, victim, "crash")],
                       build_kw=build_kw, layout=layout)
            for rec in (True, False)]


PPA1 = {"pages_per_agent": 1}
LEAVE_JOIN = [(50.0, 2, "leave"), (150.0, 2, "join")]
# the crash pairs: at n=64 (reader_lock's pin moves to at 30, CRASH 60 to
# stay red; worksteal's n=64 run stays green without recovery, so its
# pair pins what the reference gives), then the n=4 pins of
# tests/test_churn.py and tests/test_kv_serving.py, whose worksteal and
# kv_serving pairs are the sweep's churned rows (kv_serving's committed
# row is a legacy-layout trace's)
CHURN_CELLS = (
    _crash_pair("kv_directory", 64, 4, "crash_dirty", 2, 60.0, 120.0)
    + _crash_pair("reader_lock", 64, 4, "crash_holding_lock", 0, 30.0, 60.0)
    + _crash_pair("producer_consumer", 64, 4, "crash_dirty", 3, 12.0, 30.0)
    + _crash_pair("kv_serving", 64, 4, "crash_holding_lock", 0, 30.0, 180.0,
                  PPA1)
    + _crash_pair("worksteal", 64, 2, "crash_holding_lock", 0, 5.0, 60.0)
    + _crash_pair("worksteal", 4, 3, "crash_holding_lock", 0, 5.0, 400.0,
                  {"n_chunks_max": 12})
    + _crash_pair("reader_lock", 4, 3, "crash_holding_lock", 0, 100.0, 160.0)
    + _crash_pair("kv_directory", 4, 3, "crash_dirty", 2, 60.0, 120.0)
    + _crash_pair("producer_consumer", 4, 3, "crash_dirty", 3, 12.0, 30.0)
    + _crash_pair("kv_serving", 4, 3, "crash_holding_lock", 0, 30.0, 180.0,
                  PPA1)
    + _crash_pair("kv_serving", 4, 3, "crash_holding_lock", 0, 30.0, 180.0,
                  PPA1, layout="legacy")
    + [churn_cell("kv_directory", 64, 4),
       churn_cell("kv_directory", 64, 4, churn=LEAVE_JOIN)]
    + [churn_cell("kv_directory", 16, 4, engine=e, churn=LEAVE_JOIN)
       for e in ("serial_elastic", "batched_elastic")])


# the replica engines' cells: (workload, scenario, engine, fault of
# `faults` or None), each at n=64 over MANY_SEEDS, in one `run_*_many`
# call.  srsp fused for the five vmappable workloads (kv_serving at the
# default traffic), kv_directory's other protocols and its batched
# engine (the `fuse_ab` pair), and producer_consumer_mc's batched engine
# with and without `faults.serialize_remote` (the `remote_batch_ab` pair)
MANY_N, MANY_SEEDS = 64, (4, 5)
MANY_CELLS = (
    [(w, "srsp", "fused", None) for w in (
        "kv_directory", "reader_lock", "producer_consumer",
        "producer_consumer_mc", "kv_serving")]
    + [("kv_directory", "srsp", "batched", None)]
    + [("kv_directory", s, "fused", None) for s in ("rsp", "baseline")]
    + [("producer_consumer_mc", "srsp", "batched", f)
       for f in (None, "serialize_remote")])


def many_trace_cells() -> list:
    """The kv_serving cells whose traces the replica cells replay."""
    return [("srsp", MANY_N, seed, "fused", "default") for seed in MANY_SEEDS
            if ("srsp", MANY_N, seed, "fused", "default") not in KVS_CELLS]


def many_from_jax(cells=None) -> dict:
    """Run every replica cell (or `cells`) through the JAX reference's
    `run_*_many` on freshly built states (the reference donates them)."""
    import jax
    import jax.numpy as jnp
    from repro import workloads
    from repro.core import protocol as P
    from repro.workloads import faults, harness

    out = []
    for workload, scenario, engine, fault in cells or MANY_CELLS:
        mod = workloads.get(workload)
        proto = None if fault is None \
            else getattr(faults, fault)(P.get_protocol(scenario))
        bench = mod.build(scenario, MANY_N, seed=MANY_SEEDS[0], proto=proto)
        states = jax.vmap(lambda s: mod.init_state(bench.wl, s))(
            jnp.asarray(MANY_SEEDS, jnp.int32))
        extra = {}
        if workload == "kv_serving":
            # each replica's streams are its seed's trace, drawn alone
            for k, seed in enumerate(MANY_SEEDS):
                solo = mod.init_state(bench.wl, seed).streams
                for a, b in zip(jax.tree.leaves(solo),
                                jax.tree.leaves(states.streams)):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b)[k])
            extra = {"traffic": "default",
                     "traces": [trace_name(MANY_N, s, "default")
                                for s in MANY_SEEDS]}
        final = harness.runner_many(engine)(bench.wl, states)
        lanes = []
        for k, seed in enumerate(MANY_SEEDS):
            lane = jax.tree.map(lambda x: x[k], final)
            check = mod.self_check(bench.wl, lane)
            lanes.append({"seed": seed,
                          "counters": harness.counters_dict(lane.store),
                          "events": check["events"],
                          "check_ok": bool(check["ok"]),
                          "check_fails": int(check["check_fails"]),
                          **({"completed": check["completed"]}
                             if "completed" in check else {})})
        out.append({"workload": workload, "scenario": scenario,
                    "n_agents": MANY_N, "seeds": list(MANY_SEEDS),
                    "engine": engine, "fault": fault, **extra,
                    "lanes": lanes})
        jax.clear_caches()
    return {"cells": out}


# the traced cells: (workload, n_agents, seed, engine, churn), srsp at ring
# capacity TRACE_CAP.  The six workloads fused at n=16; kv_directory
# under the serial, batched and batched elastic engines (leave/join) at
# n=16; the six at n=64 (the cells of each golden file that the card
# runs), and kv_directory n=64 seed 5 (the replica cell's second lane).
# kv_serving replays the reference's trace of its (n, seed).
TRACE_CAP = 4096
TRACE_WORKLOADS = ("kv_directory", "reader_lock", "producer_consumer",
                   "producer_consumer_mc", "worksteal", "kv_serving")
TRACE_CELLS = (
    [(w, 16, 4, "fused", ()) for w in TRACE_WORKLOADS]
    + [("kv_directory", 16, 4, e, ()) for e in ("serial", "batched")]
    + [("kv_directory", 16, 4, "batched_elastic", tuple(LEAVE_JOIN))]
    + [(w, 64, 2 if w == "worksteal" else 4, "fused", ())
       for w in TRACE_WORKLOADS]
    + [("kv_directory", 64, 5, "fused", ())])
TRACE_COLS = ("clock", "agent", "kind", "scope", "addr", "cycles", "outcome")
TRACE_NPZ = GOLDEN_DIR / "trace.npz"
TRACE_JSON = GOLDEN_DIR / "trace.json"


def trace_cell_name(cell) -> str:
    w, n, seed, engine, churn = cell
    return f"{w} n={n} seed={seed} {engine}" + (" leave_join" if churn
                                                else "")


def trace_arrays(name: str, dec: dict, tl) -> dict:
    """A traced cell's npz arrays: decoded columns, head and histograms."""
    out = {f"{name}/{k}": np.asarray(v) for k, v in dec["events"].items()}
    out[f"{name}/head"] = np.asarray(tl.head)
    out[f"{name}/op_hist"] = np.asarray(tl.op_hist)
    out[f"{name}/turn_hist"] = np.asarray(tl.turn_hist)
    return out


def trace_from_jax(cells=None, demo=True) -> tuple:
    """Every traced cell (or `cells`) and the report demo through the JAX
    reference: (json doc, npz arrays)."""
    import jax
    from repro import workloads
    from repro.core import protocol as P
    from repro.obs import export, trace as T
    from repro.workloads import faults, harness

    docs, arrays = [], {}
    for cell in TRACE_CELLS if cells is None else cells:
        w, n, seed, engine, churn = cell
        name = trace_cell_name(cell)
        bench = workloads.get(w).build("srsp", n, seed=seed)
        elastic = engine.endswith("_elastic")
        if elastic:
            bench = harness.make_elastic(bench, [tuple(e) for e in churn])
        final = harness.runner(engine)(
            bench.wl, T.with_trace(bench.state, TRACE_CAP), *bench.ops)
        store = final.s.store if elastic else final.store
        check = bench.check(final)
        arrays.update(trace_arrays(name, export.decode(store.trace),
                                   store.trace))
        docs.append({"name": name, "workload": w, "n_agents": n,
                     "seed": seed, "engine": engine,
                     "churn": [list(e) for e in churn],
                     **({"trace": trace_name(n, seed, "default")}
                        if w == "kv_serving" else {}),
                     "summary": T.summary(store),
                     "meta": export.trace_meta(store, label=name),
                     "counters": harness.counters_dict(store),
                     "events": int(check["events"]),
                     "check_ok": bool(check["ok"]),
                     "check_fails": int(check["check_fails"])})
        jax.clear_caches()
    out = {"cap": TRACE_CAP, "cells": docs}
    if demo:
        # repro.obs.report's demo cell, as its `--demo` runs it
        victim, at, evt = 0, 5.0, 400.0
        proto = faults.crash_holding_lock(P.get_protocol("srsp"), victim,
                                          at)
        bench = workloads.get("worksteal").build("srsp", 4, seed=3,
                                                 proto=proto, n_chunks_max=12)
        eb = harness.make_elastic(bench, events=[(evt, victim, "crash")])
        fin = harness.run_batched_elastic(
            eb.wl, T.with_trace(eb.state, TRACE_CAP), *eb.ops)
        store = fin.s.store
        label = "worksteal/srsp/n=4/batched_elastic+crash"
        doc = export.chrome_trace(
            export.decode(store.trace), n_agents=4,
            meta=export.trace_meta(store, label=label))
        doc = json.loads(json.dumps(doc))
        arrays.update(trace_arrays("demo", export.decode(store.trace),
                                   store.trace))
        res = eb.check(fin)
        out["demo"] = {"label": label, "doc": doc,
                       "report": export.text_report(doc),
                       "check_ok": bool(res["ok"]),
                       "recovered": float(np.sum(np.asarray(
                           store.counters.recoveries)))}
        jax.clear_caches()
    return out, arrays


def golden_path(workload: str) -> pathlib.Path:
    return GOLDEN_DIR / f"{workload}.json"


TRACES_PATH = GOLDEN_DIR / "kv_serving_traces.npz"
APPS_PATH = GOLDEN_DIR / "worksteal_apps.npz"


def trace_name(n: int, seed: int, traffic: str) -> str:
    return f"n{n}_seed{seed}_{traffic}"


def jax_traces(cells=None) -> dict:
    """The reference's request trace of every kv_serving cell, as
    `traffic.trace.save_set` takes them (the installed JAX's PRNG
    layout)."""
    from repro.traffic import trace as JT
    from repro.workloads import kv_serving

    out = {}
    for _, n, seed, _, traffic in cells or CELLS["kv_serving"]:
        cfg = kv_serving.Config(n_agents=n, traffic=dataclasses.replace(
            kv_serving.S.TrafficConfig(), **TRAFFIC[traffic]))
        out[trace_name(n, seed, traffic)] = {
            "tr": JT.generate(cfg.traffic, n, cfg.n_pages, seed),
            "cfg": cfg.traffic, "n_agents": n, "n_keys": cfg.n_pages,
            "seed": seed}
    return out


def jax_traces_names(cells) -> list:
    """The trace names of kv_serving cells, as `jax_traces` keys them."""
    return [trace_name(n, seed, traffic) for _, n, seed, _, traffic in cells]


def _layout(layout: str):
    import jax
    return contextlib.nullcontext() if layout == "partitionable" \
        else jax.threefry_partitionable(False)


def jax_churn_traces(cells=None) -> dict:
    """The reference's request trace of every kv_serving churn cell."""
    from repro.traffic import trace as JT
    from repro.workloads import kv_serving

    out = {}
    for c in cells or CHURN_CELLS:
        if "trace" not in c or c["trace"] in out:
            continue
        n, seed = c["n_agents"], c["seed"]
        cfg = kv_serving.Config(n_agents=n, **c["build_kw"])
        with _layout(c["layout"]):
            tr = JT.generate(cfg.traffic, n, cfg.n_pages, seed)
        out[c["trace"]] = {"tr": tr, "cfg": cfg.traffic, "n_agents": n,
                           "n_keys": cfg.n_pages, "seed": seed}
    return out


def churn_from_jax(cells=None) -> dict:
    """Run every churn cell (or `cells`) through the JAX reference's
    elastic engines."""
    import jax
    from repro import workloads
    from repro.core import protocol as P
    from repro.workloads import faults, harness

    out = []
    for c in cells or CHURN_CELLS:
        proto = P.get_protocol(c["scenario"])
        if c["fault"]:
            name, victim, at = c["fault"]
            proto = getattr(faults, name)(proto, victim, at)
        if not c["recovery"]:
            proto = faults.lease_never_expires(proto)
        with _layout(c["layout"]):
            bench = workloads.get(c["workload"]).build(
                c["scenario"], c["n_agents"], seed=c["seed"], proto=proto,
                **c["build_kw"])
        eb = harness.make_elastic(bench, [tuple(e) for e in c["churn"]],
                                  c["lease"])
        final = harness.runner(c["engine"])(eb.wl, eb.state, *eb.ops)
        check = eb.check(final)
        out.append({**c, "counters": harness.counters_dict(final.s.store),
                    "events": check["events"],
                    "check_ok": bool(check["ok"]),
                    "check_fails": int(check["check_fails"]),
                    **{k: check.get(k) for k in ("done", "completed",
                                                 "offered")},
                    "recoveries": float(np.sum(np.asarray(
                        final.s.store.counters.recoveries))),
                    "alive": np.asarray(final.alive).tolist()})
        jax.clear_caches()
    return {"cells": out}


def jax_apps() -> tuple:
    """The app drivers through the JAX reference: (records, solutions)."""
    from repro.data import graphs
    from repro.workloads import worksteal

    ws = worksteal.WSConfig(**APP_WS)
    recs, sols = [], {}
    for app, graph in APPS:
        g = getattr(graphs, graph)(APP_NODES)
        for scenario in APP_SCENARIOS:
            r = worksteal.run_app(app, g, scenario, ws, max_iters=APP_ITERS)
            name = f"{app}_{scenario}"
            recs.append({"app": app, "scenario": scenario, "graph": graph,
                         "n_nodes": APP_NODES, "max_iters": APP_ITERS,
                         "ws": APP_WS, "engine": "batched",
                         "counters": r.counters,
                         "proc_errors": int(r.proc_errors),
                         "iterations": int(r.iterations),
                         "solution": name})
            sols[name] = np.asarray(r.solution)
    return recs, sols


def golden_from_jax(workload: str, cells=None) -> dict:
    """Run every golden cell of `workload` (or `cells`) through the JAX
    reference."""
    from repro import workloads
    from repro.workloads import harness

    mod = workloads.get(workload)
    out = []
    for cell in cells or CELLS[workload]:
        scenario, n, seed, engine = cell[:4]
        extra, kw = {}, {}
        if workload == "kv_serving":
            traffic = cell[4]
            kw["traffic"] = dataclasses.replace(
                mod.S.TrafficConfig(), **TRAFFIC[traffic])
            extra = {"traffic": traffic,
                     "trace": trace_name(n, seed, traffic)}
        bench = mod.build(scenario, n, seed=seed, **kw)
        final = harness.runner(engine)(bench.wl, bench.state, *bench.ops)
        check = bench.check(final)
        out.append({"scenario": scenario, "n_agents": n, "seed": seed,
                    "engine": engine, **extra,
                    "counters": harness.counters_dict(final.store),
                    "events": check["events"],
                    "check_ok": bool(check["ok"]),
                    "check_fails": int(check["check_fails"])})
    return {"cells": out}


def _provenance(workload: str) -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    if workload == "trace":
        import jax
        return {"reference": "repro (JAX) harness.runner(engine) on "
                             "obs.trace.with_trace(state, cap), srsp, "
                             "CPU backend, kernel_mode ref; the demo is "
                             "repro.obs.report's --demo cell",
                "jax_commit": commit,
                "prng_layout": "kv_serving traces: jax_threefry_"
                               "partitionable=True (the installed JAX "
                               f"{jax.__version__}'s default)",
                "generator": "tests/test_torch_golden.py --write trace"}
    if workload == "many":
        import jax
        return {"reference": "repro (JAX) harness.runner_many(engine) on "
                             "jax.vmap(init_state) over the seeds, "
                             "faults.<fault> where named, CPU backend, "
                             "kernel_mode ref",
                "jax_commit": commit,
                "prng_layout": "kv_serving traces: jax_threefry_"
                               "partitionable=True (the installed JAX "
                               f"{jax.__version__}'s default)",
                "generator": "tests/test_torch_golden.py --write many"}
    if workload == "churn":
        import jax
        return {"reference": "repro (JAX) harness.make_elastic + "
                             "harness.runner(engine), srsp, faults.<fault>"
                             " (+ faults.lease_never_expires for red "
                             "cells), CPU backend, kernel_mode ref",
                "jax_commit": commit,
                "engine": sorted({c["engine"] for c in CHURN_CELLS}),
                "prng_layout": "kv_serving traces: jax_threefry_"
                               "partitionable=True (the installed JAX "
                               f"{jax.__version__}'s default), except the "
                               "cells with layout 'legacy', drawn under "
                               "jax.threefry_partitionable(False)",
                "generator": "tests/test_torch_golden.py --write churn"}
    engines = sorted({c[3] for c in CELLS[workload]})
    prov = {"reference": f"repro (JAX) {workload}, harness.runner(engine), "
                         "CPU backend, kernel_mode ref",
            "jax_commit": commit,
            "engine": engines[0] if len(engines) == 1 else engines,
            "generator": "tests/test_torch_golden.py --write"}
    if workload in ("worksteal", "kv_serving"):
        import jax
        prov["prng_layout"] = (
            "jax_threefry_partitionable="
            f"{bool(jax.config.jax_threefry_partitionable)} (the installed "
            f"JAX {jax.__version__}'s default)")
    return prov


def _golden(workload: str) -> dict:
    return json.loads(golden_path(workload).read_text())


def _cell(doc, scenario, n, seed, engine="fused"):
    return next(c for c in doc["cells"] if (
        c["scenario"], c["n_agents"], c["seed"], c["engine"])
        == (scenario, n, seed, engine) and c.get("traffic") != "serving")


def _bench_rows(workload):
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    return {(r["scenario"], r["n_agents"]): r for r in bench["runs"]
            if r["workload"] == workload and r["engine"] == "batched"}


def test_golden_makespans_match_committed_bench():
    doc = _golden("kv_directory")
    rows = _bench_rows("kv_directory")
    for scenario in ("srsp", "rsp", "baseline"):
        got = _cell(doc, scenario, 64, 4)
        assert got["counters"] == rows[(scenario, 64)]["counters"], scenario
        assert got["events"] == rows[(scenario, 64)]["events"] == 544
        assert got["check_ok"]
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    fuse = next(r for r in bench["fuse_ab"]
                if r["n_agents"] == 256 and r["engine"] == "fused")
    assert _cell(doc, "srsp", 256, 4)["counters"]["makespan"] \
        == fuse["makespan"] == 2031.0
    seed0 = [_cell(doc, s, 64, 0)["counters"]["makespan"]
             for s in ("srsp", "rsp", "baseline")]
    assert seed0 == [1328.0, 13790.0, 1405.0]
    assert {(c["scenario"], c["n_agents"], c["seed"], c["engine"])
            for c in doc["cells"]} == set(KV_CELLS)


@pytest.mark.parametrize("workload", sorted(BENCH_MAKESPANS))
def test_lock_queue_golden_matches_committed_bench(workload):
    """Every golden cell with a committed sweep row (seed 4, the batched
    engine's row; the engines' counters are equal) has that row's
    counters, events and verdict, and the makespans are the sweep's.  A
    row's `check_fails` sums the sweep's two replicas (seeds 4 and 5), so
    it is not compared."""
    doc = _golden(workload)
    assert {(c["scenario"], c["n_agents"], c["seed"], c["engine"])
            for c in doc["cells"]} == set(LOCK_QUEUE_CELLS)
    rows = _bench_rows(workload)
    for c in doc["cells"]:
        row = rows[(c["scenario"], c["n_agents"])]
        ctx = (workload, c["scenario"], c["n_agents"], c["engine"])
        assert c["counters"] == row["counters"], ctx
        assert (c["events"], c["check_ok"]) \
            == (row["events"], row["check_ok"]), ctx
    for (scenario, n), makespan in BENCH_MAKESPANS[workload].items():
        engine = "serial" if (scenario, n) == ("srsp", 16) else "fused"
        assert _cell(doc, scenario, n, 4, engine)["counters"]["makespan"] \
            == makespan, (scenario, n)
    assert not _cell(doc, "scope_only", 16, 4)["check_ok"]
    assert all(c["check_ok"] for c in doc["cells"]
               if c["scenario"] != "scope_only")


# the committed worksteal rows: {(doc, scenario, n): makespan}; worksteal
# runs one replica, so a row's counters are the cell's
WS_MAKESPANS = {
    ("BENCH_workloads.json", "srsp", 64): 2235.5,
    ("BENCH_workloads.json", "rsp", 64): 7100.5,
    ("BENCH_workloads.json", "baseline", 64): 24568.5,
    ("BENCH_workloads.json", "scope_only", 64): 15384.0,
    ("BENCH_workloads.smoke.json", "srsp", 16): 1336.0,
    ("BENCH_workloads.smoke.json", "rsp", 16): 2481.0,
    ("BENCH_workloads.smoke.json", "baseline", 16): 5951.0,
    ("BENCH_workloads.smoke.json", "scope_only", 16): 3678.0,
}


def test_worksteal_golden_matches_committed_bench():
    doc = _golden("worksteal")
    assert {(c["scenario"], c["n_agents"], c["seed"], c["engine"])
            for c in doc["cells"]} == set(WS_CELLS)
    for (bench_doc, scenario, n), makespan in WS_MAKESPANS.items():
        bench = json.loads((ROOT / bench_doc).read_text())
        row = next(r for r in bench["runs"] if (
            r["workload"], r["scenario"], r["n_agents"], r["engine"])
            == ("worksteal", scenario, n, "batched"))
        seed = 2 if n == 64 else 1
        for c in doc["cells"]:
            if (c["scenario"], c["n_agents"], c["seed"]) == (scenario, n,
                                                             seed):
                ctx = (scenario, n, c["engine"])
                assert c["counters"] == row["counters"], ctx
                assert c["counters"]["makespan"] == makespan, ctx
                assert (c["events"], c["check_ok"]) \
                    == (row["events"], row["check_ok"]), ctx
    assert all(c["check_ok"] and c["check_fails"] == 0
               for c in doc["cells"])
    assert _cell(doc, "steal_only", 64, 2)["counters"]["steals"] > 0


def test_worksteal_app_golden_solutions_are_the_oracle():
    """Every app record is complete and its solution is the
    single-thread oracle's (sssp/mis exactly, pagerank within 1e-5)."""
    pytest.importorskip("torch")
    from repro_torch.data import graphs
    from repro_torch.workloads import worksteal

    doc = _golden("worksteal")
    assert [(a["app"], a["scenario"]) for a in doc["apps"]] \
        == [(app, s) for app, _ in APPS for s in APP_SCENARIOS]
    with np.load(APPS_PATH) as z:
        sols = {k: z[k] for k in z.files}
    assert sorted(sols) == sorted(a["solution"] for a in doc["apps"])
    for a in doc["apps"]:
        assert (a["proc_errors"], a["ws"], a["max_iters"]) \
            == (0, APP_WS, APP_ITERS)
        g = getattr(graphs, a["graph"])(a["n_nodes"])
        ref = worksteal.reference_solution(a["app"], g, a["max_iters"])
        got = sols[a["solution"]]
        assert got.dtype == ref.dtype and got.shape == (g.n,)
        if a["app"] == "pagerank":
            np.testing.assert_allclose(got, ref, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, ref)


def test_kv_serving_golden_cells():
    doc = _golden("kv_serving")
    assert [(c["scenario"], c["n_agents"], c["seed"], c["engine"],
             c["traffic"]) for c in doc["cells"]] == KVS_CELLS
    for c in doc["cells"]:
        assert c["trace"] == trace_name(c["n_agents"], c["seed"],
                                        c["traffic"])
        assert c["check_ok"] == (c["scenario"] != "scope_only"), c
    fused, batched = (_cell(doc, "srsp", 64, 4, e) for e in ("fused",
                                                             "batched"))
    assert fused["counters"] == batched["counters"]
    full = doc["cells"][-1]
    assert full["events"] == 64 * TRAFFIC["serving"]["requests_per_agent"]


def test_kv_serving_golden_traces_are_jax_and_held_by_the_port():
    """Each stored trace is the JAX draw of its provenance, bit for bit,
    and the port's own draw is held to it (`trace.compare`); a churn
    cell's legacy-layout trace is the JAX draw under that layout (the
    port draws the installed default's only)."""
    pytest.importorskip("torch")
    from repro.traffic import trace as JT
    from repro_torch.traffic import trace as TT

    stored = TT.load_set(str(TRACES_PATH), "cpu")
    layouts = {c["trace"]: c["layout"] for c in CHURN_CELLS
               if "trace" in c}
    assert sorted(stored) == sorted({c["trace"] for c in
                                     _golden("kv_serving")["cells"]}
                                    | set(layouts)
                                    | set(jax_traces_names(
                                        many_trace_cells())))
    for name, (tr, meta) in stored.items():
        cfg, n = meta["config"], meta["n_agents"]
        layout = layouts.get(name, "partitionable")
        with _layout(layout):
            want = JT.generate(cfg, n, meta["n_keys"], meta["seed"])
        for a, b in zip(tr, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if layout != "partitionable":
            continue
        got = TT.generate(cfg, n, meta["n_keys"], meta["seed"], "cpu")
        res = TT.compare(got, tr, n, cfg.requests_per_agent)
        print(name, res)
        assert res["held"], (name, res)


@pytest.mark.slow
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_golden_regenerates_from_jax(workload):
    """Every cell but kv_serving's full-width one (its own slow test)."""
    cells = [c for c in CELLS[workload] if c != KVS_FULL]
    want = [c for c in _golden(workload)["cells"]
            if c.get("traffic") != KVS_FULL[4]]
    assert golden_from_jax(workload, cells)["cells"] == want


@pytest.mark.slow
def test_kv_serving_full_width_golden_regenerates_from_jax():
    got = golden_from_jax("kv_serving", [KVS_FULL])["cells"]
    assert got == _golden("kv_serving")["cells"][-1:]
    want = jax_traces([KVS_FULL])
    stored = np.load(TRACES_PATH)
    for name, t in want.items():
        for f in ("arrival", "key", "kind", "agent"):
            np.testing.assert_array_equal(stored[f"{name}/{f}"],
                                          np.asarray(getattr(t["tr"], f)))


@pytest.mark.slow
def test_worksteal_apps_golden_regenerate_from_jax():
    recs, sols = jax_apps()
    assert recs == _golden("worksteal")["apps"]
    with np.load(APPS_PATH) as z:
        for name, sol in sols.items():
            np.testing.assert_array_equal(z[name], sol)


def test_many_golden_lanes_match_the_solo_goldens():
    """`many.json` holds MANY_CELLS at n=64 over MANY_SEEDS; its seed-4
    lanes equal the solo golden cells of the same engine where one
    exists (a replica lane is its seed's solo run), its kv_serving cell
    names the traces it replays, and the `remote_batch_ab` pair's lanes
    are equal (DESIGN.md §9)."""
    doc = _golden("many")
    assert [(c["workload"], c["scenario"], c["engine"], c["fault"])
            for c in doc["cells"]] == MANY_CELLS
    solo_held = 0
    for c in doc["cells"]:
        assert (c["n_agents"], c["seeds"]) == (MANY_N, list(MANY_SEEDS))
        assert [lane["seed"] for lane in c["lanes"]] == list(MANY_SEEDS)
        assert all(lane["check_ok"] for lane in c["lanes"]), c
        if c["workload"] == "kv_serving":
            assert c["traces"] == jax_traces_names(
                [("srsp", MANY_N, s, "fused", "default")
                 for s in MANY_SEEDS])
        solo = [g for g in _golden(c["workload"])["cells"]
                if (g["scenario"], g["n_agents"], g["seed"], g["engine"],
                    g.get("traffic", "default"))
                == (c["scenario"], MANY_N, MANY_SEEDS[0], c["engine"],
                    "default")]
        if solo and c["fault"] is None:
            lane = c["lanes"][0]
            assert (lane["counters"], lane["events"], lane["check_ok"],
                    lane["check_fails"]) == (
                solo[0]["counters"], solo[0]["events"], solo[0]["check_ok"],
                solo[0]["check_fails"]), c
            solo_held += 1
    assert solo_held == 8
    pair = [c["lanes"] for c in doc["cells"]
            if (c["workload"], c["engine"]) == ("producer_consumer_mc",
                                                "batched")]
    assert len(pair) == 2 and pair[0] == pair[1]


@pytest.mark.slow
def test_many_golden_regenerates_from_jax():
    assert many_from_jax()["cells"] == _golden("many")["cells"]
    stored = np.load(TRACES_PATH)
    for name, t in jax_traces(many_trace_cells()).items():
        for f in ("arrival", "key", "kind", "agent"):
            np.testing.assert_array_equal(stored[f"{name}/{f}"],
                                          np.asarray(getattr(t["tr"], f)))


@pytest.mark.slow
def test_churn_golden_regenerates_from_jax():
    assert churn_from_jax()["cells"] == _golden("churn")["cells"]
    stored = np.load(TRACES_PATH)
    for name, t in jax_churn_traces().items():
        for f in ("arrival", "key", "kind", "agent"):
            np.testing.assert_array_equal(stored[f"{name}/{f}"],
                                          np.asarray(getattr(t["tr"], f)))


@pytest.mark.slow
def test_trace_golden_regenerates_from_jax():
    doc, arrays = trace_from_jax()
    old_doc, old_arrays = _trace_golden()
    assert doc == old_doc
    assert _same_arrays(arrays, old_arrays)


def _save_traces() -> None:
    """Every golden trace, the kv_serving cells' and the churn cells'."""
    from repro_torch.traffic import trace as TT
    TT.save_set(str(TRACES_PATH), {**jax_traces(), **jax_churn_traces(),
                                   **jax_traces(many_trace_cells())})


def _trace_golden() -> tuple:
    """(json doc without provenance, npz arrays) as committed."""
    doc = json.loads(TRACE_JSON.read_text())
    doc.pop("provenance", None)
    with np.load(TRACE_NPZ) as z:
        return doc, {k: z[k] for k in z.files}


def _same_arrays(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def write_trace() -> None:
    doc, arrays = trace_from_jax()
    if TRACE_JSON.exists() and TRACE_NPZ.exists():
        old_doc, old_arrays = _trace_golden()
        if old_doc == doc and _same_arrays(old_arrays, arrays):
            print(f"{TRACE_JSON}, {TRACE_NPZ}: unchanged")
            return
    np.savez_compressed(TRACE_NPZ, **arrays)
    TRACE_JSON.write_text(json.dumps({"provenance": _provenance("trace"),
                                      **doc}, indent=1) + "\n")
    print(f"wrote {TRACE_JSON}, {TRACE_NPZ}")


def write(workload: str) -> None:
    if workload == "trace":
        return write_trace()
    path = golden_path(workload)
    doc = churn_from_jax() if workload == "churn" \
        else many_from_jax() if workload == "many" \
        else golden_from_jax(workload)
    if workload == "worksteal":
        doc["apps"], sols = jax_apps()
    if path.exists() and {k: v for k, v in _golden(workload).items()
                          if k != "provenance"} == doc:
        print(f"{path}: unchanged")
        return
    if workload == "worksteal":
        np.savez_compressed(APPS_PATH, **sols)
    if workload in ("kv_serving", "churn", "many"):
        _save_traces()
    path.write_text(json.dumps({"provenance": _provenance(workload), **doc},
                               indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write "
                 "[WORKLOAD ...]")
    names = [a for a in sys.argv[1:] if a != "--write"] \
        or sorted(CELLS) + ["churn", "many", "trace"]
    for name in names:
        write(name)
