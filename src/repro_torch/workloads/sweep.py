"""One cell of the workload sweep (`repro.workloads.sweep`).

`run_cell` runs one (workload, scenario, n_agents, seed, engine) cell: a
warm-up run (unless `warmup=False`), then a timed run from a fresh
state.  It returns the sweep row's fields for that seed.  The elastic
engines take a churn schedule (`events`, `lease`) and a derived
protocol (`proto`, e.g. a crash fault of `faults`).  `run_churned_cell`
runs one of the sweep's two churned robustness cells
(`measure_churned_cell`, `measure_churned_serving`).
`run_vmapped_cell` runs a cell's replicas, one a seed, in one replica
engine call (`measure_vmapped`); `run_fuse_ab` and `run_remote_batch_ab`
give the sweep's two replica A/B pairs (`measure_fuse`,
`measure_remote_batch`), and `run_serving_scale` its serving-scale cell
(64 replicas of full-width kv_serving).  As a command:

    PYTHONPATH=src python3 -m repro_torch.workloads.sweep --serving-scale 64 \
        [--out PATH]
    PYTHONPATH=src python3 -m repro_torch.workloads.sweep --cell kv_directory \
        --replicas 1 2 4 8 16 [--out PATH]

the first runs the serving-scale cell (srsp, fused, n=64) and prints its
row as one JSON line; the second runs one replica cell (srsp, fused,
n=64) at each replica count (seeds 4, 5, ...), a JSON line a row.  The
full grid is not ported yet.

Every row carries the latency and trace columns (`latency_p50/p95/p99`,
`latency_turns`, `trace_events`, `trace_dropped`, `latency_source`):
conservative upper-edge percentiles of the per-turn modeled-latency
histogram and the event ring's occupancy when the run is traced
(`REPRO_TRACE=1`, or a state given `obs.trace.with_trace`), None/0
otherwise; kv_serving rows take theirs from the per-request latency
histogram, pooled over replicas, traced or not.  Tracing charges no
cycles, so every other column is bitwise the same either way.

The command runs each cell under a `CellWatchdog` (a heartbeat file, a
straggler flag over the cells' wall times, and an interrupt when one
cell outlasts `REPRO_WATCHDOG_S` seconds, default 600;
`REPRO_NO_WATCHDOG=1` turns it off) and inside a
`torch.profiler.record_function("cell:<label>")`.  `--out` writes
{"rows", "stragglers"}; `--trace-out PATH` exports the first traced srsp
row's lane 0 as Perfetto-loadable JSON (`obs.export.write_trace`), with
the stragglers as instants.
"""
from __future__ import annotations

import _thread
import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import workloads
from repro_torch.core import protocol as P
from repro_torch.kernels import common
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics
from repro_torch.obs import trace as T
from repro_torch.runtime import fault as rtfault
from repro_torch.traffic import samplers
from repro_torch.workloads import faults, harness

# the sweep's churned cells (schema v5 and v8): srsp, a die-holding-lock
# crash of agent 0 at clock `at`, its CRASH event at `evt`, lease 0, on
# the batched elastic engine (the numbers tests/test_churn.py and
# tests/test_kv_serving.py pin)
CHURNED = {
    "worksteal": dict(n_agents=4, seed=3, victim=0, at=5.0, evt=400.0,
                      build_kw={"n_chunks_max": 12}),
    "kv_serving": dict(n_agents=4, seed=3, victim=0, at=30.0, evt=180.0,
                       build_kw={"pages_per_agent": 1}),
}


# the latency and trace columns every row carries
LATENCY_KEYS = ("latency_p50", "latency_p95", "latency_p99", "latency_turns",
                "trace_events", "trace_dropped", "latency_source")
# per-cell hang budget of the watchdog (seconds)
WATCHDOG_S = float(os.environ.get("REPRO_WATCHDOG_S", "600"))


class CellWatchdog:
    """Per-cell hang watchdog, `runtime/fault.py` wired into the sweep.

    A `Heartbeat` file records liveness for outside watchers, a
    `StepTimer` flags straggler cells (z-score over the cells so far),
    and a `threading.Timer` interrupts the main thread if one cell
    outlasts WATCHDOG_S, so a wedged run fails loudly instead of
    hanging.  `REPRO_NO_WATCHDOG=1` turns all of it off."""

    def __init__(self, heartbeat_path: str = None):
        if heartbeat_path is None:
            # a per-process path: a fixed name would alias concurrent
            # sweeps, and a crashed run's stale file the next one
            heartbeat_path = os.path.join(
                tempfile.gettempdir(), f"sweep_heartbeat.{os.getpid()}")
        self.enabled = os.environ.get("REPRO_NO_WATCHDOG", "0") != "1"
        self.timer = rtfault.StepTimer(window=50, z_thresh=3.0)
        self.hb = rtfault.Heartbeat(heartbeat_path, interval=5.0)
        self.cells = 0
        self.label = "?"
        self.stragglers = []   # [{cell, wall_s}]
        self._t = None

    def start(self, label: str):
        self.label = label
        if not self.enabled:
            return
        self.timer.start()
        self.hb.beat(self.cells)
        self._t = threading.Timer(WATCHDOG_S, self._fire)
        self._t.daemon = True
        self._t.start()

    def _fire(self):
        print(f"WATCHDOG: cell {self.label} exceeded {WATCHDOG_S:.0f}s "
              f"budget — interrupting the sweep", file=sys.stderr,
              flush=True)
        _thread.interrupt_main()

    def stop(self):
        self.cells += 1
        if not self.enabled:
            return
        self._t.cancel()
        dt, straggler = self.timer.stop()
        if straggler:
            self.stragglers.append({"cell": self.label,
                                    "wall_s": round(dt, 2)})
            print(f"watchdog: straggler cell {self.label} ({dt:.1f}s, "
                  f"z>{self.timer.z_thresh})", flush=True)

    def close(self):
        """End of the sweep: cancel a pending interrupt, remove the
        heartbeat file."""
        if self._t is not None:
            self._t.cancel()
        self.hb.stop()


def _request_latency(row: dict, checks) -> None:
    """Trace-driven rows (kv_serving) take their latency percentiles
    from the per-request completion histogram, which the state carries
    traced or not, pooled over replicas; other rows keep the per-turn
    trace source when traced."""
    if checks and "latency_hist" in checks[0]:
        pooled = np.sum([np.asarray(c["latency_hist"], np.int64)
                         for c in checks], axis=0)
        lat = metrics.summarize(pooled)
        row.update({"latency_p50": lat["p50"], "latency_p95": lat["p95"],
                    "latency_p99": lat["p99"],
                    "latency_turns": lat["count"],
                    "latency_source": "requests"})
    else:
        row["latency_source"] = "turns" if row.get("trace_events") \
            else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, scenario: str, n_agents: int, seed: int,
             engine: str, device=None, build_kw=None, trace=None,
             events=(), lease=0.0, proto: P.Protocol = None,
             warmup: bool = True) -> dict:
    """Sweep-row fields of one cell: makespan, counters, check_ok,
    check_fails, events, and `steady_s`, the wall time of the timed run,
    ending in a device synchronisation.  `build_kw`
    overrides workload-config fields (the serving cells' traffic, as the
    reference's `measure_vmapped` takes it).  `trace`, a kv_serving
    request trace the reference generated (`traffic.trace.load`),
    replaces each fresh bench's own streams (`kv_serving.with_trace`):
    the trace handoff that replays a JAX run bit for bit.  `proto`
    replaces the scenario's protocol (a derived one, e.g. a fault).  An
    elastic engine runs `harness.make_elastic` of the bench with the
    churn `events` ((clock, agent, kind) triples) and `lease`, and its
    row adds `recovered` (agents reclaimed), the final `alive` mask, and
    the check's `done`, `completed` and `offered` where it has them.
    `warmup=False` skips the warm-up run (for a caller whose kernels are
    already built and loaded).  The row carries the latency and trace
    columns (module docstring)."""
    dev = common.resolve_device(device)
    mod = workloads.get(workload)
    run = harness.runner(engine)
    elastic = engine.endswith("_elastic")

    def fresh():
        b = mod.build(scenario, n_agents, seed=seed, proto=proto,
                      device=dev, **(build_kw or {}))
        if trace is not None:
            b = mod.with_trace(b, trace)
        return harness.make_elastic(b, events, lease) if elastic else b

    if warmup:
        warm = fresh()
        run(warm.wl, warm.state, *warm.ops)
    bench = fresh()
    _sync(dev)
    t0 = time.perf_counter()
    final = run(bench.wl, bench.state, *bench.ops)
    _sync(dev)
    steady = time.perf_counter() - t0
    check = bench.check(final)
    store = final.s.store if elastic else final.store
    counters = harness.counters_dict(store)
    row = {"workload": workload, "scenario": scenario,
           "n_agents": n_agents, "seed": seed, "engine": engine,
           "device": str(dev), "makespan": counters["makespan"],
           "counters": counters, "check_ok": bool(check["ok"]),
           "check_fails": int(check["check_fails"]),
           "events": int(check["events"]), "steady_s": steady,
           **T.summary(store)}
    _request_latency(row, [check])
    if elastic:
        row.update(recovered=counters["recoveries"],
                   alive=final.alive.cpu().tolist(),
                   **{k: check.get(k) for k in ("done", "completed",
                                                "offered")})
    return row


def run_churned_cell(which: str, device=None, trace=None,
                     warmup: bool = True) -> dict:
    """One of the sweep's churned cells, `which` "worksteal" (schema v5,
    `measure_churned_cell`) or "kv_serving" (schema v8,
    `measure_churned_serving`), with the recovery drain on: makespan,
    `recovered`, `lost_updates` (the check's failures among survivors),
    `completed` (kv_serving; None for worksteal), check_ok and
    `steady_s`.  `trace`, for kv_serving, replays a request trace the
    reference generated (the committed row's is a legacy-layout draw).
    `warmup` is `run_cell`'s."""
    c = CHURNED[which]
    proto = faults.crash_holding_lock(P.get_protocol("srsp"), c["victim"],
                                      c["at"])
    row = run_cell(which, "srsp", c["n_agents"], c["seed"],
                   "batched_elastic", device, build_kw=c["build_kw"],
                   trace=trace, events=[(c["evt"], c["victim"], "crash")],
                   proto=proto, warmup=warmup)
    return {"workload": which, "scenario": "srsp",
            "n_agents": c["n_agents"], "engine": "batched_elastic",
            "churn_events": 1, "makespan": row["makespan"],
            "recovered": row["recovered"],
            "lost_updates": row["check_fails"],
            "completed": row["completed"], "check_ok": row["check_ok"],
            "steady_s": row["steady_s"], "counters": row["counters"],
            **{k: row[k] for k in LATENCY_KEYS}}


def run_vmapped_cell(workload: str, scenario: str, n_agents: int, seeds,
                     engine: str = "fused", device=None, build_kw=None,
                     traces=None, proto: P.Protocol = None,
                     warmup: bool = True, states=None,
                     keep_stores: bool = False) -> dict:
    """The sweep row of one cell whose replicas, one per seed, run in one
    replica engine call (`harness.runner_many(engine)`, the reference's
    `measure_vmapped`): a warm-up call (unless `warmup=False`), then a
    timed call from fresh states.  Row: `n_replicas`,
    `steady_s_per_run` (the timed call's wall time, ending in a device
    synchronisation), `steady_s_per_replica` (that over R), `trips` (the
    timed call's, its slowest lane's), `events`,
    `makespan` and `counters` of lane 0, `check_ok` over every lane and
    `check_fails` summed; `lanes` gives each lane's seed, counters,
    events, check_ok and check_fails (and kv_serving's `completed`).
    `traces` (kv_serving) replays one reference trace a replica
    (`kv_serving.with_traces`; a None entry keeps that seed's own draw);
    `states`, a stacked state, replaces `init_many`'s (called for each
    run, the state is consumed).  The latency and trace columns are lane
    0's, kv_serving's request latencies pooled over every lane;
    `keep_stores` adds `_stores`, each lane's final store."""
    dev = common.resolve_device(device)
    mod = workloads.get(workload)
    if not mod.VMAPPABLE:
        raise ValueError(f"{workload} is not vmappable: its init_state "
                         f"enqueues on the host")
    run = harness.runner_many(engine)
    seeds = [int(s) for s in seeds]
    bench = mod.build(scenario, n_agents, seed=seeds[0], proto=proto,
                      device=dev, **(build_kw or {}))

    def fresh():
        if states is not None:
            return states()
        st = harness.init_many(mod.init_state, bench.wl, seeds, dev)
        if traces is not None:
            st = mod.with_traces(bench, traces, st).state
        return st

    if warmup:
        run(bench.wl, fresh(), *bench.ops)
    st = fresh()
    _sync(dev)
    passes = run.passes
    t0 = time.perf_counter()
    final = run(bench.wl, st, *bench.ops)
    _sync(dev)
    steady = time.perf_counter() - t0
    trips = run.passes - passes - 1    # the last pass finds none live
    lanes, checks, stores = [], [], []
    for k, seed in enumerate(seeds):
        lane = harness.lane(final, k)
        check = bench.check(lane)
        checks.append(check)
        stores.append(lane.store)
        lanes.append({"seed": seed,
                      "counters": harness.counters_dict(lane.store),
                      "events": int(check["events"]),
                      "check_ok": bool(check["ok"]),
                      "check_fails": int(check["check_fails"]),
                      **({"completed": check["completed"]}
                         if "completed" in check else {})})
    row = {"workload": workload, "scenario": scenario,
           "n_agents": n_agents, "engine": engine, "device": str(dev),
           "vmapped": True, "n_replicas": len(seeds),
           "steady_s_per_run": steady,
           "steady_s_per_replica": steady / len(seeds), "trips": trips,
           "events": lanes[0]["events"],
           "check_ok": all(r["check_ok"] for r in lanes),
           "check_fails": sum(r["check_fails"] for r in lanes),
           "makespan": lanes[0]["counters"]["makespan"],
           "counters": lanes[0]["counters"], "lanes": lanes,
           **T.summary(stores[0])}
    _request_latency(row, checks)
    if keep_stores:
        row["_stores"] = stores
    return row


def run_remote_batch_ab(n_agents: int, seeds, device=None) -> list:
    """The sweep's `remote_batch_ab` pair (`measure_remote_batch`):
    producer_consumer_mc srsp on the batched replica engine with the
    batched remote twins and with `faults.serialize_remote`.  Each row
    adds `remote_batch`; the two makespans must be identical (DESIGN.md
    §9), which this asserts."""
    rows = []
    for batched in (True, False):
        proto = None if batched else faults.serialize_remote(
            P.get_protocol("srsp"))
        row = run_vmapped_cell("producer_consumer_mc", "srsp", n_agents,
                               seeds, "batched", device, proto=proto)
        rows.append(dict(row, remote_batch=batched))
    assert rows[0]["makespan"] == rows[1]["makespan"], rows
    return rows


def run_fuse_ab(n_agents: int, seeds, device=None) -> list:
    """The sweep's `fuse_ab` pair (`measure_fuse`): kv_directory srsp on
    the fused and the batched replica engines.  The two makespans must be
    identical (DESIGN.md §12), which this asserts."""
    rows = [run_vmapped_cell("kv_directory", "srsp", n_agents, seeds,
                             engine, device)
            for engine in ("fused", "batched")]
    assert rows[0]["makespan"] == rows[1]["makespan"], rows
    return rows


# the sweep's serving-scale traffic (`serving-scale` cells: n=64, 256
# requests an agent, zipf 1.2, bursty, 1 % remote lookups)
SERVING_SCALE_N = 64
SERVING_SCALE_TRAFFIC = samplers.TrafficConfig(
    requests_per_agent=256, zipf_s=1.2, gap_mean=8.0, burstiness=4.0,
    remote_frac=0.01)


def run_serving_scale(replicas: int, device=None,
                      keep_stores: bool = False) -> dict:
    """The sweep's serving-scale cell: `replicas` replicas of full-width
    kv_serving (n=64, `SERVING_SCALE_TRAFFIC`) under srsp on the fused
    replica engine, each drawing its own trace on the device, over the
    seeds of the reference's timed call (replicas .. 2 * replicas - 1).
    No warm-up: one call of this size is what is timed."""
    return run_vmapped_cell(
        "kv_serving", "srsp", SERVING_SCALE_N,
        range(replicas, 2 * replicas), "fused", device,
        build_kw={"traffic": SERVING_SCALE_TRAFFIC}, warmup=False,
        keep_stores=keep_stores)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="replica cells of the sweep")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--serving-scale", type=int, metavar="R",
                      help="replicas of the serving-scale cell")
    what.add_argument("--cell", metavar="WORKLOAD",
                      help="a vmappable workload, run at --replicas")
    ap.add_argument("--replicas", type=int, nargs="+", default=[2])
    ap.add_argument("--out", default=None,
                    help="write {rows, stragglers} as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="Perfetto trace JSON of the first traced srsp "
                         "row's lane 0 (rows are traced under "
                         "REPRO_TRACE=1)")
    args = ap.parse_args(argv)
    keep = args.trace_out is not None
    n = SERVING_SCALE_N
    if args.cell:
        cells = [(f"{args.cell}/srsp/n={n}/R={r}/fused",
                  lambda r=r: run_vmapped_cell(
                      args.cell, "srsp", n, range(4, 4 + r), "fused",
                      keep_stores=keep))
                 for r in args.replicas]
    else:
        r = args.serving_scale
        cells = [(f"serving_scale/kv_serving/srsp/n={n}/R={r}/fused",
                  lambda: dict(run_serving_scale(r, keep_stores=keep),
                               traffic=vars(SERVING_SCALE_TRAFFIC)))]
    wd = CellWatchdog()
    rows, trace_store, trace_label = [], None, None
    try:
        for label, cell in cells:
            wd.start(label)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"cell:{label}"):
                row = cell()
            row["wall_s"] = time.perf_counter() - t0
            wd.stop()
            stores = row.pop("_stores", None)
            if stores and trace_store is None and row["trace_events"]:
                trace_store, trace_label = stores[0], label
            print(json.dumps({k: v for k, v in row.items()
                              if k != "lanes"}), flush=True)
            rows.append(row)
    finally:
        wd.close()
    if trace_store is not None:
        obs_export.write_trace(args.trace_out, trace_store,
                               label=trace_label, stragglers=wd.stragglers)
        print(f"wrote {args.trace_out} (traced cell: {trace_label})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "stragglers": wd.stragglers}, f,
                      indent=1)
    return 0 if all(r["check_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
