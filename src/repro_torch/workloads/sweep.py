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
n=64) at each replica count (seeds 4, 5, ...), a JSON line a row.  Wrap
a run in `timeout` to bound it.  The full grid is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import workloads
from repro_torch.core import protocol as P
from repro_torch.kernels import common
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
    already built and loaded)."""
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
           "events": int(check["events"]), "steady_s": steady}
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
            "steady_s": row["steady_s"], "counters": row["counters"]}


def run_vmapped_cell(workload: str, scenario: str, n_agents: int, seeds,
                     engine: str = "fused", device=None, build_kw=None,
                     traces=None, proto: P.Protocol = None,
                     warmup: bool = True, states=None) -> dict:
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
    run, the state is consumed)."""
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
    lanes = []
    for k, seed in enumerate(seeds):
        lane = harness.lane(final, k)
        check = bench.check(lane)
        lanes.append({"seed": seed,
                      "counters": harness.counters_dict(lane.store),
                      "events": int(check["events"]),
                      "check_ok": bool(check["ok"]),
                      "check_fails": int(check["check_fails"]),
                      **({"completed": check["completed"]}
                         if "completed" in check else {})})
    return {"workload": workload, "scenario": scenario,
            "n_agents": n_agents, "engine": engine, "device": str(dev),
            "vmapped": True, "n_replicas": len(seeds),
            "steady_s_per_run": steady,
            "steady_s_per_replica": steady / len(seeds), "trips": trips,
            "events": lanes[0]["events"],
            "check_ok": all(r["check_ok"] for r in lanes),
            "check_fails": sum(r["check_fails"] for r in lanes),
            "makespan": lanes[0]["counters"]["makespan"],
            "counters": lanes[0]["counters"], "lanes": lanes}


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


def run_serving_scale(replicas: int, device=None) -> dict:
    """The sweep's serving-scale cell: `replicas` replicas of full-width
    kv_serving (n=64, `SERVING_SCALE_TRAFFIC`) under srsp on the fused
    replica engine, each drawing its own trace on the device, over the
    seeds of the reference's timed call (replicas .. 2 * replicas - 1).
    No warm-up: one call of this size is what is timed."""
    return run_vmapped_cell(
        "kv_serving", "srsp", SERVING_SCALE_N,
        range(replicas, 2 * replicas), "fused", device,
        build_kw={"traffic": SERVING_SCALE_TRAFFIC}, warmup=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="replica cells of the sweep")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--serving-scale", type=int, metavar="R",
                      help="replicas of the serving-scale cell")
    what.add_argument("--cell", metavar="WORKLOAD",
                      help="a vmappable workload, run at --replicas")
    ap.add_argument("--replicas", type=int, nargs="+", default=[2])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cell:
        rows = [run_vmapped_cell(args.cell, "srsp", SERVING_SCALE_N,
                                 range(4, 4 + r), "fused")
                for r in args.replicas]
        for row in rows:
            print(json.dumps({k: v for k, v in row.items()
                              if k != "lanes"}), flush=True)
    else:
        t0 = time.perf_counter()
        row = dict(run_serving_scale(args.serving_scale),
                   traffic=vars(SERVING_SCALE_TRAFFIC))
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows = [row]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r["check_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
