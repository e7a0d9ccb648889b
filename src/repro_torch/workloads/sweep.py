"""One cell of the workload sweep (`repro.workloads.sweep`).

`run_cell` runs one (workload, scenario, n_agents, seed, engine) cell: a
warm-up run (unless `warmup=False`), then a timed run from a fresh
state.  It returns the sweep row's fields for that seed.  The elastic
engines take a churn schedule (`events`, `lease`) and a derived
protocol (`proto`, e.g. a crash fault of `faults`).  `run_churned_cell`
runs one of the sweep's two churned robustness cells
(`measure_churned_cell`, `measure_churned_serving`).  The full grid is
not ported yet.
"""
from __future__ import annotations

import time

import torch

from repro_torch import workloads
from repro_torch.core import protocol as P
from repro_torch.kernels import common
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
