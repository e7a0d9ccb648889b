"""One cell of the workload sweep (`repro.workloads.sweep`).

`run_cell` runs one (workload, scenario, n_agents, seed, engine) cell
twice: a warm-up run, then a timed run from a fresh state.  It returns
the sweep row's fields for that seed.  The full grid is not ported yet.
"""
from __future__ import annotations

import time

import torch

from repro_torch import workloads
from repro_torch.kernels import common
from repro_torch.workloads import harness


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, scenario: str, n_agents: int, seed: int,
             engine: str, device=None, build_kw=None, trace=None) -> dict:
    """Sweep-row fields of one cell: makespan, counters, check_ok,
    check_fails, events, and `steady_s`, the wall time of the second
    (timed) run, ending in a device synchronisation.  `build_kw`
    overrides workload-config fields (the serving cells' traffic, as the
    reference's `measure_vmapped` takes it).  `trace`, a kv_serving
    request trace the reference generated (`traffic.trace.load`),
    replaces each fresh bench's own streams (`kv_serving.with_trace`):
    the trace handoff that replays a JAX run bit for bit."""
    dev = common.resolve_device(device)
    mod = workloads.get(workload)
    run = harness.runner(engine)

    def fresh():
        b = mod.build(scenario, n_agents, seed=seed, device=dev,
                      **(build_kw or {}))
        return b if trace is None else mod.with_trace(b, trace)

    warm = fresh()
    run(warm.wl, warm.state, *warm.ops)
    bench = fresh()
    _sync(dev)
    t0 = time.perf_counter()
    final = run(bench.wl, bench.state, *bench.ops)
    _sync(dev)
    steady = time.perf_counter() - t0
    check = bench.check(final)
    counters = harness.counters_dict(final.store)
    return {"workload": workload, "scenario": scenario,
            "n_agents": n_agents, "seed": seed, "engine": engine,
            "device": str(dev), "makespan": counters["makespan"],
            "counters": counters, "check_ok": bool(check["ok"]),
            "check_fails": int(check["check_fails"]),
            "events": int(check["events"]), "steady_s": steady}
