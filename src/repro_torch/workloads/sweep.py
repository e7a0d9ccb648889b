"""The protocol x workload x size sweep (`repro.workloads.sweep`): srsp
against rsp against the global-scope baseline, by modeled makespan, on
every registered workload, with the serving, churn and A/B sections.

    PYTHONPATH=src python3 -m repro_torch.workloads.sweep \
        [--workloads all] [--scenarios baseline scope_only rsp srsp]
        [--sizes 16 64] [--seeds 2] [--iters 2] [--no-pack-ab]
        [--pack-sizes 64 256] [--no-remote-batch-ab] [--no-churn]
        [--fused-scenarios srsp] [--no-fuse-ab] [--fuse-sizes 64 256]
        [--no-serving] [--serving-scale-replicas 64] [--device cpu]
        [--out BENCH_workloads.torch.json] [--trace-out PATH]

takes the reference's arguments, flag for flag, with its defaults, and
writes its schema-v8 document (`run_sweep`): `runs` (every grid row,
then the two churned rows), `serving`, `donation_ab`, `pack_ab`,
`remote_batch_ab`, `fuse_ab` and `comparisons`, each row with the
reference's keys, every assertion of the reference kept (fused ==
batched, remote batched == serialized, the serving engines equal, the
scale cell green).  It then checks its own document
(`sweep_doc.check_doc`, the port's copy of `benchmarks/check_smoke.py`)
and exits 1 on a failure.
It runs on the GPU unless `--device cpu`.  The port compiles nothing:
`compile_s` is the wall time of a cell's untimed first call (kernel
load and a first run).  `donation_ab` measures JAX buffer donation,
which PyTorch has no counterpart of: it is `[]`, `donate_buffers` is
null, and `--no-donation` and its flags are accepted and do nothing.
kv_serving rows draw their request traces on the device; `run_sweep`
can replay reference traces instead (`reference_traces`), which is how
the tests and `chip_smoke.py` hold a document to the reference's.

Two more modes run replica cells alone:

    PYTHONPATH=src python3 -m repro_torch.workloads.sweep --serving-scale 64
    PYTHONPATH=src python3 -m repro_torch.workloads.sweep --cell kv_directory \
        --replicas 1 2 4 8 16

the first runs the document's serving-scale cell (`serving_scale`: R
replicas of kv_serving at n=64, fused, under srsp, rsp and baseline) and
prints its rows, a JSON line each; the second runs one replica cell
(srsp, fused, n=64) at each replica count (seeds 4, 5, ...), a JSON line
a row; `--out` writes {"rows", "stragglers"}.

The cells: `run_cell` runs one (workload, scenario, n_agents, seed,
engine) cell, a warm-up run (unless `warmup=False`) and a timed run; the
elastic engines take a churn schedule (`events`, `lease`) and a derived
protocol (`proto`).  `run_vmapped_cell` runs a cell's replicas, one a
seed, in one replica engine call.  `measure_vmapped`,
`measure_host_init`, `measure_churned` (the two churned robustness
cells), `measure_remote_batch` and `measure_fuse` give the document's
rows; `serving_scale` the serving-scale cell's.

Every row carries the latency and trace columns (`latency_p50/p95/p99`,
`latency_turns`, `trace_events`, `trace_dropped`, `latency_source`):
conservative upper-edge percentiles of the per-turn modeled-latency
histogram and the event ring's occupancy when the run is traced
(`REPRO_TRACE=1`, or a state given `obs.trace.with_trace`), None/0
otherwise; kv_serving rows take theirs from the per-request latency
histogram, pooled over replicas, traced or not.  Tracing charges no
cycles, so every other column is bitwise the same either way.

Each cell runs under a `CellWatchdog` (a heartbeat file, a straggler
flag over the cells' wall times, and an interrupt when one cell outlasts
`REPRO_WATCHDOG_S` seconds, default 600; `REPRO_NO_WATCHDOG=1` turns it
off) and inside a `torch.profiler.record_function("cell:<label>")`.
`--trace-out PATH` exports the first traced srsp row's lane 0 as
Perfetto-loadable JSON (`obs.export.write_trace`), with the stragglers
as instants.
"""
from __future__ import annotations

import _thread
import argparse
import json
import os
import subprocess
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
from repro_torch.traffic import trace as TR
from repro_torch.workloads import faults, harness
from repro_torch.workloads.sweep_doc import (LATENCY_KEYS, SCHEMA_VERSION,
                                             check_doc)

DEFAULT_SCENARIOS = ["baseline", "scope_only", "rsp", "srsp"]
DEFAULT_OUT = "BENCH_workloads.torch.json"
DEFAULT_TRACE_OUT = "TRACE_sweep.torch.json"

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


def kernel_mode(device) -> str:
    """The row's kernel column: "cuda" when its tensors are on the card
    (every simulator kernel launches), "plain" on the CPU (the plain
    versions)."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _geometry(wl) -> dict:
    """Schema-v3 column: the LR/PA tables' sets x ways of this cell."""
    pc = wl.cfg.proto_cfg()
    return {"lr": str(pc.lr_tbl), "pa": str(pc.pa_tbl)}


def _api_cols(wl) -> dict:
    """Schema-v4 columns: the op surface (the scoped ISA) and whether the
    workload x protocol pair co-schedules address-disjoint remote turns
    (DESIGN.md §9)."""
    return {"api": "scoped", "remote_batch": bool(wl.remote_cap)}


def _churn_cols(churn_events=0, makespan=0.0, recovered=0.0,
                lost_updates=0) -> dict:
    """Schema-v5 columns (DESIGN.md §10): churn events fired, their rate
    per 1k modeled cycles, agents reclaimed by recovery drains, updates
    lost among survivors.  Zero-churn rows carry zeros."""
    rate = 1e3 * churn_events / makespan if makespan else 0.0
    return {"churn_events": int(churn_events),
            "churn_rate": round(rate, 5),
            "recovered": float(recovered),
            "lost_updates": int(lost_updates)}


def _traffic_cols(wl, checks) -> dict:
    """Schema-v8 columns (DESIGN.md §13): offered and completed requests
    summed over replicas, and the traffic shape; None on self-driven
    workloads."""
    if not checks or "offered" not in checks[0]:
        return {"offered_load": None, "completed": None,
                "zipf_s": None, "burstiness": None}
    tc = wl.cfg.traffic
    return {"offered_load": int(sum(c["offered"] for c in checks)),
            "completed": int(sum(c["completed"] for c in checks)),
            "zipf_s": tc.zipf_s, "burstiness": tc.burstiness}


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


# --------------------------------------------------------------------------
# request traces: kv_serving replays the reference's where it has them
# --------------------------------------------------------------------------

def trace_key(n_agents: int, n_keys: int, cfg: samplers.TrafficConfig,
              seed: int) -> tuple:
    """What a kv_serving request trace is drawn from (`trace.generate`)."""
    return (int(n_agents), int(n_keys), cfg, int(seed))


def trace_map(pairs) -> dict:
    """{trace_key: RequestTrace} of (trace, meta) pairs as
    `traffic.trace.load_set` gives them: `run_sweep`'s `traces`."""
    return {trace_key(m["n_agents"], m["n_keys"], m["config"], m["seed"]): tr
            for tr, m in pairs}


def reference_traces(path: str, device=None) -> dict:
    """`trace_map` of every trace in a `traffic.trace.save_set` file."""
    return trace_map(TR.load_set(path, device).values())


def _traces_for(traces, wl, seeds):
    """The reference traces of a kv_serving cell's seeds (None where
    `traces` has none: that lane draws its own), or None."""
    if not traces or not hasattr(wl.cfg, "traffic"):
        return None
    got = [traces.get(trace_key(wl.cfg.n_agents, wl.cfg.n_pages,
                                wl.cfg.traffic, s)) for s in seeds]
    return got if any(t is not None for t in got) else None


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def run_cell(workload: str, scenario: str, n_agents: int, seed: int,
             engine: str, device=None, build_kw=None, trace=None,
             events=(), lease=0.0, proto: P.Protocol = None,
             warmup: bool = True, keep_store: bool = False) -> dict:
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
    columns (module docstring); `keep_store` adds `_store`, `_check` and
    `_wl`, the final store, the check and the workload."""
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
    if keep_store:
        row.update(_store=store, _check=check, _wl=bench.wl)
    return row


def _churned_run(which: str, device=None, trace=None, warmup: bool = True,
                 keep_store: bool = False) -> dict:
    """`run_cell`'s row of a churned cell (`CHURNED[which]`)."""
    c = CHURNED[which]
    proto = faults.crash_holding_lock(P.get_protocol("srsp"), c["victim"],
                                      c["at"])
    return run_cell(which, "srsp", c["n_agents"], c["seed"],
                    "batched_elastic", device, build_kw=c["build_kw"],
                    trace=trace, events=[(c["evt"], c["victim"], "crash")],
                    proto=proto, warmup=warmup, keep_store=keep_store)


def _replica_call(mod, bench, run, seeds, dev, traces=None, states=None):
    """One replica engine call from fresh states (`states()`, or
    `init_many` over `seeds` with `traces` replayed): (final state, wall
    seconds of the call ending in a device synchronisation, trips)."""
    if states is not None:
        st = states()
    else:
        st = harness.init_many(mod.init_state, bench.wl, seeds, dev)
        if traces is not None:
            st = mod.with_traces(bench, traces, st).state
    _sync(dev)
    passes = run.passes
    t0 = time.perf_counter()
    final = run(bench.wl, st, *bench.ops)
    _sync(dev)
    return final, time.perf_counter() - t0, run.passes - passes - 1


def _lanes(bench, final, seeds) -> tuple:
    """(lanes, checks, stores) of a replica call's final state: each
    lane's seed, counters, events, check_ok, check_fails (and kv_serving's
    `completed`), its check and its store."""
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
    return lanes, checks, stores


def _replica_bench(workload: str, scenario: str, n_agents: int, seed: int,
                   dev, build_kw, proto):
    mod = workloads.get(workload)
    if not mod.VMAPPABLE:
        raise ValueError(f"{workload} is not vmappable: its init_state "
                         f"enqueues on the host")
    return mod, mod.build(scenario, n_agents, seed=seed, proto=proto,
                          device=dev, **(build_kw or {}))


def run_vmapped_cell(workload: str, scenario: str, n_agents: int, seeds,
                     engine: str = "fused", device=None, build_kw=None,
                     traces=None, proto: P.Protocol = None,
                     warmup: bool = True, states=None,
                     keep_stores: bool = False) -> dict:
    """The row of one cell whose replicas, one per seed, run in one
    replica engine call (`harness.runner_many(engine)`): a warm-up call
    (unless `warmup=False`), then a timed call from fresh states.  Row:
    `n_replicas`,
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
    seeds = [int(s) for s in seeds]
    mod, bench = _replica_bench(workload, scenario, n_agents, seeds[0], dev,
                                build_kw, proto)
    run = harness.runner_many(engine)
    if warmup:
        _replica_call(mod, bench, run, seeds, dev, traces, states)
    final, steady, trips = _replica_call(mod, bench, run, seeds, dev,
                                         traces, states)
    lanes, checks, stores = _lanes(bench, final, seeds)
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


# the sweep's serving-scale traffic (`serving-scale` cells: n=64, 256
# requests an agent, zipf 1.2, bursty, 1 % remote lookups)
SERVING_SCALE_N = 64
SERVING_SCALE_TRAFFIC = samplers.TrafficConfig(
    requests_per_agent=256, zipf_s=1.2, gap_mean=8.0, burstiness=4.0,
    remote_frac=0.01)
SCALE_SCENARIOS = ("srsp", "rsp", "baseline")


# --------------------------------------------------------------------------
# the document's rows (the reference's `measure_*`)
# --------------------------------------------------------------------------

def _round(x, nd):
    return None if x is None else round(x, nd)


def _grid_row(name, scenario, n_agents, engine, dev, wl, *, vmapped,
              n_replicas, iters, compile_s, times, store, checks,
              counters, events, check_ok, check_fails, churn=None) -> dict:
    """A `runs`/`serving` row with the reference's keys; `checks` give
    the traffic and request-latency columns (kv_serving), `_trace_store`
    stashes the store `--trace-out` exports."""
    steady = float(np.mean(times))
    row = {"workload": name, "scenario": scenario, "n_agents": n_agents,
           "engine": engine, "kernel_mode": kernel_mode(dev),
           "vmapped": vmapped, "n_replicas": n_replicas,
           "table_geometry": _geometry(wl), **_api_cols(wl),
           "iters_timed": iters,
           "compile_s": _round(compile_s, 4),
           "steady_s_per_run": round(steady, 5),
           "steady_s_per_replica": round(steady / n_replicas, 5),
           **_churn_cols(**(churn or {})), **T.summary(store),
           **_traffic_cols(wl, checks),
           "events": events, "check_ok": check_ok,
           "check_fails": check_fails,
           "makespan": counters["makespan"], "counters": counters,
           "_trace_store": store}
    _request_latency(row, checks)
    return row


def _timed_replicas(workload, scenario, n_agents, n_seeds, iters, engine,
                    dev, build_kw=None, traces=None, proto=None,
                    warmup=True) -> dict:
    """The reference's replica timing: the bench built at seed 0, an
    untimed warm-up call on seeds 0..R-1 (its wall time is `compile_s`;
    None without `warmup`), then `iters` timed calls, each on fresh seeds
    (it+1)*R .. (it+2)*R-1; the last call's lanes."""
    mod, bench = _replica_bench(workload, scenario, n_agents, 0, dev,
                                build_kw, proto)
    run = harness.runner_many(engine)

    def call(base):
        seeds = list(range(base, base + n_seeds))
        return seeds, _replica_call(mod, bench, run, seeds, dev,
                                    _traces_for(traces, bench.wl, seeds))

    compile_s = None
    if warmup:
        t0 = time.perf_counter()
        call(0)
        compile_s = time.perf_counter() - t0
    times = []
    for it in range(max(1, iters)):
        seeds, (final, steady, _) = call((it + 1) * n_seeds)
        times.append(steady)
    lanes, checks, stores = _lanes(bench, final, seeds)
    return {"wl": bench.wl, "compile_s": compile_s, "times": times,
            "lanes": lanes, "checks": checks, "store": stores[0]}


def measure_vmapped(name: str, scenario: str, n_agents: int, n_seeds: int,
                    iters: int, engine: str = "batched", device=None,
                    build_kw=None, traces=None, warmup: bool = True) -> dict:
    """A vmappable cell's row: R = `n_seeds` replicas in one replica
    engine call (`_timed_replicas`); `steady_s_per_run` the mean of the
    timed calls, `steady_s_per_replica` that over R; lane 0's makespan,
    counters and events and every lane's check of the last call.
    `build_kw` overrides workload-config fields (the serving cells'
    traffic); `traces` maps `trace_key`s to reference traces."""
    dev = common.resolve_device(device)
    r = _timed_replicas(name, scenario, n_agents, n_seeds, iters, engine,
                        dev, build_kw, traces, warmup=warmup)
    lane0 = r["lanes"][0]
    return _grid_row(
        name, scenario, n_agents, engine, dev, r["wl"], vmapped=True,
        n_replicas=n_seeds, iters=iters, compile_s=r["compile_s"],
        times=r["times"], store=r["store"], checks=r["checks"],
        counters=lane0["counters"],
        events=lane0["events"],
        check_ok=all(c["check_ok"] for c in r["lanes"]),
        check_fails=sum(c["check_fails"] for c in r["lanes"]))


def measure_host_init(name: str, scenario: str, n_agents: int, iters: int,
                      engine: str = "batched", device=None,
                      warmup: bool = True) -> dict:
    """A workload that is not vmappable (worksteal enqueues on the
    host): a warm-up run at seed 0, then `iters` timed runs at seeds
    1..iters, each from a fresh build; the last run's row."""
    dev = common.resolve_device(device)
    compile_s = None
    if warmup:
        compile_s = run_cell(name, scenario, n_agents, 0, engine, dev,
                             warmup=False)["steady_s"]
    times = []
    for it in range(max(1, iters)):
        row = run_cell(name, scenario, n_agents, it + 1, engine, dev,
                       warmup=False, keep_store=True)
        times.append(row["steady_s"])
    return _grid_row(
        name, scenario, n_agents, engine, dev, row["_wl"], vmapped=False,
        n_replicas=1, iters=iters, compile_s=compile_s, times=times,
        store=row["_store"], checks=[row["_check"]],
        counters=row["counters"],
        events=row["events"], check_ok=row["check_ok"],
        check_fails=row["check_fails"])


def measure_churned(which: str, iters: int, device=None, traces=None,
                    warmup: bool = True) -> dict:
    """A churned row (`CHURNED[which]`, the reference's
    `measure_churned_cell` and `measure_churned_serving`): a warm-up
    run, then `iters` timed runs, each timed from build to check as the
    reference times them; the last run's row, with the churn columns.
    `traces` maps `trace_key`s to reference traces (`trace_map`): a
    kv_serving cell replays its seed's, else draws its own."""
    dev = common.resolve_device(device)
    c = CHURNED[which]
    trace = None
    if traces:
        wl = workloads.get(which).build("srsp", c["n_agents"],
                                        seed=c["seed"], device=dev,
                                        **c["build_kw"]).wl
        trace = (_traces_for(traces, wl, [c["seed"]]) or [None])[0]

    def one():
        t0 = time.perf_counter()
        row = _churned_run(which, dev, trace, warmup=False, keep_store=True)
        return row, time.perf_counter() - t0

    compile_s = one()[1] if warmup else None
    times = []
    for _ in range(max(1, iters)):
        row, t = one()
        times.append(t)
    return _grid_row(
        which, "srsp", c["n_agents"], "batched_elastic", dev, row["_wl"],
        vmapped=False, n_replicas=1, iters=iters, compile_s=compile_s,
        times=times, store=row["_store"], checks=[row["_check"]],
        counters=row["counters"], events=row["events"],
        check_ok=row["check_ok"], check_fails=row["check_fails"],
        churn={"churn_events": 1, "makespan": row["makespan"],
               "recovered": row["recovered"],
               "lost_updates": row["check_fails"]})


def measure_remote_batch(n_agents: int, n_seeds: int, iters: int,
                         batched: bool, device=None,
                         warmup: bool = True) -> dict:
    """The `remote_batch_ab` arm: producer_consumer_mc srsp on the
    batched replica engine with the batched remote twins, or with
    `faults.serialize_remote` (DESIGN.md §9); modeled makespans must be
    identical, wall time measures the co-scheduling."""
    dev = common.resolve_device(device)
    proto = None if batched else faults.serialize_remote(
        P.get_protocol("srsp"))
    r = _timed_replicas("producer_consumer_mc", "srsp", n_agents, n_seeds,
                        iters, "batched", dev, proto=proto, warmup=warmup)
    return {"workload": "producer_consumer_mc", "scenario": "srsp",
            "n_agents": n_agents, "engine": "batched",
            "n_replicas": n_seeds, "remote_batch": batched,
            "compile_s": _round(r["compile_s"], 4),
            "steady_s_per_run": round(float(np.mean(r["times"])), 5),
            "events": r["lanes"][0]["events"],
            "check_ok": all(c["check_ok"] for c in r["lanes"]),
            "makespan": float(r["lanes"][0]["counters"]["makespan"])}


def measure_fuse(n_agents: int, n_seeds: int, iters: int, engine: str,
                 device=None, warmup: bool = True) -> dict:
    """The `fuse_ab` arm: kv_directory srsp on the `engine` ("fused" or
    "batched") replica engine; modeled makespans must be identical
    (DESIGN.md §12)."""
    dev = common.resolve_device(device)
    r = _timed_replicas("kv_directory", "srsp", n_agents, n_seeds, iters,
                        engine, dev, warmup=warmup)
    return {"workload": "kv_directory", "scenario": "srsp",
            "n_agents": n_agents, "engine": engine,
            "kernel_mode": kernel_mode(dev), "n_replicas": n_seeds,
            "compile_s": _round(r["compile_s"], 4),
            "steady_s_per_run": round(float(np.mean(r["times"])), 5),
            "events": r["lanes"][0]["events"],
            "check_ok": all(c["check_ok"] for c in r["lanes"]),
            "makespan": float(r["lanes"][0]["counters"]["makespan"])}


# ---------------- the packed-metadata A/B, a child process an arm ----------
# REPRO_NO_PACK is read once at import, so each arm runs in a fresh
# process with the variable set.

_WS_SNIPPET = r"""
import json, sys, time
import numpy as np
import torch
from repro_torch.core.worksteal import WorkStealSim, WSConfig
from repro_torch.data.graphs import collab_like
from repro_torch.kernels.selective_flush import ops as SF

n_wgs, iters, device = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
n_chunks = max(2 * n_wgs, 64)
ws = WSConfig(n_wgs=n_wgs, chunk_cap=32, n_chunks_max=n_chunks)
g = collab_like(n=32 * (n_chunks // 2), m=4, seed=2)
sim = WorkStealSim(ws, "srsp", "batched", device)
dev = sim.device
sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
    else (lambda: None)
store = sim.make_store()
last_inv = torch.zeros((ws.n_wgs,), dtype=torch.float32, device=dev)
frontier = np.arange(g.n, dtype=np.int32)
t0 = time.perf_counter()
store, last_inv, e, _ = sim.run_iteration(store, frontier, g.degrees, last_inv)
sync()
compile_s = time.perf_counter() - t0
times = []
for _ in range(max(1, iters)):
    t0 = time.perf_counter()
    store, last_inv, e, _ = sim.run_iteration(store, frontier, g.degrees,
                                              last_inv)
    sync()
    times.append(time.perf_counter() - t0)
print(json.dumps({"compile_s": round(compile_s, 4),
                  "steady_s_per_iter": round(float(np.mean(times)), 5),
                  "proc_errors": int(e),
                  "launches": {f.__name__: f.launches for f in (
                      SF.drain_writeback, SF.drain_writeback_bool)}}))
"""


def measure_pack(n_wgs: int, iters: int, packed: bool, device=None) -> dict:
    """One `pack_ab` arm: worksteal srsp batched `run_iteration` in a
    child process with REPRO_NO_PACK=0 (packed planes) or 1 (the bool
    layout, whose drains launch `drain_writeback_bool` on the card).
    `_launches` holds the child's drain launches."""
    dev = common.resolve_device(device)
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["REPRO_NO_PACK"] = "0" if packed else "1"
    out = subprocess.run(
        [sys.executable, "-c", _WS_SNIPPET, str(n_wgs), str(iters),
         str(dev)], capture_output=True, text=True, env=env)
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"pack subprocess failed: n_wgs={n_wgs} "
                           f"packed={packed}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    launches = rec.pop("launches")
    rec.update({"n_wgs": n_wgs, "workload": "worksteal",
                "scenario": "srsp", "engine": "batched", "packed": packed,
                "_launches": launches})
    want = "drain_writeback" if packed else "drain_writeback_bool"
    if dev.type == "cuda" and not 0 < launches[want] \
            == sum(launches.values()):
        raise AssertionError(f"pack arm packed={packed}: launches "
                             f"{launches}, want {want} only")
    return rec


# --------------------------------------------------------------------------
# the document
# --------------------------------------------------------------------------

METRIC_NOTE = (
    "The PyTorch/CUDA port of repro.workloads.sweep, schema v8, the "
    "reference's keys. compile_s: the port compiles nothing; it is the "
    "wall time of a cell's untimed first call (kernel load and a first "
    "run; null when a caller skips it), separate from steady_s_per_run "
    "(the mean of the timed calls on fresh seeds, each ending in a "
    "device synchronisation). Churned rows time each run from build to "
    "check, as the reference does. Protocol comparisons use modeled "
    "makespan (max per-agent cycles), the paper's metric; wall clock "
    "measures the engine (host-bound: one host read a trip). scope_only "
    "check_ok=false on remote-turn workloads is the expected staleness "
    "demo. kernel_mode is cuda when a row's tensors are on the card "
    "(drain_writeback, plane_commit and trip_plan and their replica "
    "instances launch), plain on the CPU (their plain versions). "
    "donation_ab is empty and donate_buffers null: the reference's "
    "A/B measures JAX buffer donation through jit, which PyTorch's eager "
    "calls have no counterpart of. fuse_enabled is true: the fused "
    "engine cannot be turned off. kv_serving rows draw their request "
    "traces on the device (threefry, partitionable layout) unless the "
    "run replays reference traces; the committed JAX document's "
    "kv_serving rows are legacy-layout draws. Latency columns: "
    "upper-edge percentiles of per-request completion latency on "
    "trace-driven rows (latency_source=requests), of per-turn latency "
    "under REPRO_TRACE=1 elsewhere (turns). The serving section replays "
    "one trace per (seed, config) through the batched and fused engines "
    "(asserted equal makespan, completed and p99); the scale cell runs "
    "srsp, rsp and baseline, self-checks green.")


def _cell(wd: CellWatchdog, label: str, fn) -> tuple:
    """fn() under the watchdog and a profiler range: (row, wall s)."""
    t0 = time.perf_counter()
    wd.start(label)
    with torch.profiler.record_function(f"cell:{label}"):
        rec = fn()
    wd.stop()
    return rec, time.perf_counter() - t0


def run_sweep(args, traces=None, warmup: bool = True) -> dict:
    """The sweep's document for parsed `args` (`parser()`): the reference
    `main`'s grid, sections, comparisons and assertions.  `traces` maps
    `trace_key`s to reference kv_serving traces, replayed where a lane's
    key is found (else the lane draws its own).  `warmup=False` skips
    every untimed first call (`compile_s` null): the modeled columns do
    not depend on it."""
    dev = common.resolve_device(args.device)
    names = workloads.available() if args.workloads == ["all"] \
        else args.workloads
    wd = CellWatchdog()
    runs = []
    trace_store, trace_label = None, None

    def harvest(rec, label):
        """Pop the stashed final store; keep the first traced srsp row's
        for the Perfetto export."""
        nonlocal trace_store, trace_label
        store = rec.pop("_trace_store", None)
        if (store is not None and trace_store is None
                and rec["scenario"] == "srsp" and rec["trace_events"]):
            trace_store, trace_label = store, label

    try:
        fused_scens = [] if args.fused_scenarios == ["none"] \
            else args.fused_scenarios
        for name in names:
            mod = workloads.get(name)
            for n_agents in args.sizes:
                for scen in args.scenarios:
                    engines = ["batched"] + (["fused"] if scen in fused_scens
                                             else [])
                    for engine in engines:
                        label = f"{name}/{scen}/n={n_agents}/{engine}"
                        if mod.VMAPPABLE:
                            fn = lambda: measure_vmapped(  # noqa: E731
                                name, scen, n_agents, args.seeds, args.iters,
                                engine, dev, traces=traces, warmup=warmup)
                        else:
                            fn = lambda: measure_host_init(  # noqa: E731
                                name, scen, n_agents, args.iters, engine,
                                dev, warmup=warmup)
                        rec, wall = _cell(wd, label, fn)
                        harvest(rec, label)
                        rec["bench_wall_s"] = round(wall, 2)
                        runs.append(rec)
                        print(f"{label}: "
                              f"compile_s={rec['compile_s']} "
                              f"steady={rec['steady_s_per_run'] * 1e3:.1f}ms "
                              f"makespan={rec['makespan']:.0f} "
                              f"check_ok={rec['check_ok']}", flush=True)

        for which in ("worksteal", "kv_serving"):
            if args.no_churn or (which == "kv_serving"
                                 and "kv_serving" not in names):
                continue
            label = f"{which}/srsp+crash/churned"
            rec, _ = _cell(wd, label, lambda: measure_churned(
                which, args.iters, dev, traces, warmup))
            harvest(rec, label)
            runs.append(rec)
            print(f"churned {which}/srsp (crash victim 0): "
                  f"check_ok={rec['check_ok']} "
                  f"recovered={rec['recovered']:.0f} "
                  f"lost_updates={rec['lost_updates']} "
                  f"churn_rate={rec['churn_rate']}/kcycle "
                  f"completed={rec['completed']}/{rec['offered_load']}",
                  flush=True)

        serving, serving_comparisons = [], {}
        if not args.no_serving:
            _serving(args, dev, wd, traces, warmup, serving,
                     serving_comparisons)

        trace_file = None
        if trace_store is not None and args.trace_out:
            obs_export.write_trace(args.trace_out, trace_store,
                                   label=trace_label,
                                   stragglers=wd.stragglers)
            trace_file = args.trace_out
            print(f"wrote {args.trace_out} (traced cell: {trace_label})")

        comparisons = dict(serving_comparisons)
        comparisons.update(_grid_comparisons(runs, names, args.sizes,
                                             fused_scens))
        ab = _ab_sections(args, dev, warmup, comparisons)
    finally:
        wd.close()

    return {
        "bench": "workloads_sweep",
        "schema_version": SCHEMA_VERSION,
        "metric_note": METRIC_NOTE,
        "backend": dev.type,
        "donate_buffers": None,
        "packed_metadata": P.PACKED,
        "kernel_mode": kernel_mode(dev),
        "fuse_enabled": True,
        "trace": {"enabled": T.TRACE, "capacity": T.default_cap(),
                  "file": trace_file, "cell": trace_label},
        "stragglers": wd.stragglers,
        "config": {"workloads": names, "scenarios": args.scenarios,
                   "sizes": args.sizes, "seeds": args.seeds,
                   "iters": args.iters,
                   "serving": None if args.no_serving else {
                       "sizes": args.serving_sizes,
                       "zipf": args.serving_zipf,
                       "requests_per_agent": args.serving_requests,
                       "seeds": args.serving_seeds,
                       "scale_replicas": args.serving_scale_replicas,
                       "gap_mean": 8.0, "burstiness": 4.0}},
        "runs": runs,
        "serving": serving,
        "donation_ab": [],
        **ab,
        "comparisons": comparisons,
    }


def _serving(args, dev, wd, traces, warmup, serving: list,
             comparisons: dict) -> None:
    """The trace-driven serving sections (schema v8, DESIGN.md §13): the
    comparison cells under each skew and the serving-scale cell."""
    for n in args.serving_sizes:
        for s in args.serving_zipf:
            tc = samplers.TrafficConfig(
                requests_per_agent=args.serving_requests, zipf_s=s,
                gap_mean=8.0, burstiness=4.0, remote_frac=0.03)
            cell = {}
            for scen, engine in (("srsp", "batched"), ("srsp", "fused"),
                                 ("rsp", "batched")):
                label = (f"serving/kv_serving/{scen}/zipf={s}"
                         f"/n={n}/{engine}")
                rec, wall = _cell(wd, label, lambda: measure_vmapped(
                    "kv_serving", scen, n, args.serving_seeds, args.iters,
                    engine, dev, build_kw={"traffic": tc}, traces=traces,
                    warmup=warmup))
                rec.pop("_trace_store", None)
                rec["bench_wall_s"] = round(wall, 2)
                serving.append(rec)
                cell[(scen, engine)] = rec
                print(f"{label}: steady={rec['steady_s_per_run']:.2f}s "
                      f"completed={rec['completed']}/{rec['offered_load']} "
                      f"p99={rec['latency_p99']} "
                      f"check_ok={rec['check_ok']}", flush=True)
            sb = cell[("srsp", "batched")]
            sf = cell[("srsp", "fused")]
            rb = cell[("rsp", "batched")]
            # one (seed, config) trace through both engines: the fused
            # trip is the batched schedule, so the modeled columns agree
            assert sf["makespan"] == sb["makespan"], (sf, sb)
            assert sf["completed"] == sb["completed"], (sf, sb)
            assert sf["latency_p99"] == sb["latency_p99"], (sf, sb)
            comparisons[f"serving/kv_serving/zipf={s}/n={n}"] = {
                "srsp_vs_rsp_makespan": round(
                    rb["makespan"] / sb["makespan"], 3),
                "srsp_vs_rsp_p99": round(
                    rb["latency_p99"] / max(sb["latency_p99"], 1.0), 3),
                "engines_bitwise": True,
                "offered_load": sb["offered_load"],
                "completed": sb["completed"]}

    if args.serving_scale_replicas > 0:
        scale = {}
        for rec in serving_scale(args.serving_scale_replicas, dev, wd,
                                 traces, warmup):
            rec.pop("_trace_store", None)
            serving.append(rec)
            scale[rec["scenario"]] = rec
        assert all(r["check_ok"] for r in scale.values()), scale
        key = f"serving_scale/kv_serving/zipf=1.2/n={SERVING_SCALE_N}"
        comparisons[key] = {
            "offered_load": scale["srsp"]["offered_load"],
            "completed": scale["srsp"]["completed"],
            "all_checks_ok": True,
            "srsp_vs_rsp_makespan": round(
                scale["rsp"]["makespan"] / scale["srsp"]["makespan"], 3),
            "srsp_vs_rsp_p99": round(
                scale["rsp"]["latency_p99"]
                / max(scale["srsp"]["latency_p99"], 1.0), 3),
            "srsp_vs_baseline_makespan": round(
                scale["baseline"]["makespan"]
                / scale["srsp"]["makespan"], 3)}


def serving_scale(replicas: int, dev, wd: CellWatchdog, traces=None,
                  warmup: bool = True) -> list:
    """The serving-scale cell (schema v8): `replicas` replicas of
    full-width kv_serving (n=64, `SERVING_SCALE_TRAFFIC`) on the fused
    replica engine, one timed call (`measure_vmapped`), under each of
    `SCALE_SCENARIOS`, each under the watchdog; its rows, each with
    `bench_wall_s` (warm-up included) and `_trace_store`."""
    n = SERVING_SCALE_N
    rows = []
    for scen in SCALE_SCENARIOS:
        label = f"serving-scale/kv_serving/{scen}/n={n}/fused"
        rec, wall = _cell(wd, label, lambda: measure_vmapped(
            "kv_serving", scen, n, replicas, 1, "fused", dev,
            build_kw={"traffic": SERVING_SCALE_TRAFFIC}, traces=traces,
            warmup=warmup))
        rec["bench_wall_s"] = round(wall, 2)
        rows.append(rec)
        steady = rec["steady_s_per_run"]
        print(f"{label}: {rec['completed']}/{rec['offered_load']} "
              f"requests in {steady:.1f}s "
              f"({rec['completed'] / max(steady, 1e-9):,.0f} req/s) "
              f"p99={rec['latency_p99']} "
              f"check_ok={rec['check_ok']}", flush=True)
    return rows


def _grid_comparisons(runs, names, sizes, fused_scens) -> dict:
    """The churn, protocol and fused-engine comparisons of the grid."""
    def find(name, scen, n, engine="batched"):
        for r in runs:
            if (r["workload"], r["scenario"], r["n_agents"],
                    r["engine"]) == (name, scen, n, engine) \
                    and not r["churn_events"]:
                return r
        return None

    comparisons = {}
    for r in runs:
        if r["churn_events"]:
            comparisons[f"churn/{r['workload']}/n={r['n_agents']}"] = {
                "completes_under_crash": bool(r["check_ok"]),
                "recovered": r["recovered"],
                "lost_updates": r["lost_updates"]}
    for name in names:
        for n in sizes:
            srsp = find(name, "srsp", n)
            rsp = find(name, "rsp", n)
            base = find(name, "baseline", n)
            if not srsp:
                continue
            entry = {}
            if rsp:
                entry["srsp_vs_rsp_makespan"] = round(
                    rsp["makespan"] / srsp["makespan"], 3)
                entry["srsp_vs_rsp_l2"] = round(
                    rsp["counters"]["l2_accesses"]
                    / max(srsp["counters"]["l2_accesses"], 1.0), 3)
            if base:
                entry["srsp_vs_baseline_makespan"] = round(
                    base["makespan"] / srsp["makespan"], 3)
            comparisons[f"{name}/n={n}"] = entry
    # the fused engine is the batched schedule: a diverging makespan is a
    # broken build, not a data point
    for name in names:
        for n in sizes:
            for scen in fused_scens:
                fus = find(name, scen, n, "fused")
                bat = find(name, scen, n, "batched")
                if not fus or not bat:
                    continue
                assert fus["makespan"] == bat["makespan"], (fus, bat)
                comparisons[f"fused/{name}/{scen}/n={n}"] = {
                    "makespan_equal": True,
                    "steady_speedup_fused": round(
                        bat["steady_s_per_run"]
                        / fus["steady_s_per_run"], 3)}
    return comparisons


def _ab_sections(args, dev, warmup, comparisons: dict) -> dict:
    """`pack_ab`, `remote_batch_ab` and `fuse_ab`, with their
    comparisons."""
    pack_ab = []
    if not args.no_pack_ab:
        for n_wgs in args.pack_sizes:
            for packed in (True, False):
                rec = measure_pack(n_wgs, args.pack_iters, packed, dev)
                launches = rec.pop("_launches")
                pack_ab.append(rec)
                print(f"pack n_wgs={n_wgs} packed={packed}: "
                      f"steady={rec['steady_s_per_iter']:.3f}s/iter "
                      f"compile={rec['compile_s']:.1f}s "
                      f"proc_errors={rec['proc_errors']} "
                      f"launches={launches}", flush=True)
        for n_wgs in args.pack_sizes:
            on = next(r for r in pack_ab
                      if r["n_wgs"] == n_wgs and r["packed"])
            off = next(r for r in pack_ab
                       if r["n_wgs"] == n_wgs and not r["packed"])
            comparisons[f"packed/n_wgs={n_wgs}"] = {
                "steady_speedup_packed": round(
                    off["steady_s_per_iter"] / on["steady_s_per_iter"], 3)}

    remote_batch_ab = []
    if not args.no_remote_batch_ab:
        for n in args.remote_batch_sizes:
            for batched in (True, False):
                rec = measure_remote_batch(n, args.seeds, args.iters,
                                           batched, dev, warmup)
                remote_batch_ab.append(rec)
                print(f"remote_batch n={n} batched={batched}: "
                      f"steady={rec['steady_s_per_run'] * 1e3:.1f}ms "
                      f"makespan={rec['makespan']:.0f} "
                      f"check_ok={rec['check_ok']}", flush=True)
        for n in args.remote_batch_sizes:
            on = next(r for r in remote_batch_ab
                      if r["n_agents"] == n and r["remote_batch"])
            off = next(r for r in remote_batch_ab
                       if r["n_agents"] == n and not r["remote_batch"])
            # co-scheduled remote turns must not change the modeled
            # schedule at all (DESIGN.md §9)
            assert on["makespan"] == off["makespan"], (on, off)
            comparisons[f"remote_batch/n={n}"] = {
                "makespan_equal": True,
                "steady_speedup_batched": round(
                    off["steady_s_per_run"] / on["steady_s_per_run"], 3)}

    fuse_ab = []
    if not args.no_fuse_ab:
        for n in args.fuse_sizes:
            for engine in ("fused", "batched"):
                rec = measure_fuse(n, args.seeds, args.iters, engine, dev,
                                   warmup)
                fuse_ab.append(rec)
                print(f"fuse n={n} engine={engine}: "
                      f"steady={rec['steady_s_per_run'] * 1e3:.1f}ms "
                      f"makespan={rec['makespan']:.0f} "
                      f"check_ok={rec['check_ok']}", flush=True)
        for n in args.fuse_sizes:
            on = next(r for r in fuse_ab
                      if r["n_agents"] == n and r["engine"] == "fused")
            off = next(r for r in fuse_ab
                       if r["n_agents"] == n and r["engine"] == "batched")
            # the fused trip must not change the modeled schedule at all
            # (DESIGN.md §12)
            assert on["makespan"] == off["makespan"], (on, off)
            comparisons[f"fuse/n={n}"] = {
                "makespan_equal": True,
                "steady_speedup_fused": round(
                    off["steady_s_per_run"] / on["steady_s_per_run"], 3)}
    return {"pack_ab": pack_ab, "remote_batch_ab": remote_batch_ab,
            "fuse_ab": fuse_ab}


def parser() -> argparse.ArgumentParser:
    """The reference's arguments, with its defaults, and the port's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", nargs="+", default=["all"])
    ap.add_argument("--scenarios", nargs="+", default=DEFAULT_SCENARIOS)
    ap.add_argument("--sizes", nargs="+", type=int, default=[16, 64])
    ap.add_argument("--seeds", type=int, default=2,
                    help="replicas per vmapped cell (one engine call)")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--no-donation", action="store_true",
                    help="accepted; the donation A/B has no PyTorch "
                         "counterpart and never runs")
    ap.add_argument("--donation-sizes", nargs="+", type=int,
                    default=[64, 256], help="accepted, unused")
    ap.add_argument("--donation-iters", type=int, default=2,
                    help="accepted, unused")
    ap.add_argument("--no-pack-ab", action="store_true",
                    help="skip the packed-vs-boolean metadata A/B")
    ap.add_argument("--pack-sizes", nargs="+", type=int, default=[64, 256])
    ap.add_argument("--pack-iters", type=int, default=2)
    ap.add_argument("--no-remote-batch-ab", action="store_true",
                    help="skip the batched-vs-serialized remote-turn A/B")
    ap.add_argument("--remote-batch-sizes", nargs="+", type=int,
                    default=[16, 64])
    ap.add_argument("--fused-scenarios", nargs="+", default=["srsp"],
                    help="scenarios that also get engine=fused grid rows "
                         "('none' disables)")
    ap.add_argument("--no-fuse-ab", action="store_true",
                    help="skip the fused-vs-batched engine A/B")
    ap.add_argument("--fuse-sizes", nargs="+", type=int, default=[64, 256])
    ap.add_argument("--no-churn", action="store_true",
                    help="skip the churned crash-recovery cells")
    ap.add_argument("--no-serving", action="store_true",
                    help="skip the serving sections (the grid's "
                         "kv_serving rows still run)")
    ap.add_argument("--serving-sizes", nargs="+", type=int, default=[64])
    ap.add_argument("--serving-zipf", nargs="+", type=float,
                    default=[0.9, 1.2],
                    help="Zipf skew exponents for the serving comparison")
    ap.add_argument("--serving-requests", type=int, default=256,
                    help="requests per agent in each serving cell")
    ap.add_argument("--serving-seeds", type=int, default=2,
                    help="replicas per serving comparison cell")
    ap.add_argument("--serving-scale-replicas", type=int, default=64,
                    help="replicas of the serving-scale cell (0 disables)")
    ap.add_argument("--trace-out", default=None,
                    help="Perfetto trace JSON of the first traced srsp row "
                         f"(under REPRO_TRACE=1; grid default "
                         f"{DEFAULT_TRACE_OUT})")
    ap.add_argument("--out", default=None,
                    help=f"the document (grid default {DEFAULT_OUT}); "
                         f"with --cell or --serving-scale, "
                         f"{{rows, stragglers}}")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--serving-scale", type=int, metavar="R",
                      help="run only the serving-scale cell at R "
                           "replicas (srsp, rsp and baseline)")
    what.add_argument("--cell", metavar="WORKLOAD",
                      help="run only this vmappable workload's replica "
                           "cell, at --replicas")
    ap.add_argument("--replicas", type=int, nargs="+", default=[2])
    return ap


def _replica_cells(args) -> int:
    """`--cell` and `--serving-scale`: replica cells alone, a JSON line
    a row."""
    dev = common.resolve_device(args.device)
    keep = args.trace_out is not None
    n = SERVING_SCALE_N
    wd = CellWatchdog()
    rows, trace_store, trace_label = [], None, None

    def emit(label, row, store):
        nonlocal trace_store, trace_label
        if store is not None and trace_store is None and row["trace_events"]:
            trace_store, trace_label = store, label
        print(json.dumps({k: v for k, v in row.items() if k != "lanes"}),
              flush=True)
        rows.append(row)

    try:
        if args.cell:
            for r in args.replicas:
                label = f"{args.cell}/srsp/n={n}/R={r}/fused"
                row, wall = _cell(wd, label, lambda: run_vmapped_cell(
                    args.cell, "srsp", n, range(4, 4 + r), "fused", dev,
                    keep_stores=keep))
                row["wall_s"] = wall
                stores = row.pop("_stores", None)
                emit(label, row, stores[0] if stores else None)
        else:
            r = args.serving_scale
            for row in serving_scale(r, dev, wd):
                emit(f"serving-scale/kv_serving/{row['scenario']}/n={n}"
                     f"/R={r}/fused", row, row.pop("_trace_store"))
    finally:
        wd.close()
    if keep and trace_store is not None:
        obs_export.write_trace(args.trace_out, trace_store,
                               label=trace_label, stragglers=wd.stragglers)
        print(f"wrote {args.trace_out} (traced cell: {trace_label})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "stragglers": wd.stragglers}, f,
                      indent=1)
    return 0 if all(r["check_ok"] for r in rows) else 1


def main(argv=None, traces=None, warmup: bool = True) -> int:
    """The command (module docstring).  `traces` and `warmup` are
    `run_sweep`'s."""
    args = parser().parse_args(argv)
    if args.cell or args.serving_scale is not None:
        return _replica_cells(args)
    args.out = args.out or DEFAULT_OUT
    if args.trace_out is None:
        args.trace_out = DEFAULT_TRACE_OUT
    doc = run_sweep(args, traces, warmup)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    for k, v in doc["comparisons"].items():
        print(f"  {k}: {v}")
    fails = check_doc(doc, expect_trace=T.TRACE)
    for msg in fails:
        print(f"  FAIL: {msg}")
    print(f"check_doc: {len(fails)} failures in {len(doc['runs'])} rows",
          flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
