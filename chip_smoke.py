#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the main path from `src/repro_torch/csrc/`
     into `build/` (one nvcc per source, in parallel), with the build time
     and each kernel's ptxas report;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edge cases (duplicates, pads,
     out-of-range indices, dirty bit 31, remote_cap, fences, empty
     masks), bitwise;
  4. the main path: kv_directory through `run_cell` with every launch
     count set to 0 first, held bitwise against the JAX reference's
     golden counters (`src/repro_torch/golden/kv_directory.json`):
     n=64 srsp/rsp/baseline on the fused engine at seeds 0 and 4, n=64
     srsp on the serial and batched engines, n=256 srsp fused; each
     cell's `steady_s`; every kernel must have launched;
  5. per kernel at the n=64 shapes: device time per call of the kernel
     and of its plain version (CUDA graph replay timed with CUDA events),
     the least time the card could take (bytes over 3.35 TB/s, or
     operations over 67 TOP/s), and the launches of phase 4;
  6. the device's busy time and idle share over one fused n=64 srsp run
     (torch.profiler).

The last three lines of standard output are the kernels JSON, the
nvidia-smi line, and {"ok": true, "device": {...}}.  Exits nonzero, and
prints no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
OPS_PER_S = 67e12               # H100 SXM non-tensor 32-bit rate
N_MAIN = 64                     # the paper's 64-CU GPU
CELLS = ([(s, N_MAIN, seed, "fused") for seed in (0, 4)
          for s in ("srsp", "rsp", "baseline")]
         + [("srsp", N_MAIN, 4, "serial"), ("srsp", N_MAIN, 4, "batched"),
            ("srsp", 256, 4, "fused")])


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def max_abs_err(got, want) -> float:
    import torch
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"dtype/shape {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def check_kernels(torch, C, SF, FT) -> dict:
    """Phase 3: each kernel == its plain version on the card, bitwise, on
    the case lists of `repro_torch.kernels.cases`."""
    dev = torch.device("cuda")

    def on(xs):
        return [C.to_torch(x).to(dev) for x in xs]

    def cpu(xs):
        return [C.to_torch(x) for x in xs]

    errs = {"drain_writeback": 0.0, "plane_commit": 0.0, "trip_plan": 0.0}
    for k, (name, kw) in enumerate(C.DRAIN_CASES):
        xs = C.dw_inputs(k, **kw)
        got = SF.drain_writeback(*on(xs))
        want_dev = SF.drain_writeback_ref(*on(xs))
        want_cpu = SF.drain_writeback_ref(*cpu(xs))
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want_dev), max_abs_err(got, want_cpu))
        log(f"  drain_writeback {name}: max_abs_err={e}")
        if e != 0.0:
            raise AssertionError(f"drain_writeback {name} disagrees")
        errs["drain_writeback"] = max(errs["drain_writeback"], e)
    for k, (name, kw) in enumerate(C.COMMIT_CASES):
        xs = C.pc_inputs(k, **kw)
        got = FT.plane_commit(*on(xs))
        want = FT.plane_commit_ref(*on(xs))
        want_cpu = FT.plane_commit_ref(*cpu(xs))
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want), max_abs_err(got, want_cpu))
        log(f"  plane_commit {name}: max_abs_err={e}")
        if e != 0.0:
            raise AssertionError(f"plane_commit {name} disagrees")
        errs["plane_commit"] = max(errs["plane_commit"], e)
    for k, (name, kw, cap, fenced) in enumerate(C.PLAN_CASES):
        xs = C.plan_inputs(k, **kw)
        hor = C.horizon(xs[0], fenced)
        got = FT.trip_plan(*on(xs), hor, remote_cap=cap)
        want = FT.trip_plan_ref(*on(xs[:4]), on(xs[4:])[0] if cap else None,
                                None if hor is None
                                else torch.tensor(hor, device=dev))
        torch.cuda.synchronize()
        e = max_abs_err(list(got), list(want))
        if e != 0.0:
            raise AssertionError(f"trip_plan {name} disagrees")
        errs["trip_plan"] = max(errs["trip_plan"], e)
    log(f"  trip_plan: {len(C.PLAN_CASES)} cases, max_abs_err="
        f"{errs['trip_plan']}")
    return errs


def run_main_path(torch, golden, launch_counters) -> list:
    """Phase 4: the cells through `run_cell`, checked against golden."""
    from repro_torch.workloads import sweep
    for f in launch_counters:
        f.launches = 0
    rows = []
    for scenario, n, seed, engine in CELLS:
        before = [f.launches for f in launch_counters]
        row = sweep.run_cell("kv_directory", scenario, n, seed, engine,
                             device="cuda")
        # run_cell runs the cell twice (warm-up, timed): launches per run
        row["launches_per_run"] = {
            f.__name__: (f.launches - b) // 2
            for f, b in zip(launch_counters, before)}
        ref = next(c for c in golden["cells"]
                   if (c["scenario"], c["n_agents"], c["seed"])
                   == (scenario, n, seed))
        for key in ("events", "check_ok", "check_fails"):
            if row[key] != ref[key]:
                raise AssertionError(f"{scenario} n={n} seed={seed} "
                                     f"{engine}: {key} {row[key]} != "
                                     f"{ref[key]}")
        if row["counters"] != ref["counters"]:
            raise AssertionError(f"{scenario} n={n} seed={seed} {engine}: "
                                 f"counters {row['counters']} != golden "
                                 f"{ref['counters']}")
        log(f"  kv_directory {scenario:8s} n={n:3d} seed={seed} "
            f"{engine:7s} makespan={row['makespan']} events={row['events']}"
            f" check_ok={row['check_ok']} steady_s={row['steady_s']} "
            f"launches/run={row['launches_per_run']}")
        rows.append(row)
    return rows


def device_ms(torch, fn, iters=50) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed and timed with CUDA events (host launch cost excluded)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def eager_ms(torch, fn, iters=200) -> float:
    """Wall time per call as the main path pays it (launch included)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(torch, C, SF, FT, errs, launches) -> list:
    """Phase 5: kernel vs plain version at the n=64 main-path shapes."""
    dev = torch.device("cuda")
    out = []

    def entry(name, src, replaces, shape, fn, plain, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops)
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": device_ms(torch, fn),
               "plain_ms": device_ms(torch, plain), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "shape": shape,
               "eager_ms": eager_ms(torch, fn),
               "plain_eager_ms": eager_ms(torch, plain)}
        log(f"  {name} {shape}: {rec['ms']:.5f} ms/call (plain "
            f"{rec['plain_ms']:.5f}), eager {rec['eager_ms']:.5f} ms "
            f"(plain {rec['plain_eager_ms']:.5f}), bound {b_ms:.7f} ms "
            f"({b_by}), launches {rec['launches']}")
        out.append(rec)

    nb, w, m = 128, 16, N_MAIN * 16      # b_drain: n caches x fifo_cap
    xs = [C.to_torch(x).to(dev) for x in C.dw_inputs(1, nb, w, m)]
    entry("drain_writeback", "src/repro_torch/csrc/drain_writeback.cu",
          "src/repro/kernels/selective_flush/kernel.py:93",
          f"nb={nb} W={w} m={m}", lambda: SF.drain_writeback(*xs),
          lambda: SF.drain_writeback_ref(*xs),
          # each bank word is read once (from l2 or from its owning row)
          # and written once, plus the packed mask and the index list
          4 * (2 * nb * w + m * xs[2].shape[1] + m), m * w + nb * w)
    n = N_MAIN
    xs = [C.to_torch(x).to(dev) for x in C.pc_inputs(1, n, nb, w)]
    words = xs[0].numel()
    entry("plane_commit", "src/repro_torch/csrc/plane_commit.cu",
          "src/repro/kernels/fused_turn/kernel.py:138",
          f"n={n} nb={nb} L={xs[0].shape[2]}", lambda: FT.plane_commit(*xs),
          lambda: FT.plane_commit_ref(*xs),
          4 * 4 * words + n * (4 + 4 + 1 + 1) + 2 * n, 2 * words)
    xs = [C.to_torch(x).to(dev) for x in C.plan_inputs(1, n)]
    entry("trip_plan", "src/repro_torch/csrc/trip_plan.cu",
          "src/repro/kernels/fused_turn/kernel.py:94",
          f"n={n} remote_cap=False",
          lambda: FT.trip_plan(*xs, None, remote_cap=False),
          lambda: FT.trip_plan_ref(*xs[:4], None, None),
          n * (4 + 1 + 1 + 4) + 2 * n + 4, 16 * n)
    return out


def profile_cell(torch, steady_s: float) -> dict:
    """Phase 6: device busy time of one fused n=64 srsp run, from
    torch.profiler's CUDA kernel records, against the unprofiled
    `steady_s` of that cell (phase 4): the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import workloads
    from repro_torch.workloads import harness
    bench = workloads.get("kv_directory").build("srsp", N_MAIN, seed=4,
                                                device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        harness.run_fused(bench.wl, bench.state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    rec = {"cell": f"kv_directory srsp n={N_MAIN} seed=4 fused",
           "device_busy_s": busy_s, "steady_s": steady_s,
           "idle_share": 1.0 - busy_s / steady_s if busy_s else None,
           "kernel_launches": sum(e.count for e in kernels),
           "top": [{"name": e.key[:60], "count": e.count,
                    "device_ms": dev_us(e) / 1e3} for e in top]}
    if not busy_s:
        log("  torch.profiler recorded no device time: idle share not "
            "measured")
    else:
        log(f"  device busy {busy_s:.4f} s of steady {steady_s:.4f} s: "
            f"idle share {rec['idle_share']:.4f}; "
            f"{rec['kernel_launches']} kernel launches")
        for t in rec["top"]:
            log(f"    {t['device_ms']:9.3f} ms  x{t['count']:6d}  "
                f"{t['name']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record as JSON to this path")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import cases as C
        from repro_torch.kernels import common
        from repro_torch.kernels.fused_turn import ops as FT
        from repro_torch.kernels.selective_flush import ops as SF
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = common.build()
    build_s = time.perf_counter() - t0
    log(f"[2] built {len(reports)} of {len(common.KERNELS)} kernels in "
        f"{build_s:.2f} s (others cached) into {common.BUILD}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("[3] kernels against their plain versions on the card")
    errs = check_kernels(torch, C, SF, FT)

    log("[4] main path: kv_directory through run_cell")
    with open(os.path.join(ROOT, "src", "repro_torch", "golden",
                           "kv_directory.json")) as f:
        golden = json.load(f)
    counters = (SF.drain_writeback, FT.plane_commit, FT.trip_plan)
    rows = run_main_path(torch, golden, counters)
    launches = {f.__name__: f.launches for f in counters}
    log(f"    launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")

    log("[5] kernel times at the n=64 shapes")
    kernels = measure(torch, C, SF, FT, errs, launches)

    log("[6] where the time goes: one fused n=64 srsp run under "
        "torch.profiler")
    prof = profile_cell(torch, rows[CELLS.index(("srsp", N_MAIN, 4,
                                                 "fused"))]["steady_s"])
    log(f"    total {time.perf_counter() - t_start:.1f} s")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "build_s": build_s, "cells": rows,
                       "kernels": kernels, "profile": prof,
                       "ptxas": reports}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
