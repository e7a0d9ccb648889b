"""Timing the port's kernels on the card, and the simulator kernels' A/B.

    python3 src/repro_torch/kernels/timing.py [--trees DIR ...] [--out PATH]

Helpers that `chip_smoke.py` and `tests/test_torch_cuda.py` share:
`device_ms` (device time per call: a CUDA graph of many calls replayed
and timed with CUDA events), `eager_ms` (wall time per call as a host
loop pays it, launch included) and `device_ops` (the device operations
one call makes, from torch.profiler).  `sim_calls` gives the simulator's
three kernels at the kv_directory shapes of n agents (nb = 2n bank rows
of W=16 words, b_drain's m = 16n drained rows), with their bytes and
operations.

As a script it times those kernels at n=64 and n=256 (device ms, eager
ms, device operations a call), a line each, then all as one JSON line.
With `--trees`, it times each checkout's `src/` in a process of
its own, in the order given (parent, change, change, parent compares two
versions on one card); only the kernel wrappers and the case generators
come from the checkout, so a checkout that predates this file works.
This file imports nothing of the port at import time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def device_ms(fn, iters=50) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed and timed with CUDA events (host launch cost excluded);
    the median of 5 replays."""
    import torch
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


def eager_ms(fn, iters=200) -> float:
    """Wall time per call as the main path pays it (launch included):
    `iters` calls back to back between two CUDA events, the median of 5
    such runs (the host's clock is noisier than the card's)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


TRACE_ATTEMPTS = 3


def device_ops(fn) -> dict:
    """{record name: count} of the device operations one call of `fn`
    makes, under torch.profiler: every CUDA-side record (kernels,
    memsets, copies) and every cudaMemset* runtime call, so a memset
    counts as an operation however the tracer files it.  A trace with
    no CUDA-side record at all is a tracer miss (a call that launches
    cannot make none), seen now and then on repeated profiles; it is
    taken again, up to TRACE_ATTEMPTS times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA \
                    or e.key.startswith("cudaMemset"):
                ops[e.key] = ops.get(e.key, 0) + e.count
        if ops:
            break
    return ops


def sim_calls(C, SF, FT, n: int, device) -> list:
    """The simulator's kernels at the kv_directory shapes of n agents:
    [{name, shape, fn, plain, bytes, ops}], `fn` the kernel wrapper and
    `plain` its plain version on the same inputs (C, SF, FT: the
    `cases`, `selective_flush.ops` and `fused_turn.ops` modules)."""
    nb, w, m = 2 * n, 16, 16 * n        # b_drain: n caches x fifo_cap

    def on(xs):
        return [C.to_torch(x).to(device) for x in xs]

    out = []
    dw = on(C.dw_inputs(1, nb, w, m))
    out.append(dict(
        name="drain_writeback", shape=f"nb={nb} W={w} m={m}",
        fn=lambda: SF.drain_writeback(*dw),
        plain=lambda: SF.drain_writeback_ref(*dw),
        # each bank word is read once (from l2 or from its owning row)
        # and written once, plus the packed mask and the index list
        bytes=4 * (2 * nb * w + m * dw[2].shape[1] + m),
        ops=m * w + nb * w))
    pc = on(C.pc_inputs(1, n, nb, w))
    words = pc[0].numel()
    out.append(dict(
        name="plane_commit", shape=f"n={n} nb={nb} L={pc[0].shape[2]}",
        fn=lambda: FT.plane_commit(*pc),
        plain=lambda: FT.plane_commit_ref(*pc),
        bytes=4 * 4 * words + n * (4 + 4 + 1 + 1) + 2 * n, ops=2 * words))
    tp = on(C.plan_inputs(1, n))
    out.append(dict(
        name="trip_plan", shape=f"n={n} remote_cap=False",
        fn=lambda: FT.trip_plan(*tp, None, remote_cap=False),
        plain=lambda: FT.trip_plan_ref(*tp[:4], None, None),
        bytes=n * (4 + 1 + 1 + 4) + 2 * n + 4, ops=16 * n))
    return out


SIM_NS = (64, 256)
# the simulator kernels whose call is one device operation, by the name of
# their __global__ function in torch.profiler's records
ONE_OP = {"drain_writeback": "drain_writeback_kernel",
          "trip_plan": "trip_plan_kernel"}


def time_tree(src: str) -> list:
    """Device and eager ms per call of the simulator's kernels from the
    port under `src`, at n in SIM_NS."""
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import cases as C
    from repro_torch.kernels.fused_turn import ops as FT
    from repro_torch.kernels.selective_flush import ops as SF
    recs = []
    for n in SIM_NS:
        for call in sim_calls(C, SF, FT, n, torch.device("cuda")):
            recs.append({"name": call["name"], "n": n,
                         "shape": call["shape"],
                         "ms": device_ms(call["fn"]),
                         "eager_ms": eager_ms(call["fn"]),
                         "ops_per_call": sum(device_ops(call["fn"])
                                             .values())})
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="checkouts to time, each in its own process, in "
                         "this order (default: this one)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(time_tree(args.one)))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = args.trees or [os.path.abspath(os.path.join(here, "..", "..",
                                                        ".."))]
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", os.path.join(tree, "src")],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        recs = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "kernels": recs})
        for r in recs:
            print(f"{tree}: {r['name']} {r['shape']}: {r['ms']:.7f} ms, "
                  f"eager {r['eager_ms']:.7f} ms, {r['ops_per_call']} "
                  f"device ops a call", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    # run as a file: keep this directory's modules off the import path
    if os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.exit(main())
