"""Timing the port's kernels on the card, and their A/B between checkouts.

    python3 src/repro_torch/kernels/timing.py [--trees DIR ...] [--rounds R]
                                              [--kernels NAME ...]
                                              [--out PATH]
    python3 src/repro_torch/kernels/timing.py --trace-misses ROUNDS

Helpers that `chip_smoke.py` and `tests/test_torch_cuda.py` share:
`device_ms` (device time per call: a CUDA graph of many calls replayed
and timed with CUDA events), `eager_ms` (wall time per call as a host
loop pays it, launch included), `trace` (torch.profiler's records of
one call, with idle slack at both ends of the window) and `device_ops`
(the device operations one call makes, from `trace`).  `sim_calls`
gives the simulator's kernels at the kv_directory shapes of n agents
(nb = 2n bank rows of W=16 words, b_drain's m = 16n drained rows), with
their bytes and operations: `drain_writeback` under a packed mask and
under a bool mask (its REPRO_NO_PACK=1 instance, where the checkout has
it), `plane_commit`, and `trip_plan` without and with the remote
co-schedule, and each one's replica instance (`*_many`) at R = 2 and
64.  `serve_calls` gives the serving path's `rmsnorm` and
`topk_router` at granite-moe-1b-a400m's decode and prefill shapes, and
`train_calls` the training path's backward kernels `flash_attention_bwd`
and `rmsnorm_bwd` at chip_smoke.py phase 5's training shapes.

As a script it times those kernels, the simulator's at n=64 and n=256
(device ms, eager ms, device operations a call), a line each, then all
as one JSON line.
With `--trees`, it loads each checkout's `src/` apart in this one
process (`load_tree`: each keeps its own modules, kernel libraries and
`build/`) and times each kernel and shape in turns over the trees, in
the order given (parent, change, change, parent compares two versions
on one card), `--rounds` times over, then ends with each tree's medians
and, for two trees, how many parent/change pairs the change wins.
`--kernels` times only the kernels of those names.
One process and fine turns, because the host's speed, and so every
eager time, moves by half from one process, or one minute, to the next.
Only the kernel wrappers and the case generators come from the
checkout, so a checkout that predates this file works.
`--trace-misses` counts the traces that come back with no CUDA-side
record over ROUNDS rounds of chip_smoke.py phase 5's order, with no
slack in the window and with TRACE_SLACK_S.
This file imports nothing of the port at import time.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys


# the replica instances' replica counts in `sim_calls`
REPS = (2, 64)


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


TRACE_ATTEMPTS = 5
# idle time at each end of a trace's window: with none, now and then a
# short trace came back with the launch's CPU record and no CUDA-side one
# ("Activity Buffer Request" in it), and the next traces often missed too
# (`trace_misses` counts them)
TRACE_SLACK_S = 0.005


def trace(fn, attempts=TRACE_ATTEMPTS, slack_s=TRACE_SLACK_S,
          cpu=True) -> list:
    """torch.profiler's key_averages() (CPU and CUDA, or CUDA alone
    without `cpu`: no operator records, whose count makes a long run's
    trace slow to collect) of one call of `fn`,
    with `slack_s` seconds of idle time in the window before the call and
    after its synchronize.  A trace with no CUDA-side record is a tracer
    miss (a call that launches cannot make none) and is taken again, up
    to `attempts` times; the last one is returned all the same."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(slack_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(slack_s)
        recs = list(prof.key_averages())
        if any(e.device_type == DeviceType.CUDA for e in recs):
            break
    return recs


def device_ops(fn, attempts=TRACE_ATTEMPTS) -> dict:
    """{record name: count} of the device operations one call of `fn`
    makes, from `trace`: every CUDA-side record (kernels, memsets,
    copies) and every cudaMemset* runtime call, so a memset counts as an
    operation however the tracer files it."""
    from torch.autograd import DeviceType
    ops = {}
    for e in trace(fn, attempts):
        if e.device_type == DeviceType.CUDA \
                or e.key.startswith("cudaMemset"):
            ops[e.key] = ops.get(e.key, 0) + e.count
    return ops


def trace_misses(calls, rounds: int) -> dict:
    """{slack: {call: one-attempt traces with no CUDA-side record}} over
    `rounds` rounds of chip_smoke.py phase 5's order for each call (a
    trace with no slack and one with TRACE_SLACK_S, in turns, then CUDA
    graphs of the kernel and of its plain version, then an eager loop)."""
    from torch.autograd import DeviceType
    out = {0.0: {}, TRACE_SLACK_S: {}}
    for r in range(rounds):
        for call in calls:
            key = f"{call['name']} {call['shape']}"
            for slack in sorted(out, reverse=bool(r % 2)):
                miss = not any(
                    e.device_type == DeviceType.CUDA
                    for e in trace(call["fn"], attempts=1, slack_s=slack))
                out[slack][key] = out[slack].get(key, 0) + miss
            device_ms(call["fn"])
            device_ms(call["plain"])
            eager_ms(call["fn"], iters=20)
    return {str(k): v for k, v in out.items()}


def sim_calls(C, SF, FT, n: int, device, reps=REPS) -> list:
    """The simulator's kernels at the kv_directory shapes of n agents:
    [{name, shape, fn, plain, bytes, ops}], `fn` the kernel wrapper and
    `plain` its plain version on the same inputs (C, SF, FT: the
    `cases`, `selective_flush.ops` and `fused_turn.ops` modules); then,
    where the checkout has them, the replica instances (`*_many`) at
    each replica count in `reps`, R copies of those inputs moving R
    times the bytes."""
    import numpy as np
    nb, w, m = 2 * n, 16, 16 * n        # b_drain: n caches x fifo_cap

    def on(xs):
        return [C.to_torch(x).to(device) for x in xs]

    def solo(dw, dwb, pc, tp, tag=""):
        out = []
        # each bank word is read once (from l2 or from its owning row) and
        # written once, plus the packed mask and the index list
        out.append(dict(
            name=f"drain_writeback{tag}", shape=f"nb={nb} W={w} m={m}",
            fn=lambda: getattr(SF, f"drain_writeback{tag}")(*dw),
            plain=lambda: SF.drain_writeback_ref(*dw),
            bytes=4 * (2 * nb * w + m * dw[2].shape[-1] + m),
            ops=m * w + nb * w))
        if dwb is not None:
            out.append(dict(
                name=f"drain_writeback_bool{tag}",
                shape=f"nb={nb} W={w} m={m} bool",
                fn=lambda: getattr(SF, f"drain_writeback_bool{tag}")(*dwb),
                plain=lambda: SF.drain_writeback_ref(*dwb),
                # as above, with the mask as m*W bytes
                bytes=4 * (2 * nb * w + m) + m * w, ops=m * w + nb * w))
        words = n * nb * pc[0].shape[-1]
        out.append(dict(
            name=f"plane_commit{tag}",
            shape=f"n={n} nb={nb} L={pc[0].shape[-1]}",
            fn=lambda: getattr(FT, f"plane_commit{tag}")(*pc),
            plain=lambda: FT.plane_commit_ref(*pc),
            bytes=4 * 4 * words + n * (4 + 4 + 1 + 1) + 2 * n,
            ops=2 * words))
        plan = getattr(FT, f"trip_plan{tag}")
        out.append(dict(
            name=f"trip_plan{tag}", shape=f"n={n} remote_cap=False",
            fn=lambda: plan(*tp, None, remote_cap=False),
            plain=lambda: FT.trip_plan_ref(*tp[:4], None, None),
            bytes=n * (4 + 1 + 1 + 4) + 2 * n + 4, ops=16 * n))
        # with the remote co-schedule: raddr read, the n x n address dedup
        out.append(dict(
            name=f"trip_plan{tag}", shape=f"n={n} remote_cap=True",
            fn=lambda: plan(*tp, None, remote_cap=True),
            plain=lambda: FT.trip_plan_ref(*tp, None),
            bytes=n * (4 + 1 + 1 + 4 + 4) + 2 * n + 4,
            ops=16 * n + 4 * n * n))
        return out

    bool_ok = hasattr(SF, "drain_writeback_bool")
    ins = (C.dw_inputs(1, nb, w, m),
           C.dw_inputs(1, nb, w, m, bool_mask=True) if bool_ok else None,
           C.pc_inputs(1, n, nb, w), C.plan_inputs(1, n))
    out = solo(*(on(x) if x is not None else None for x in ins))
    if not hasattr(SF, "drain_writeback_many"):
        return out
    for r in reps:
        # every replica holds the solo inputs, so a replica row and its
        # solo row time the same data
        calls = solo(*(on([np.stack([a] * r) for a in x]) for x in ins),
                     "_many")
        for c in calls:
            c.update(shape=f"{c['shape']} R={r}", reps=r,
                     bytes=r * c["bytes"], ops=r * c["ops"])
        out += calls
    return out


# the serving shapes of granite-moe-1b-a400m (d=1024, E=32, top-8) on
# the engine of chip_smoke.py phase 7: 4 slots a decode step, a prompt
# of 256 tokens a prefill
SERVE_SHAPES = {"decode": 4, "prefill": 256}


def serve_calls(C, RN, TR, device) -> list:
    """The serving path's `rmsnorm` (x bf16 [1, rows, 1024] or
    [4, 1, 1024]) and `topk_router` (logits [T, 32] float32, k=8) at
    each of SERVE_SHAPES: [{name, shape, fn, plain, bytes, ops}] (C, RN,
    TR: the `cases`, `rmsnorm.ops` and `topk_router.ops` modules);
    `args` holds the inputs, for a library call beside the kernel."""
    out = []
    d, e, k = 1024, 32, 8
    for seed, (which, rows) in enumerate(SERVE_SHAPES.items()):
        shape = (rows, 1, d) if which == "decode" else (1, rows, d)
        x, w = C.rms_inputs(seed, shape)
        x = C.to_dtype(x, "bfloat16").to(device)
        w = C.to_dtype(w, "float32").to(device)
        out.append(dict(
            name="rmsnorm",
            shape=f"x [{','.join(map(str, shape))}] bf16 ({which})",
            fn=lambda x=x, w=w: RN.rmsnorm(x, w),
            plain=lambda x=x, w=w: RN.rmsnorm_ref(x, w),
            # x read and y written in bf16, w read in float32
            bytes=2 * 2 * rows * d + 4 * d, ops=3 * rows * d,
            args=(x, w)))
        logits = C.to_torch(C.router_inputs(seed, rows, e)).to(device)
        out.append(dict(
            name="topk_router", shape=f"logits [{rows},{e}] f32 k={k} "
                                      f"({which})",
            fn=lambda g=logits: TR.topk_router(g, k),
            plain=lambda g=logits: TR.topk_router_ref(g, k),
            # logits read; weights and indices written
            bytes=4 * rows * e + 8 * rows * k, ops=rows * e * (3 + k),
            args=(logits, k)))
    return out


# the training microbatch of chip_smoke.py phase 5 (granite-moe-1b-a400m,
# 4 sequences of 256 tokens, bf16): attention q [4, 16, 256, 64] against
# k/v [4, 8, 256, 64], rmsnorm x/dy [1024, 1024]
TRAIN_ATTN = dict(b=4, hq=16, hkv=8, s=256, d=64)
TRAIN_ROWS, TRAIN_D = 1024, 1024


def train_calls(C, FA, RN, device) -> list:
    """The training path's backward kernels at TRAIN_ATTN and [TRAIN_ROWS,
    TRAIN_D], bf16: `flash_attention_bwd` (o and lse from the tree's own
    training forward) and `rmsnorm_bwd`: [{name, shape, fn, plain, bytes,
    ops}] (C, FA, RN: the `cases`, `flash_attention.ops` and
    `rmsnorm.ops` modules)."""
    import numpy as np
    b, hq, hkv, s, d = (TRAIN_ATTN[k] for k in ("b", "hq", "hkv", "s", "d"))
    q, k, v = (C.to_dtype(x, "bfloat16").to(device)
               for x in C.attn_inputs(9, **TRAIN_ATTN))
    rng = np.random.default_rng(9)
    do = C.to_dtype(rng.standard_normal(tuple(q.shape)).astype(np.float32),
                    "bfloat16").to(device)
    o, lse = FA.flash_attention_lse(q, k, v)
    x, w = C.rms_inputs(9, (TRAIN_ROWS, TRAIN_D))
    x = C.to_dtype(x, "bfloat16").to(device)
    w = C.to_dtype(w, "float32").to(device)
    dy = C.to_dtype(rng.standard_normal(tuple(x.shape)).astype(np.float32),
                    "bfloat16").to(device)
    return [
        dict(name="flash_attention_bwd",
             shape=f"q [{b},{hq},{s},{d}] k/v [{b},{hkv},{s},{d}] bf16",
             fn=lambda: FA.flash_attention_bwd(q, k, v, o, do, lse),
             plain=lambda: FA.flash_attention_bwd_ref(q, k, v, o, do, lse),
             # q, k, v, o, dO and lse in; dQ, dK, dV out
             bytes=2 * d * s * b * (4 * hq + 4 * hkv) + 4 * b * hq * s,
             ops=2.5 * 4 * d * b * hq * s * (s + 1) / 2),
        dict(name="rmsnorm_bwd", shape=f"x/dy [{TRAIN_ROWS},{TRAIN_D}] bf16",
             fn=lambda: RN.rmsnorm_bwd(x, w, dy),
             plain=lambda: RN.rmsnorm_bwd_ref(x, w, dy),
             bytes=3 * 2 * TRAIN_ROWS * TRAIN_D + 8 * TRAIN_D,
             ops=10 * TRAIN_ROWS * TRAIN_D)]


SIM_NS = (64, 256)
# the kernels whose call is one device operation, by the name of their
# __global__ function in torch.profiler's records (the replica instances
# launch the solo kernels' __global__ functions)
ONE_OP = {"drain_writeback": "drain_writeback_kernel",
          "drain_writeback_bool": "drain_writeback_kernel",
          "plane_commit": "plane_commit_kernel",
          "trip_plan": "trip_plan_kernel",
          "drain_writeback_many": "drain_writeback_kernel",
          "drain_writeback_bool_many": "drain_writeback_kernel",
          "plane_commit_many": "plane_commit_kernel",
          "trip_plan_many": "trip_plan_kernel",
          "rmsnorm": "rmsnorm_rows_kernel",
          "topk_router": "topk_router_kernel"}
SERVE_KERNELS = ("rmsnorm", "topk_router")


def load_tree(src: str) -> tuple:
    """(cases, selective_flush.ops, fused_turn.ops, rmsnorm.ops,
    topk_router.ops, flash_attention.ops) of the port under `src`,
    imported apart from any
    tree loaded before: the modules of the earlier tree leave
    `sys.modules` first, and keep the modules they imported, so trees
    loaded in turn coexist in one process."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(src))
    try:
        return tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                     for m in ("cases", "selective_flush.ops",
                               "fused_turn.ops", "rmsnorm.ops",
                               "topk_router.ops", "flash_attention.ops"))
    finally:
        sys.path.pop(0)


def time_trees(trees: list, rounds: int, kernels=None) -> list:
    """Device and eager ms per call of the simulator's kernels at n in
    SIM_NS, of the serving kernels at SERVE_SHAPES (`serve_calls`) and
    of the training backward kernels (`train_calls`), or of those named
    in `kernels`, for each checkout in `trees` (`load_tree`; a path may
    repeat), interleaved: each kernel and shape is timed `rounds` times
    over the list of trees before the next, so the host's drift falls on
    every tree alike.  One record a measurement; the device operations a
    call makes (`device_ops`) are taken after every timing."""
    import torch
    calls = {}
    for tree in trees:
        key = os.path.abspath(tree)
        if key not in calls:
            C, SF, FT, RN, TR, FA = load_tree(os.path.join(tree, "src"))
            dev = torch.device("cuda")
            calls[key] = {(c["name"], c["shape"]): dict(c, n=n)
                          for n in SIM_NS
                          for c in sim_calls(C, SF, FT, n, dev)}
            calls[key].update({(c["name"], c["shape"]): dict(c, n=None)
                               for c in serve_calls(C, RN, TR, dev)
                               + train_calls(C, FA, RN, dev)})
            if kernels:
                calls[key] = {k: c for k, c in calls[key].items()
                              if c["name"] in kernels}
    kinds = list(dict.fromkeys(k for per in calls.values() for k in per))
    recs = []
    for kind in kinds:
        for _ in range(rounds):
            for tree in trees:
                call = calls[os.path.abspath(tree)].get(kind)
                if call is None:          # an older tree lacks this kernel
                    continue
                rec = {"tree": tree, "name": call["name"], "n": call["n"],
                       "shape": call["shape"], "ms": device_ms(call["fn"]),
                       "eager_ms": eager_ms(call["fn"])}
                recs.append(rec)
                print(f"{tree}: {rec['name']} {rec['shape']}: "
                      f"{rec['ms']:.7f} ms, eager {rec['eager_ms']:.7f} ms",
                      flush=True)
    # traced last: once torch.profiler has run in a process, every later
    # device time reads higher
    ops = {}
    for rec in recs:
        key = (rec["tree"], rec["name"], rec["shape"])
        if key not in ops:
            call = calls[os.path.abspath(rec["tree"])][key[1:]]
            ops[key] = sum(device_ops(call["fn"]).values())
            print(f"{rec['tree']}: {rec['name']} {rec['shape']}: "
                  f"{ops[key]} device ops a call", flush=True)
        rec["ops_per_call"] = ops[key]
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="checkouts to time, in turns, in this order "
                         "(default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the list of trees this many times over")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="time only the kernels of these names")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-misses", type=int, default=0, metavar="ROUNDS",
                    help="count torch.profiler's empty traces over ROUNDS "
                         "rounds of phase 5's order at n=64, then exit")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if args.trace_misses:
        calls = sim_calls(*load_tree(os.path.join(here, "..", ".."))[:3],
                          64, torch.device("cuda"))
        print(json.dumps({"rounds": args.trace_misses, "misses_by_slack_s":
                          trace_misses(calls, args.trace_misses)}))
        return 0
    trees = args.trees or [os.path.abspath(os.path.join(here, "..", "..",
                                                        ".."))]
    recs = time_trees(trees, args.rounds, args.kernels)
    medians = tree_medians(recs)
    for m in medians:
        print(f"median of {m['runs']} runs, {m['tree']}: {m['name']} "
              f"{m['shape']}: {m['ms']:.7f} ms, eager {m['eager_ms']:.7f} ms",
              flush=True)
    pairs = pair_wins(recs)
    for m in pairs:
        print(f"pairs, {m['name']} {m['shape']}: {m['tree']} under "
              f"{m['base']} in {m['ms_wins']}/{m['pairs']} (device), "
              f"{m['eager_wins']}/{m['pairs']} (eager); {m['base']}'s "
              f"interquartile range {m['base_ms_iqr']:.7f} ms, eager "
              f"{m['base_eager_iqr']:.7f} ms", flush=True)
    doc = {"records": recs, "medians": medians, "pairs": pairs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return 0


def tree_medians(recs: list) -> list:
    """Per tree, kernel and shape: the median device and eager ms over
    that tree's records (the upper median of an even count)."""
    by = {}
    for r in recs:
        by.setdefault((r["tree"], r["name"], r["shape"]), []).append(r)
    out = []
    for (tree, name, shape), recs in by.items():
        ms, eager = (sorted(r[k] for r in recs)[len(recs) // 2]
                     for k in ("ms", "eager_ms"))
        out.append({"tree": tree, "name": name, "shape": shape,
                    "runs": len(recs), "ms": ms, "eager_ms": eager})
    return out


def _quartiles(xs: list) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 4], xs[(3 * len(xs)) // 4]


def pair_wins(recs: list) -> list:
    """With two trees (the first named is the base): per kernel and shape,
    the records taken one after another paired in turn (parent, change,
    change, parent gives two pairs a round); how many pairs the other
    tree wins on device and on eager time (a tie counts for neither), and
    the interquartile range of the base's own runs."""
    trees = list(dict.fromkeys(r["tree"] for r in recs))
    if len(trees) != 2:
        return []
    base, other = trees
    by = {}
    for r in recs:
        by.setdefault((r["name"], r["shape"]), []).append(r)
    out = []
    for (name, shape), rs in by.items():
        pairs = [(a, b) if a["tree"] == base else (b, a)
                 for a, b in zip(rs[::2], rs[1::2]) if a["tree"] != b["tree"]]
        mine = [r for r in rs if r["tree"] == base]
        if not mine:                      # a kernel the base lacks
            continue
        iqr = {k: (lambda q: q[1] - q[0])(_quartiles([r[k] for r in mine]))
               for k in ("ms", "eager_ms")}
        out.append({"name": name, "shape": shape, "base": base,
                    "tree": other, "pairs": len(pairs),
                    "ms_wins": sum(c["ms"] < p["ms"] for p, c in pairs),
                    "eager_wins": sum(c["eager_ms"] < p["eager_ms"]
                                      for p, c in pairs),
                    "base_ms_iqr": iqr["ms"],
                    "base_eager_iqr": iqr["eager_ms"]})
    return out


if __name__ == "__main__":
    # run as a file: keep this directory's modules off the import path
    if os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.exit(main())
