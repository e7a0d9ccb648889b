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
     masks), bitwise; drain_writeback under packed and under bool masks
     (its REPRO_NO_PACK=1 instance, `drain_writeback_bool`);
  4. the main path: the simulator's workloads through `run_cell` with
     every launch count set to 0 first, held bitwise (every counter,
     `events`, `check_ok`, `check_fails`) against the JAX reference's
     golden files (`src/repro_torch/golden/<workload>.json`):
     kv_directory n=64 srsp/rsp/baseline on the fused engine at seeds 0
     and 4, n=64 srsp on the serial and batched engines, n=256 srsp
     fused; reader_lock, producer_consumer and producer_consumer_mc at
     n=64 srsp/rsp/baseline fused, srsp batched, and n=16 srsp serial,
     rsp/baseline fused and the scope_only staleness demo (check red);
     each cell's `steady_s` and launches per run; every kernel must have
     launched.  Then one fused producer_consumer_mc srsp n=64 run
     records the size of each co-scheduled remote batch: some must hold
     two or more drains.  Then the bool metadata layout: a child process
     with REPRO_NO_PACK=1 runs kv_directory and the three workloads at
     n=64 srsp seed 4 fused, held to the same golden cells, with the
     launch counts set to 0 first: the bool drain kernel and trip_plan
     must launch (bool planes take plane_commit's plain version, as in
     the reference), the packed drain kernel must not; the child's
     failure fails the run;
  5. per kernel at the n=64 shapes and at n=256 (`fuse_ab`'s): device
     time per call of the kernel and of its plain version (CUDA graph
     replay timed with CUDA events, `repro_torch.kernels.timing`), eager
     time per call (host launch included), the least time the card could
     take (bytes over 3.35 TB/s, or operations over 67 TOP/s), the
     launches of phase 4, and the device operations one call makes under
     torch.profiler: exactly one kernel record, no memset or fill, for
     both drain_writeback instances, plane_commit and trip_plan, and for
     rmsnorm and topk_router at their decode and prefill shapes;
  6. the device's busy time and idle share over one fused n=64 srsp run
     of kv_directory and of producer_consumer_mc (torch.profiler);
  7. the serving path of granite-moe-1b-a400m (`repro_torch.serve`):
     (1) the golden config (full width, 2 layers, float32, numpy
     weights) teacher-forced on `golden/granite_moe_serve.json`'s tokens,
     top-5 logits within GOLDEN_TOL of the JAX reference's and greedy
     tokens equal wherever the margin exceeds 2 * GOLDEN_TOL; (2) the
     full 24-layer model, weights from a seeded torch.Generator on the
     card, Engine(max_len=512, slots=4) answering 8 requests (prompts of
     16-256 tokens, 32 new tokens each): in float32 token for token the
     serial one-request-at-a-time run, in bfloat16 (the timed run, with
     the serving kernels' launch counts set to 0 just before it) equal to
     the serial run wherever the serial top-1/top-2 margin exceeds
     BF16_MARGIN; (3) prefill ms per request, decode ms per step,
     tokens/s and the device idle share over one decode step, with the
     device time of the port's kernels in that step and in the longest
     prompt's prefill;
  8. the cross-pod delta sync (`repro_torch.distributed.hier_sync`),
     4 pods stacked on the card, `make_pod_sync` in its three modes
     (selective float32, selective int8, full) on the delta-sync bench's
     three banks, the cross-pod example's bank and granite-moe-1b-a400m's
     embedding at its real size (49155 x 1024), with the flush's launch
     count set to 0 just before and read just after: each bank held to
     `golden/hier_sync.json` (lists, counters, int8 digests exact, block
     sums within 2e-6 per element; the embedding bank has no golden
     record) and to the float64 mean across pods (float modes within
     1e-5, int8 within half a quantization step more); then per bank the
     bytes ratio, the sync's wall ms per mode (median of 5), and the
     flush kernel's device time at that bank's shape beside its bound,
     its plain version and `torch.index_select`, bitwise checked.

Phases 3 and 5 cover the serving kernels too (rmsnorm, flash_attention,
flash_decode, topk_router): phase 3 holds them to their plain versions
within the tolerances of `repro_torch.kernels.cases`, rmsnorm also on
views whose base is off 16 bytes; phase 5 times them at the bfloat16
serving shapes beside their bound (bytes over 3.35 TB/s or flops over
989 TFLOP/s bf16 / 67 TFLOP/s float32) and one PyTorch call of the same
function (scaled_dot_product_attention, rms_norm), flash_attention at
every prefill length of phase 7's prompts, rmsnorm and topk_router at
the decode and the prefill shapes beside the launch floor (an empty
kernel's device time), each with its eager time (host launch and
tensor-map encode included).  Phase 2
logs each kernel's ptxas report (registers, shared memory, spills).
Phase 3 holds selective_flush to its plain version bitwise on
`cases.FLUSH_CASES`; phase 8 times it.

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
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core rate
N_MAIN = 64                     # the paper's 64-CU GPU
GOLDEN_TOL = 1e-3               # float32 logits, card vs the JAX CPU run
BF16_MARGIN = 0.125             # 8 bf16 ulps of logits of size 2-4
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 512, 32
T = None                        # repro_torch.kernels.timing, set by main
# phase 4: (workload, scenario, n_agents, seed, engine); the lock and
# queue workloads run every cell of their golden files
KV_CELLS = ([("kv_directory", s, N_MAIN, seed, "fused") for seed in (0, 4)
             for s in ("srsp", "rsp", "baseline")]
            + [("kv_directory", "srsp", N_MAIN, 4, "serial"),
               ("kv_directory", "srsp", N_MAIN, 4, "batched"),
               ("kv_directory", "srsp", 256, 4, "fused")])
LOCK_QUEUE = ("reader_lock", "producer_consumer", "producer_consumer_mc")
# phase 6's cells: the profiler's cost grows with a run's kernel records,
# so reader_lock and producer_consumer, the two runs with the most, stay
# out and the run keeps within half its time limit
PROFILED = ("kv_directory", "producer_consumer_mc")
# the bool-layout child's cells
BOOL_CELLS = [(w, "srsp", N_MAIN, 4, "fused")
              for w in ("kv_directory",) + LOCK_QUEUE]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(t_start: float, msg: str) -> None:
    """A phase's header, with the seconds since the run started."""
    log(f"{msg}  [at {time.perf_counter() - t_start:.1f} s]")


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

    errs = {"drain_writeback": 0.0, "drain_writeback_bool": 0.0,
            "plane_commit": 0.0, "trip_plan": 0.0}
    for kernel, fn, bool_mask in (
            ("drain_writeback", SF.drain_writeback, False),
            ("drain_writeback_bool", SF.drain_writeback_bool, True)):
        for k, (name, kw) in enumerate(C.DRAIN_CASES):
            xs = C.dw_inputs(k, **kw, bool_mask=bool_mask)
            got = fn(*on(xs))
            want_dev = SF.drain_writeback_ref(*on(xs))
            want_cpu = SF.drain_writeback_ref(*cpu(xs))
            torch.cuda.synchronize()
            e = max(max_abs_err(got, want_dev), max_abs_err(got, want_cpu))
            log(f"  {kernel} {name}: max_abs_err={e}")
            if e != 0.0:
                raise AssertionError(f"{kernel} {name} disagrees")
            errs[kernel] = max(errs[kernel], e)
    for k, (name, kw) in enumerate(C.COMMIT_CASES):
        xs = C.pc_inputs(k, **kw)
        args = on(xs)
        got = FT.plane_commit(*args)
        want = FT.plane_commit_ref(*on(xs))
        want_cpu = FT.plane_commit_ref(*cpu(xs))
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want), max_abs_err(got, want_cpu),
                max_abs_err(args, on(xs)))         # inputs left as they were
        log(f"  plane_commit {name}: max_abs_err={e}")
        if e != 0.0:
            raise AssertionError(f"plane_commit {name} disagrees")
        if {g.untyped_storage().data_ptr() for g in got} & {
                a.untyped_storage().data_ptr() for a in args}:
            raise AssertionError(f"plane_commit {name}: an output shares "
                                 f"storage with an input")
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
    errs["selective_flush"] = 0.0
    for k, case in enumerate(C.FLUSH_CASES):
        bank, idx = C.flush_args(k, dev)
        got = SF.selective_flush(bank, idx)
        torch.cuda.synchronize()
        if not (bits_equal(torch, got, SF.selective_flush_ref(bank, idx))
                and bits_equal(torch, got, SF.selective_flush_ref(
                    bank.cpu(), idx.cpu()))):
            raise AssertionError(f"selective_flush {case[0]} disagrees")
    log(f"  selective_flush: {len(C.FLUSH_CASES)} cases bitwise equal")
    return errs


def bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (bfloat16/float32 through int views)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.cpu().view(view), b.cpu().view(view))


def load_golden(workload: str) -> dict:
    with open(os.path.join(ROOT, "src", "repro_torch", "golden",
                           f"{workload}.json")) as f:
        return json.load(f)


def main_cells() -> list:
    """Phase 4's cells: kv_directory's, then every golden cell of the
    lock and queue workloads."""
    return KV_CELLS + [(w, c["scenario"], c["n_agents"], c["seed"],
                        c["engine"])
                       for w in LOCK_QUEUE for c in load_golden(w)["cells"]]


def golden_cell(doc, scenario, n, seed, engine) -> dict:
    """The golden cell of this engine, else the cell's fused run (the
    engines' counters are equal; kv_directory's file holds fused runs)."""
    cells = [c for c in doc["cells"] if (c["scenario"], c["n_agents"],
                                         c["seed"]) == (scenario, n, seed)]
    return next((c for c in cells if c["engine"] == engine), cells[0])


def run_cells(cells, launch_counters) -> list:
    """The cells through `run_cell` on the card, each held to its golden
    cell; launch counts set to 0 first.  Raises on any difference."""
    from repro_torch.workloads import sweep
    goldens = {w: load_golden(w) for w in {c[0] for c in cells}}
    for f in launch_counters:
        f.launches = 0
    rows = []
    for workload, scenario, n, seed, engine in cells:
        before = [f.launches for f in launch_counters]
        row = sweep.run_cell(workload, scenario, n, seed, engine,
                             device="cuda")
        # run_cell runs the cell twice (warm-up, timed): launches per run
        row["launches_per_run"] = {
            f.__name__: (f.launches - b) // 2
            for f, b in zip(launch_counters, before)}
        ref = golden_cell(goldens[workload], scenario, n, seed, engine)
        ctx = f"{workload} {scenario} n={n} seed={seed} {engine}"
        for key in ("events", "check_ok", "check_fails"):
            if row[key] != ref[key]:
                raise AssertionError(f"{ctx}: {key} {row[key]} != "
                                     f"{ref[key]}")
        if row["counters"] != ref["counters"]:
            raise AssertionError(f"{ctx}: counters {row['counters']} != "
                                 f"golden {ref['counters']}")
        log(f"  {workload:20s} {scenario:10s} n={n:3d} seed={seed} "
            f"{engine:7s} makespan={row['makespan']} events={row['events']}"
            f" check_ok={row['check_ok']} steady_s={row['steady_s']} "
            f"launches/run={row['launches_per_run']}")
        rows.append(row)
    return rows


def remote_batches() -> dict:
    """Phase 4: one fused producer_consumer_mc srsp n=64 seed 4 run with
    each co-scheduled remote batch's size recorded ({size: trips}); it
    must hold a batch of two or more drains and end on the golden
    counters."""
    import dataclasses

    from repro_torch import workloads
    from repro_torch.workloads import harness
    bench = workloads.get("producer_consumer_mc").build(
        "srsp", N_MAIN, seed=4, device="cuda")
    sizes = {}

    def turn_b(wl, s, mask, *ops):
        k = int(mask.sum())
        sizes[k] = sizes.get(k, 0) + 1
        return bench.wl.remote_turn_b(wl, s, mask, *ops)

    wl = dataclasses.replace(bench.wl, remote_turn_b=turn_b)
    final = harness.run_fused(wl, bench.state)
    ref = golden_cell(load_golden("producer_consumer_mc"), "srsp", N_MAIN,
                      4, "fused")
    if harness.counters_dict(final.store) != ref["counters"]:
        raise AssertionError("the recorded producer_consumer_mc run left "
                             "the golden counters")
    log(f"  producer_consumer_mc srsp n={N_MAIN} fused: co-scheduled remote "
        f"batches by size {dict(sorted(sizes.items()))}")
    if max(sizes, default=0) < 2:
        raise AssertionError(f"no remote batch held two drains: {sizes}")
    return {"cell": f"producer_consumer_mc srsp n={N_MAIN} seed=4 fused",
            "batches_by_size": {str(k): v for k, v in sorted(sizes.items())}}


def bool_layout_child(torch, SF, FT) -> int:
    """The bool layout's cells, run in a child process with
    REPRO_NO_PACK=1: the golden cells on bool planes, the launch counts
    set to 0 just before and read just after, one JSON line last."""
    from repro_torch.core import protocol as P
    if P.PACKED:
        raise AssertionError("the child needs REPRO_NO_PACK=1")
    counters = (SF.drain_writeback, SF.drain_writeback_bool,
                FT.plane_commit, FT.trip_plan)
    rows = run_cells(BOOL_CELLS, counters)
    launches = {f.__name__: f.launches for f in counters}
    if not (launches["drain_writeback_bool"] and launches["trip_plan"]) \
            or launches["drain_writeback"]:
        raise AssertionError(f"bool layout launches {launches}: want the "
                             f"bool drain kernel and trip_plan, no packed "
                             f"drain")
    print(json.dumps({"rows": rows, "launches": launches}))
    return 0


def run_bool_layout() -> dict:
    """Phase 4, the bool layout: this script in a child process with
    REPRO_NO_PACK=1 (the layout is read once at import).  Its log lines
    are echoed; a nonzero exit fails the run."""
    env = dict(os.environ, REPRO_NO_PACK="1")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--bool-layout-child"], env=env,
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  [bool] {line.strip()}")
    if out.returncode != 0:
        raise AssertionError(f"the bool-layout child failed "
                             f"({out.returncode}):\n{out.stdout[-4000:]}\n"
                             f"{out.stderr[-4000:]}")
    res = json.loads(lines[-1])
    log(f"    launches in the bool-layout run: {res['launches']}")
    return res


def bound(bytes_moved: float, ops: float, ops_per_s=OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the TPU kernel each of the simulator's kernels replaces
SIM_REPLACES = {
    "drain_writeback": "src/repro/kernels/selective_flush/kernel.py:93",
    "drain_writeback_bool": "src/repro/kernels/selective_flush/kernel.py:63",
    "plane_commit": "src/repro/kernels/fused_turn/kernel.py:138",
    "trip_plan": "src/repro/kernels/fused_turn/kernel.py:94",
}
# the bool instance is a template instance of the packed kernel's source
SIM_SOURCES = {"drain_writeback_bool": "drain_writeback"}


def measure(torch, C, SF, FT, errs, launches) -> list:
    """Phase 5, the simulator's kernels (both drain_writeback instances)
    at the kv_directory shapes of n=64 (the entry) and n=256 (with n=64
    in `by_shape`): device time per call of the kernel and of its plain
    version, eager time of both, the bound, and the device operations
    one call makes under torch.profiler (`T.device_ops`), which must be
    exactly one kernel record for the `T.ONE_OP` kernels."""
    dev = torch.device("cuda")
    shapes, timed = {}, []
    for n in T.SIM_NS:
        for call in T.sim_calls(C, SF, FT, n, dev):
            fn, plain = call["fn"], call["plain"]
            b_ms, b_by = bound(call["bytes"], call["ops"])
            rec = {"shape": call["shape"], "ms": T.device_ms(fn),
                   "plain_ms": T.device_ms(plain), "bound_ms": b_ms,
                   "bound_by": b_by, "eager_ms": T.eager_ms(fn),
                   "plain_eager_ms": T.eager_ms(plain)}
            timed.append((call, rec))
    for call, rec in timed:
        log(f"  {call['name']} {call['shape']}: {rec['ms']:.7f} ms/call "
            f"(plain {rec['plain_ms']:.7f}), eager {rec['eager_ms']:.7f} ms "
            f"(plain {rec['plain_eager_ms']:.7f}), bound "
            f"{rec['bound_ms']:.7f} ms ({rec['bound_by']})")
    # traced after every timing: once torch.profiler has run in a
    # process, every later device time reads higher
    check_one_op(timed)
    for call, rec in timed:
        shapes.setdefault(call["name"], []).append(rec)
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/"
                       f"{SIM_SOURCES.get(name, name)}.cu",
             "replaces": SIM_REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], "library_ms": None}
            | recs[0] | {"by_shape": recs}
            for name, recs in shapes.items()]


def profile_cell(torch, workload: str, steady_s: float) -> dict:
    """Phase 6: device busy time of one fused n=64 srsp seed 4 run of
    `workload`, from torch.profiler's CUDA kernel records, against the
    unprofiled `steady_s` of that cell (phase 4): the device's idle
    share."""
    from repro_torch import workloads
    from repro_torch.workloads import harness
    bench = workloads.get(workload).build("srsp", N_MAIN, seed=4,
                                          device="cuda")
    busy_s, kernels = device_busy(
        torch, lambda: harness.run_fused(bench.wl, bench.state))
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    rec = {"cell": f"{workload} srsp n={N_MAIN} seed=4 fused",
           "device_busy_s": busy_s, "steady_s": steady_s,
           "idle_share": 1.0 - busy_s / steady_s,
           "kernel_launches": sum(e.count for e in kernels),
           "top": [{"name": e.key[:60], "count": e.count,
                    "device_ms": _dev_us(e) / 1e3} for e in top]}
    log(f"  {rec['cell']}: device busy {busy_s:.4f} s of steady "
        f"{steady_s:.4f} s: "
        f"idle share {rec['idle_share']:.4f}; "
        f"{rec['kernel_launches']} kernel launches")
    for t in rec["top"]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:6d}  {t['name']}")
    return rec


def check_serving_kernels(torch, C, ops) -> dict:
    """Phase 3, the serving kernels: each kernel on the card against its
    plain version on the same inputs, on the card and on the CPU, by
    `C.check_float` (within `C.TOL` of the output's type) and
    `C.check_router` (weights within ROUTER_W_TOL, indices bitwise on
    every row whose order is decided).  Returns the largest absolute
    error per kernel."""
    dev = torch.device("cuda")
    errs = {}
    for name in C.FLOAT_CASES:
        fn, plain = getattr(ops[name], name), getattr(ops[name],
                                                      name + "_ref")
        for k, case in enumerate(C.FLOAT_CASES[name]):
            rel, e = C.check_float(fn, plain, *C.float_args(name, k), dev)
            errs[name] = max(errs.get(name, 0.0), e)
            log(f"  {name} {case[0]}: rel err {rel:.3g}")
    RN = ops["rmsnorm"]
    for k, case in enumerate(C.RMS_VIEW_CASES):
        rel, e = C.check_float(RN.rmsnorm, RN.rmsnorm_ref,
                               *C.rms_view_args(k, dev), dev)
        errs["rmsnorm"] = max(errs["rmsnorm"], e)
        log(f"  rmsnorm {case[0]}: rel err {rel:.3g}")
    TR = ops["topk_router"]
    for k, case in enumerate(C.ROUTER_CASES):
        e, decided, rows = C.check_router(TR.topk_router, TR.topk_router_ref,
                                          k, dev)
        errs["topk_router"] = max(errs.get("topk_router", 0.0), e)
        log(f"  topk_router {case[0]}: weight err {e:.3g}, indices equal "
            f"on {decided}/{rows} decided rows")
    return errs


def measure_serving(torch, C, ops, errs, prompt_lens) -> tuple:
    """Phase 5, the serving kernels at the bfloat16 shapes of phase 7's
    engine (slots=4, max_len=512, its prompts' lengths): device time
    of the kernel, of its plain version and of one PyTorch call of the
    same function, beside the bound; rmsnorm and topk_router at the
    decode and the prefill shapes (`T.serve_calls`), beside the launch
    floor, the device time of an empty kernel.  `launches` is filled by
    phase 7.  Returns (records, [(call, record)] of the `T.ONE_OP`
    kernels, to trace once every time is taken)."""
    import torch.nn.functional as F

    from repro_torch.kernels import common
    dev = torch.device("cuda")
    bf = torch.bfloat16
    es = 2
    out = []
    RN, FA, FD, TR = (ops[n] for n in ("rmsnorm", "flash_attention",
                                       "flash_decode", "topk_router"))
    floor = T.device_ms(lambda: common.launch("rmsnorm", [], dev,
                                              entry="repro_empty"))
    log(f"  launch floor (an empty kernel, one CTA of 32 threads): "
        f"{floor:.7f} ms/call")

    def entry(name, replaces, shape, fn, plain, library, nbytes, flops,
              rate, note=None):
        b_ms, b_by = bound(nbytes, flops, rate)
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": None,
               "max_abs_err": errs[name], "ms": T.device_ms(fn),
               "plain_ms": T.device_ms(plain), "bound_ms": b_ms,
               "bound_by": b_by,
               "library_ms": T.device_ms(library) if library else None,
               "shape": shape, "eager_ms": T.eager_ms(fn)}
        if note:
            rec.update(note(rec))
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.5f}"
        log(f"  {name} {shape}: {rec['ms']:.5f} ms/call (plain "
            f"{rec['plain_ms']:.5f}, library {lib}), eager "
            f"{rec['eager_ms']:.5f} ms, bound {b_ms:.7f} ms ({b_by})")
        out.append(rec)

    serve = T.serve_calls(C, RN, TR, dev)
    one_op = []

    def by_shape(name, replaces, library, note=None):
        """`name` at each of T.SERVE_SHAPES: the decode shape's record is
        the kernel's entry, every shape's goes to its `by_shape`."""
        recs = []
        for call in (c for c in serve if c["name"] == name):
            entry(name, replaces, call["shape"], call["fn"], call["plain"],
                  library(*call["args"]), call["bytes"], call["ops"],
                  OPS_PER_S, note=note and (lambda rec: note(*call["args"])))
            rec = out.pop() | {"launch_floor_ms": floor}
            log(f"    over the launch floor: {rec['ms'] - floor:.7f} ms")
            recs.append(rec)
            one_op.append((call, rec))
        out.append(recs[0] | {"by_shape": recs})

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rms_norm_call(x, w):
        w_bf = w.to(bf)             # F.rms_norm takes the weight in x's type
        return lambda: F.rms_norm(x, (x.shape[-1],), w_bf, 1e-6)

    by_shape("rmsnorm", "src/repro/kernels/rmsnorm/kernel.py:24",
             rms_norm_call)

    # every prefill length of phase 7's prompts; the longest is the
    # kernel's entry, the others go to its `by_length`
    by_length = []
    for s in sorted(set(prompt_lens)):
        q, k, v = (randn(1, 16, s, 64), randn(1, 8, s, 64),
                   randn(1, 8, s, 64))
        entry("flash_attention",
              "src/repro/kernels/flash_attention/kernel.py:72",
              f"q [1,16,{s},64] k/v [1,8,{s},64] bf16 causal (prefill)",
              lambda: FA.flash_attention(q, k, v),
              lambda: FA.flash_attention_ref(q, k, v),
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True),
              es * 64 * (2 * 16 * s + 2 * 8 * s),
              4 * 64 * 16 * s * (s + 1) / 2, BF16_FLOPS)
        rec = out.pop()
        by_length.append({key: rec[key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "eager_ms",
            "bound_ms", "bound_by")} | {"s": s})
    out.append(rec | {"by_length": by_length})

    # decode: the first four prompts half-way through their new tokens
    b, S = SERVE_SLOTS, SERVE_MAX_LEN
    lens = torch.tensor([n + SERVE_NEW // 2 for n in prompt_lens[:b]],
                        dtype=torch.int32, device=dev)
    qd, kc, vc = randn(b, 16, 64), randn(b, 8, S, 64), randn(b, 8, S, 64)
    mask = (torch.arange(S, device=dev) < lens[:, None])[:, None, None, :]
    valid = int(lens.sum())
    entry("flash_decode", "src/repro/kernels/flash_decode/kernel.py:62",
          f"q [{b},16,64] cache [{b},8,{S},64] bf16 kv_len "
          f"{lens.tolist()} (decode)",
          lambda: FD.flash_decode(qd, kc, vc, lens),
          lambda: FD.flash_decode_ref(qd, kc, vc, lens),
          lambda: F.scaled_dot_product_attention(
              qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
          2 * es * 64 * 8 * valid + 2 * es * b * 16 * 64 + 4 * b,
          4 * 16 * 64 * valid, BF16_FLOPS,
          note=lambda rec: {"clusters": b * 8, "resident_clusters":
                            FD.resident_clusters(16, 8, S, 64, bf)})
    log(f"    flash_decode launches {out[-1]['clusters']} clusters of 8 "
        f"CTAs; {out[-1]['resident_clusters']} fit on the card at once")

    by_shape("topk_router", "src/repro/kernels/topk_router/kernel.py:43",
             lambda g, k: None,
             note=lambda g, k: {"two_call_ms": T.device_ms(
                 lambda: torch.softmax(g, -1).topk(k)),
                 "library_note": "no one PyTorch call; two_call_ms is "
                                 "softmax + topk (no renormalisation)"})
    return out, one_op


def check_one_op(calls) -> None:
    """Phase 5: each (call, record) under torch.profiler
    (`T.device_ops`, kept in the record), which must show exactly one
    kernel record, of the kernel's own __global__ function."""
    for call, rec in calls:
        ops = rec["device_ops"] = T.device_ops(call["fn"])
        log(f"  {call['name']} {call['shape']}: device ops a call: {ops}")
        if sum(ops.values()) != 1 or not any(
                T.ONE_OP[call["name"]] in k for k in ops):
            raise AssertionError(f"{call['name']} {call['shape']}: one call "
                                 f"made {ops}, want one kernel")


def device_busy(torch, fn) -> tuple:
    """(device busy seconds, CUDA kernel records) of one call of `fn`
    under torch.profiler (`T.trace`), from its CUDA kernel records.
    Raises when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    kernels = [e for e in T.trace(fn) if e.device_type == DeviceType.CUDA]
    busy_s = sum(_dev_us(e) for e in kernels) / 1e6
    if not busy_s:
        raise AssertionError("torch.profiler recorded no device time: the "
                             "idle share cannot be measured")
    return busy_s, kernels


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def serve_requests(vocab: int) -> list:
    """Phase 7's 8 requests: prompts of 16-256 tokens (both ends
    present), 32 new tokens each."""
    import numpy as np

    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(2024)
    lens = rng.integers(16, 257, 8)
    lens[0], lens[1] = 256, 16
    return [Request(prompt=rng.integers(0, vocab, (int(n),))
                    .astype(np.int32), max_new_tokens=SERVE_NEW)
            for n in lens]


def serve_path(torch, counters) -> dict:
    """Phase 7: the serving path of granite-moe-1b-a400m; `counters` are
    the serving kernels' wrappers, whose launch counts are set to 0 just
    before the timed bfloat16 engine run and read just after it."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import granite_moe_1b
    from repro_torch.models.registry import build
    from repro_torch.serve import golden as G
    from repro_torch.serve import reference
    from repro_torch.serve.engine import Engine, Request, insert
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rec = {}

    # (1) the golden config, teacher-forced on the JAX reference's tokens
    golden = G.load()
    cfg = G.config()
    model = build(cfg)
    params = convert.lm_params_to_torch(convert.numpy_lm_params(cfg, G.SEED),
                                        dev, torch.float32)
    logits = [G.teacher_forced(model, params, r["prompt"], r["tokens"])
              for r in golden["requests"]]
    res = G.compare(golden, logits, GOLDEN_TOL)
    eng = Engine(model, params, max_len=G.MAX_LEN, slots=G.SLOTS).generate(
        [Request(prompt=np.asarray(r["prompt"], np.int32),
                 max_new_tokens=G.NEW_TOKENS) for r in golden["requests"]])
    margins = [r["margins"] for r in golden["requests"]]
    eng_div = [reference.divergence(e.out.tolist(), r["tokens"], m,
                                    2 * GOLDEN_TOL)
               for e, r, m in zip(eng, golden["requests"], margins)]
    log(f"  (1) golden {cfg.name} {G.REDUCED}: {res['steps']} teacher-forced"
        f" steps, top-5 max abs err {res['max_abs_err']:.3g} (tol "
        f"{GOLDEN_TOL}), {res['near_ties']} steps with a top-1/top-2 margin"
        f" <= {2 * GOLDEN_TOL}, greedy mismatches {res['mismatches']}; "
        f"engine (slots={G.SLOTS}) divergences {eng_div}")
    if res["max_abs_err"] > GOLDEN_TOL or res["mismatches"] or any(
            d is not None and not d[2] for d in eng_div):
        raise AssertionError(f"the golden serving run disagrees: {res} "
                             f"{eng_div}")
    rec["golden"] = dict(res, engine_divergence=eng_div)
    del params, logits

    # (2) the full model: engine against the serial run, f32 then bf16
    reqs = serve_requests(granite_moe_1b.CONFIG.vocab)
    lens = [len(r.prompt) for r in reqs]
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(granite_moe_1b.CONFIG, dtype=dtype)
        model = build(cfg)
        t0 = time.perf_counter()
        params = model.init(0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_par = sum(x.numel() for x in _leaves(params))
        serial = [reference.serial_generate(model, params, r.prompt,
                                            r.max_new_tokens, SERVE_MAX_LEN)
                  for r in reqs]
        engine = Engine(model, params, max_len=SERVE_MAX_LEN,
                        slots=SERVE_SLOTS)
        if dtype == "bfloat16":
            engine.generate([Request(prompt=reqs[1].prompt,
                                     max_new_tokens=4)])   # warm-up
            for f in counters:
                f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate([Request(prompt=r.prompt,
                                       max_new_tokens=r.max_new_tokens)
                               for r in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in counters}
        tol = 0.0 if dtype == "float32" else BF16_MARGIN
        div = [reference.divergence(o.out.tolist(), s[0], s[1], tol)
               for o, s in zip(out, serial)]
        below = sum(m <= BF16_MARGIN for _, ms in serial for m in ms)
        n_tok = sum(len(o.out) for o in out)
        log(f"  (2) {cfg.name} {cfg.n_layers} layers {dtype}: "
            f"{n_par / 1e9:.3f} B parameters, init {init_s:.2f} s; "
            f"engine slots={SERVE_SLOTS} max_len={SERVE_MAX_LEN}, prompts "
            f"{lens}: {n_tok} tokens in {wall:.3f} s; divergences from "
            f"the serial run (step, margin, allowed): {div}; serial steps "
            f"with margin <= {BF16_MARGIN}: {below}")
        if any(d is not None and (dtype == "float32" or not d[2])
               for d in div):
            raise AssertionError(f"{dtype} engine != serial run: {div}")
        rec[dtype] = {"wall_s": wall, "tokens": n_tok, "divergence": div,
                      "serial_steps_below_margin": below,
                      "init_s": init_s, "params": n_par,
                      "first_tokens": [o.out[:8].tolist() for o in out]}
        if dtype == "float32":
            del params, engine, serial, out
            torch.cuda.empty_cache()
            continue
        rec["launches"] = launches
        rec["tokens_per_s"] = n_tok / wall
        log(f"    launches in that run: {launches}")
        if not all(launches.values()):
            raise AssertionError(f"a serving kernel never launched: "
                                 f"{launches}")

        # (3) where the time goes, bf16
        pre = []
        for r in reqs:
            tok = torch.as_tensor(r.prompt[None].astype(np.int64),
                                  device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = model.prefill(params, {"tokens": tok})
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
        stacked = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN, dev)
        for i, r in enumerate(reqs[:SERVE_SLOTS]):
            _, cache = model.prefill(params, {"tokens": torch.as_tensor(
                r.prompt[None].astype(np.int64), device=dev)})
            insert(stacked, model.grow_cache(cache, SERVE_MAX_LEN), i)
        kv = torch.tensor(lens[:SERVE_SLOTS], dtype=torch.int32, device=dev)
        tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)

        def step():
            model.decode_step(params, stacked, tok, kv,
                              moe_groups=SERVE_SLOTS)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        n_steps = 20
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        busy_s, kernels = device_busy(torch, step)
        idle = 1.0 - busy_s * 1e3 / step_ms
        top = sorted(kernels, key=_dev_us, reverse=True)[:8]
        # the longest prompt's prefill under the profiler: where the
        # attention kernel's time sits in it
        ptok = torch.as_tensor(reqs[0].prompt[None].astype(np.int64),
                               device=dev)
        pre_busy_s, pre_kernels = device_busy(
            torch, lambda: model.prefill(params, {"tokens": ptok}))
        rec.update({"prefill_ms": pre, "decode_ms_per_step": step_ms,
                    "decode_busy_ms": busy_s * 1e3, "decode_idle_share": idle,
                    "decode_kernel_launches": sum(e.count for e in kernels),
                    "decode_top": [{"name": e.key[:60], "count": e.count,
                                    "device_ms": _dev_us(e) / 1e3}
                                   for e in top],
                    "decode_port_kernels": _port_kernels(kernels),
                    "prefill_longest_busy_ms": pre_busy_s * 1e3,
                    "prefill_longest_port_kernels": _port_kernels(
                        pre_kernels)})
        log(f"  (3) bf16 prefill ms per request (prompt lengths {lens}): "
            f"{[round(x, 3) for x in pre]}; decode {step_ms:.3f} ms per "
            f"step ({SERVE_SLOTS} slots); {rec['tokens_per_s']:.1f} "
            f"tokens/s over the engine run")
        log(f"    one decode step under torch.profiler: device busy "
            f"{busy_s * 1e3:.3f} ms of {step_ms:.3f} ms: idle share "
            f"{idle:.4f}; {rec['decode_kernel_launches']} kernel launches")
        for t in rec["decode_top"]:
            log(f"    {t['device_ms']:9.3f} ms  x{t['count']:5d}  "
                f"{t['name']}")
        log(f"    the port's kernels in that step: "
            f"{rec['decode_port_kernels']}")
        log(f"    prefill of {lens[0]} tokens under torch.profiler: device "
            f"busy {rec['prefill_longest_busy_ms']:.3f} ms; the port's "
            f"kernels: {rec['prefill_longest_port_kernels']}")
    return rec


# the __global__ functions of csrc/ that the serving path launches
PORT_KERNELS = ("rmsnorm_rows_kernel", "wgmma_kernel", "flash_kernel",
                "decode_kernel", "topk_router_kernel")


def _port_kernels(kernels) -> dict:
    """{kernel: [launches, device ms]} of the port's serving kernels
    among torch.profiler's CUDA kernel records."""
    out = {}
    for e in kernels:
        for name in PORT_KERNELS:
            if f"::{name}" in e.key:
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + e.count, ms + _dev_us(e) / 1e3)
    return {k: [n, round(ms, 6)] for k, (n, ms) in out.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def delta_sync_path(torch, SF) -> tuple:
    """Phase 8: the cross-pod delta sync, 4 pods stacked on the card.
    Returns (records per bank, the selective_flush kernel entry at the
    granite embedding bank's shape, with the checked run's launches)."""
    from repro_torch.distributed import delta_sync as DS
    from repro_torch.distributed import hier_sync as HS
    dev = torch.device("cuda")
    golden = {r["bank"]: r for r in DS.load_golden()["banks"]}
    t0 = time.perf_counter()
    banks = DS.bench_banks() + [DS.example_bank(),
                                DS.granite_embedding_bank()]
    log(f"  banks drawn in {time.perf_counter() - t0:.2f} s (numpy)")

    # the checked run: every bank in every mode, launch count 0 before
    SF.selective_flush.launches = 0
    checks = [DS.check_bank(b, golden.get(b.label), dev) for b in banks]
    launches = SF.selective_flush.launches
    log(f"    launches of selective_flush in that run: {launches}")
    if not launches:
        raise AssertionError("the delta sync never launched selective_flush")

    recs, entry = [], None
    for b, chk in zip(banks, checks):
        n_pods, nb, bs = b.banks.shape
        banks_t, st0 = DS.stacked(b, dev)
        wall = {}
        for mode in DS.MODES:
            fn = DS.sync_fn(b, mode)
            fn(banks_t, st0)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(banks_t, st0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            wall[mode] = sorted(times)[2]
        # where a selective f32 sync's time goes: device busy vs wall
        busy_s, kern = device_busy(torch, lambda: DS.sync_fn(
            b, "selective_f32")(banks_t, st0))
        top = sorted(kern, key=_dev_us, reverse=True)[:5]
        prof = {"device_busy_ms": busy_s * 1e3,
                "idle_share": 1.0 - busy_s * 1e3 / wall["selective_f32"],
                "kernel_launches": sum(e.count for e in kern),
                "top": [{"name": e.key[:60], "count": e.count,
                         "device_ms": _dev_us(e) / 1e3} for e in top]}
        # the f32 flush's own inputs: the flattened delta and the list
        idx, _ = HS.dirty_list(HS.dirty_mask(banks_t, st0).any(0),
                               b.max_dirty)
        flat = (banks_t - st0.ref).reshape(n_pods * nb, bs)
        fidx = HS.flat_list(idx, n_pods, nb)
        clipped = fidx.clamp(0, n_pods * nb - 1).long()
        got = SF.selective_flush(flat, fidx)
        want = SF.selective_flush_ref(flat, fidx)
        if not bits_equal(torch, got, want):
            raise AssertionError(f"selective_flush disagrees at {b.label}")
        err = max_abs_err(got, want)
        del want
        k, valid = fidx.shape[0], int((fidx >= 0).sum())
        b_ms, b_by = bound((k + valid) * bs * 4 + 4 * k, 0)
        rec = {"bank": b.label, "pods": n_pods, "n_blocks": nb,
               "block": bs, "max_dirty": b.max_dirty, "check": chk,
               "bytes_ratio": chk["selective_f32"]["bytes_selective"]
               / chk["selective_f32"]["bytes_full"],
               "sync_ms": wall, "selective_f32_profile": prof,
               "flush_rows": k, "flush_valid_rows": valid,
               "ms": T.device_ms(lambda: SF.selective_flush(flat, fidx)),
               "eager_ms": T.eager_ms(lambda: SF.selective_flush(flat,
                                                                 fidx)),
               "plain_ms": T.device_ms(lambda: SF.selective_flush_ref(
                   flat, fidx)),
               "library_ms": T.device_ms(lambda: torch.index_select(
                   flat, 0, clipped)),
               "bound_ms": b_ms, "bound_by": b_by}
        log(f"  {b.label:18s} {n_pods}x{nb}x{bs} max_dirty={b.max_dirty}: "
            f"listed {chk['listed']}, overflow {chk['overflow']}, bytes "
            f"ratio {rec['bytes_ratio']:.6f}; mean err f32 "
            f"{chk['selective_f32']['mean_err']:.3g} int8 "
            f"{chk['selective_int8']['mean_err']:.3g} full "
            f"{chk['full']['mean_err']:.3g}; sync ms selective_f32 "
            f"{wall['selective_f32']:.4f} int8 {wall['selective_int8']:.4f}"
            f" full {wall['full']:.4f}")
        log(f"    selective_f32 under torch.profiler: device busy "
            f"{prof['device_busy_ms']:.4f} ms, idle share "
            f"{prof['idle_share']:.4f}, {prof['kernel_launches']} kernel "
            f"launches; top: " + "; ".join(
                f"{t['name'][:40]} x{t['count']} {t['device_ms']:.4f} ms"
                for t in prof["top"][:3]))
        log(f"    flush [{n_pods * nb},{bs}] f32, {k} rows ({valid} valid): "
            f"{rec['ms']:.5f} ms/call (plain {rec['plain_ms']:.5f}, "
            f"index_select {rec['library_ms']:.5f}), eager "
            f"{rec['eager_ms']:.5f} ms, bound {b_ms:.7f} ms "
            f"({b_by})")
        recs.append(rec)
        if b.label == "granite_embedding":
            entry = {"name": "selective_flush", "route": "cuda",
                     "source": "src/repro_torch/csrc/selective_flush.cu",
                     "replaces": "src/repro/kernels/selective_flush/"
                                 "kernel.py:38",
                     "launches": launches, "max_abs_err": err,
                     "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                     "eager_ms": rec["eager_ms"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": rec["library_ms"],
                     "shape": f"delta [{n_pods * nb},{bs}] f32, {k} rows "
                              f"({valid} valid)",
                     "library_note": "torch.index_select on the clipped "
                                     "list; it leaves pad rows unzeroed"}
        del banks_t, st0, flat, got
        torch.cuda.empty_cache()
    return recs, entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record as JSON to this path")
    ap.add_argument("--bool-layout-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    global T
    try:
        from repro_torch.configs import granite_moe_1b
        from repro_torch.kernels import cases as C
        from repro_torch.kernels import common
        from repro_torch.kernels import timing as T
        from repro_torch.kernels.flash_attention import ops as FA
        from repro_torch.kernels.flash_decode import ops as FD
        from repro_torch.kernels.fused_turn import ops as FT
        from repro_torch.kernels.rmsnorm import ops as RN
        from repro_torch.kernels.selective_flush import ops as SF
        from repro_torch.kernels.topk_router import ops as TR
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if args.bool_layout_child:
        return bool_layout_child(torch, SF, FT)
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
            if "entry function" in line:    # the kernel the next lines are of
                log(f"    {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"    {name}:   {line.strip()}")

    serve_ops = {"rmsnorm": RN, "flash_attention": FA,
                 "flash_decode": FD, "topk_router": TR}
    phase(t_start, "[3] kernels against their plain versions on the card")
    errs = check_kernels(torch, C, SF, FT)
    phase(t_start, "[3] the serving kernels")
    errs.update(check_serving_kernels(torch, C, serve_ops))

    phase(t_start, "[4] main path: the simulator's workloads through "
                   "run_cell")
    counters = (SF.drain_writeback, FT.plane_commit, FT.trip_plan)
    cells = main_cells()
    rows = run_cells(cells, counters)
    launches = {f.__name__: f.launches for f in counters}
    log(f"    launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    phase(t_start, "[4] co-scheduled remote batches")
    batches = remote_batches()
    phase(t_start, "[4] the bool metadata layout, REPRO_NO_PACK=1 in a "
                   "child process")
    bool_run = run_bool_layout()
    launches["drain_writeback_bool"] = \
        bool_run["launches"]["drain_writeback_bool"]

    phase(t_start, "[5] kernel times at the n=64 shapes and the serving "
                   "shapes")
    lens = [len(r.prompt) for r in serve_requests(
        granite_moe_1b.CONFIG.vocab)]
    # the serving kernels first: `measure` traces, and no time is taken
    # after a trace in this phase
    serving, one_op = measure_serving(torch, C, serve_ops, errs, lens)
    kernels = measure(torch, C, SF, FT, errs, launches) + serving
    check_one_op(one_op)

    phase(t_start, "[6] where the time goes: one fused n=64 srsp run "
                   "under torch.profiler")
    prof = [profile_cell(torch, w, rows[cells.index((
        w, "srsp", N_MAIN, 4, "fused"))]["steady_s"])
        for w in PROFILED]

    phase(t_start, "[7] serving path: granite-moe-1b-a400m through "
                   "repro_torch.serve.engine")
    counters = [RN.rmsnorm, FA.flash_attention, FD.flash_decode,
                TR.topk_router]
    serve = serve_path(torch, counters)
    for rec in kernels:
        if rec["launches"] is None:
            rec["launches"] = serve["launches"][rec["name"]]

    phase(t_start, "[8] cross-pod delta sync: make_pod_sync, 4 pods "
                   "stacked on the card")
    sync_recs, flush_entry = delta_sync_path(torch, SF)
    kernels.append(flush_entry)
    total_s = time.perf_counter() - t_start
    log(f"    total {total_s:.1f} s")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "build_s": build_s, "cells": rows,
                       "remote_batches": batches,
                       "bool_layout": bool_run,
                       "kernels": kernels, "profile": prof,
                       "serve": serve, "delta_sync": sync_recs,
                       "total_s": total_s,
                       "ptxas": reports}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
