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
     (its REPRO_NO_PACK=1 instance, `drain_writeback_bool`); and the
     replica instances (`drain_writeback_many`, `drain_writeback_bool_many`,
     `plane_commit_many`, `trip_plan_many`: a leading replica axis, one
     launch for every replica) on `cases.*_MANY_CASES`, stacked inputs
     at R = 1, 2, 64 with idle replicas beside busy ones, bitwise;
  4. the main path: the simulator's workloads through `run_cell` with
     every launch count set to 0 first, held bitwise (every counter,
     `events`, `check_ok`, `check_fails`) against the JAX reference's
     golden files (`src/repro_torch/golden/<workload>.json`):
     kv_directory n=64 srsp/rsp/baseline on the fused engine at seed 4
     (seed 0 was cut for phase 9's time), n=64 srsp on the batched
     engine (the serial one was cut for phase 10's time), n=256 srsp
     fused; reader_lock, producer_consumer and producer_consumer_mc at
     n=64 srsp/rsp/baseline fused, srsp batched, and n=16 srsp serial,
     rsp/baseline fused and the scope_only staleness demo (check red);
     worksteal (the paper's §5.1 harness) at n=64 seed 2 under all five
     scenarios fused and srsp batched, at n=16 seed 1 srsp serial and
     rsp/baseline/scope_only fused; kv_serving on the lock and queue
     grid at seed 4 but its n=64 rsp fused and srsp batched cells
     (`MAIN_SKIPPED`, cut for phase 10's time), each cell replaying the
     request trace the reference
     generated for it (`golden/kv_serving_traces.npz`); each cell's
     `steady_s` and launches per run (a warm-up run before each
     workload's first cell only).  Then worksteal's app drivers,
     `run_app` at the paper's 64 CUs (PageRank on collab_like(8192),
     SSSP on road_like(8192), MIS on router_like(8192); srsp and rsp,
     two iterations), held to `golden/worksteal.json`'s records and
     `worksteal_apps.npz`'s solutions.  Then the full-width kv_serving
     cell (n=64, 256 requests per agent, zipf 1.2, burstiness 4, srsp
     fused, seed 4): the port's own trace drawn on the card and held to
     the reference's (`trace.compare`: keys and kinds exact, arrival
     clocks within `arrival_rtol`) and served to a green check, then
     the timed run on the reference's trace, held to its golden cell.
     Then the elastic engines (`golden/churn.json`, written by the JAX
     reference): crash red/green pairs (a crash fault of
     `workloads.faults` with the recovery drain `b_recover` on, and
     under `lease_never_expires`) of kv_directory, reader_lock,
     producer_consumer, kv_serving (its golden trace) and worksteal at
     n=64 and at the n=4 pins, the sweep's two churned rows through
     `sweep.measure_churned` (worksteal 1179.5; kv_serving 2307.369873046875
     on its legacy-layout trace), a zero-churn kv_directory n=64 cell
     (also equal to kv_directory's golden fused cell) and leave/join
     cells (n=64 batched, n=16 serial and batched), each held with `==`
     (counters, check, done/completed/offered, recoveries, the final
     alive mask; kv_serving's n=64 red control, `CHURN_SKIPPED`, was cut
     for phase 9's time), with its `steady_s`, loop passes and drain_writeback /
     plane_commit launches per run logged (zeroed before each cell).
     Then the trace ring (`obs.trace`): the n=64 srsp fused cell of each
     of five workloads (worksteal at seed 2; producer_consumer's was cut
     for phase 10's time) run untraced and with
     `trace.with_trace` at TRACE_CAP slots, each timed once (the three
     alternated repeats of kv_directory and kv_serving were cut for phase
     9's time): each traced run's
     non-trace leaves bitwise the untraced run's, its counters the
     golden cell's, its decoded events, head (so dropped: kv_serving's
     ring wraps), op_hist and turn_hist `==` `golden/trace.npz`, and
     every kernel launching as often traced as untraced; then the trace
     report's demo (worksteal n=4, a crash and its recovery drain) in
     process, its Chrome-trace document `==` the reference's
     (`golden/trace.json`), and `python3 -m repro_torch.obs.report
     --demo` in a child process printing the reference's report; and
     the eager time of one traced `record_op` at n=64.
     Then the replica axis, in a child process (so that the process
     that traces with torch.profiler in phases 5 and 6 never runs the
     replica engines): the cells of `golden/many.json` (the
     reference's `run_fused_many`/`run_batched_many` at n=64 over seeds 4
     and 5: srsp fused for four vmappable workloads, kv_serving on
     its golden traces, kv_directory srsp batched, producer_consumer_mc
     batched with and without `faults.serialize_remote`; kv_directory's
     rsp/baseline fused and producer_consumer's cells, `MANY_SKIPPED`,
     were cut for phase 10's time) through `sweep.run_vmapped_cell`, after
     one warm-up run, every lane held with `==`, with each cell's
     `steady_s_per_run`, `steady_s_per_replica`, trips and launches a
     run logged (`trip_plan_many` once a pass of the fused runs, the
     `remote_batch_ab` pair's makespans equal); kv_serving at the golden
     size as one fused replica run of SERVING_REPLICAS replicas (seeds
     4, 5, ...): lane 0 on the reference's trace, held to the golden
     cell, the others on the traces the port draws on the card, every
     lane green; and kv_directory's replica cell traced (each solo state
     given TRACE_CAP slots, then stacked), each lane's trace `==` its
     seed's golden trace, its launches the untraced cell's.
     Every kernel must have launched in these paths, each path's launch
     counts set to 0 just before it and read just after.  Then one fused
     producer_consumer_mc srsp n=64 run records the size of each
     co-scheduled remote batch: some must hold two or more drains.  Then
     the bool metadata layout: a child process with REPRO_NO_PACK=1 runs
     kv_directory, the three lock and queue workloads, worksteal (seed
     2) and kv_serving (its golden trace) at n=64 srsp fused and the
     kv_directory n=64 crash_dirty red/green pair of `churn.json` and
     the kv_directory srsp fused replica cell of `many.json`, held to
     the same golden cells, with the launch counts set to 0 first: the
     bool drain kernel, its replica instance and trip_plan must launch
     (bool planes take plane_commit's plain version, as in the
     reference), the packed drain kernels must not; the child also runs
     kv_directory's traced cell, held to the same golden trace; the
     child's failure fails the run.  Then the sweep: a child process
     with REPRO_TRACE=1 runs `python3 -m repro_torch.workloads.sweep`
     (its `main`) at the argv of `golden/sweep.json` (the reference's
     schema-v8 document at sizes 4 and 8: every workload and scenario,
     fused srsp rows, both churned rows, the serving comparison, the
     three A/Bs, the packed-metadata one in grandchildren at
     REPRO_NO_PACK=0 and 1), replaying the reference's kv_serving traces
     (`golden/sweep_traces.npz`), without the untimed warm-up calls,
     with the launch counts set to 0 first: the command's own `check_doc` must pass, every modeled
     column must equal the golden document's (`sweep_doc.modeled`), and
     every simulator kernel and replica instance must launch.  The same
     child then runs a full-width slice of the default sweep
     (`SWEEP_FULL_ARGV`: producer_consumer_mc and worksteal, srsp
     batched and fused at n=64, worksteal's churned row and
     `remote_batch_ab` at n=64 (`fuse_ab` at n=64 was cut for phase 9's
     time, `pack_ab` at 64 WGs for phase 10's), the reference's
     seeds and timed calls) through `sweep.run_sweep`, each row held
     with `==` to the committed `BENCH_workloads.json` row of its label
     in makespan, counters, check_ok, check_fails and events;
  5. per kernel at the n=64 shapes and at n=256 (`fuse_ab`'s), the
     replica instances at R = 2 and 64 of those shapes: device
     time per call of the kernel and of its plain version (CUDA graph
     replay timed with CUDA events, `repro_torch.kernels.timing`), eager
     time per call (host launch included), the least time the card could
     take (bytes over 3.35 TB/s, or operations over 67 TOP/s), the
     launches of phase 4, and the device operations one call makes under
     torch.profiler: exactly one kernel record, no memset or fill, for
     both drain_writeback instances, plane_commit and trip_plan and
     their replica instances, and for rmsnorm and topk_router at their
     decode and prefill shapes;
  6. the device's busy time and idle share over one fused n=64 srsp run
     of kv_directory (the other workloads' profiles were cut to make room
     for phase 9), traced with CUDA activity alone (operator records
     would make the trace slow to collect), and the device operations
     one traced `record_op` and
     one `record_turn` add (torch.profiler);
  7. the serving path of granite-moe-1b-a400m (`repro_torch.serve`):
     (1) the golden config (full width, 2 layers, float32, numpy
     weights) teacher-forced on `golden/granite_moe_serve.json`'s tokens,
     top-5 logits within GOLDEN_TOL of the JAX reference's and greedy
     tokens equal wherever the margin exceeds 2 * GOLDEN_TOL; (2) the
     model at full width, depth 24 cut to SERVE_LAYERS (8, for phases
     10 and 11's time), weights from a seeded torch.Generator on the
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
     its plain version and `torch.index_select`, bitwise checked;
  9. training granite-moe-1b-a400m (`repro_torch.train`), in a child
     process with PyTorch's deterministic algorithms on
     (`trainer.deterministic`): (1) one full-width block, dense and MoE,
     float32, through torch.autograd, every gradient (parameters and
     input) within GRAD_CHECK_TOL of relative norm of the same block
     with every kernel swapped for its plain version, and one lm_loss
     step of the bf16 model at full width and TRAIN_LAYERS layers (24 cut
     to 12 for phase 11's time) with a finite, nonzero gradient in every
     parameter leaf; (2) the golden run (full width, 2
     layers, float32, numpy weights, 3 AdamW steps of 2 x 64 tokens in
     microbatches of 1) on the golden's batches, loss, aux, gnorm and
     every leaf's norm within `train.golden.GRANITE.tol` of
     `golden/granite_moe_train.json` (the JAX package's run); (3) the
     full run through `Trainer`: TRAIN_LAYERS layers, bf16, batch 8 x 256 in
     microbatches of 4, AdamW, remat full, 1 warm-up and 4 timed steps
     with the training kernels' launch counts set to 0 just before and
     read just after (the kernels line's `launches` of the training
     kernels), finite losses, step ms (median), tokens/s, peak memory,
     launches a step, then one step under torch.profiler (device busy
     time, idle share), then two runs of the same 2 steps, bitwise equal
     in loss and parameters; (4) `Trainer` at the golden size with a
     checkpoint every 2 steps and a failure at step 2: one restart, and
     the final parameters bitwise the uninterrupted run's;
 10. serving the dense configs (`repro_torch.configs.qwen2_5_32b`,
     `qwen1_5_32b`, `mistral_large_123b`: head dim 128, QKV bias in the
     qwens, GQA groups 5, 1 and 12), in a child process, one model at a
     time: (1) qwen2.5-32b's golden run (full width, depth 64 -> 2,
     float32, numpy weights with nonzero QKV biases, ~10.1 GB) held to
     `golden/qwen2_5_serve.json` as phase 7 (1) holds granite's; (2)
     qwen2.5-32b at full width, depth 64 -> DENSE_TIMED_LAYERS (8),
     bf16, `lm_init` on the card: phase 7's 8 requests through the
     engine, equal to the serial run wherever its margin exceeds
     BF16_MARGIN, with the dense kernels' launch counts set to 0 just
     before and read just after; tokens/s, prefill ms, decode ms a step,
     launches a step by kernel, device busy time and idle share; (3)
     qwen1.5-32b and mistral-large-123b at full width, depth ->
     DENSE_CHECK_LAYERS (2): 4 requests in float32, engine == serial run
     token for token, then in bf16, equal wherever the serial margin
     exceeds BF16_MARGIN; every dense kernel launched in every run;
 11. training the dense configs, in a child process with PyTorch's
     deterministic algorithms on: (1) one full-width block of each
     (qwen2.5-32b: d 5120, 40/8 heads, QKV bias drawn nonzero;
     qwen1.5-32b: 40/40, bias; mistral-large-123b: d 12288, 96/8) on a
     [4, 256, d] input, in float32 and in bf16, every gradient within
     DENSE_GRAD_TOL of relative norm of the same block through the plain
     versions (as phase 9 (1)); (2) mistral-large-123b's golden run (full
     width, depth 88 -> 1, float32, numpy weights, 3 Adafactor steps of
     2 x 64 tokens: the float32 D=128 backward and GQA group 12) held to
     `golden/mistral_large_train.json` (the JAX package's run) within
     `train.golden.MISTRAL_LARGE.tol`, a second run bitwise the first,
     and phase 9 (4)'s restart at that size; (3) `Trainer` on qwen2.5-32b
     at full width, depth 64 -> DENSE_TRAIN_LAYERS (4), bf16, AdamW,
     phase 9's batch shape: 1 warm-up and 4 timed steps with the training
     kernels' launch counts set to 0 just before and read just after
     (`flash_attention_bwd` once a layer a microbatch a step), step ms,
     tokens/s, peak memory, launches a step, one step under
     torch.profiler (idle share, device time by name), every leaf's
     gradient finite and nonzero; (4) qwen1.5-32b (AdamW) and
     mistral-large-123b (Adafactor) at depth DENSE_TRAIN_CHECK_LAYERS
     (2), bf16, DENSE_TRAIN_CHECK_STEPS (2) steps each: finite losses,
     the backward kernels launched, every leaf's gradient finite and
     nonzero.

Phases 3 and 5 cover the training kernels too (`flash_attention`'s
training instance `flash_attention_lse`, and `flash_attention_bwd`,
`rmsnorm_bwd`, `topk_router_bwd`): phase 3 holds them to their plain
versions on `cases.TRAIN_ATTN_CASES`, `RMS_BWD_CASES` and
`ROUTER_BWD_CASES` (S 1-300, GQA groups 1-16, D 16, 64 and 128, the
dense configs' training shapes, bf16 and float32; one rmsnorm row, odd
widths, d 5120 and 12288; router k = 1, k = E, ties); phase 5 times them
at the full run's microbatch shapes beside their bound, the plain versions and the backward of
scaled_dot_product_attention and of F.rms_norm, and the dense configs'
training instances at their microbatch (`timing.dense_train_calls`:
`flash_attention_lse[D=128]`, `flash_attention_bwd[D=128 bf16]` a shape
a config with the kernel's registers and spilled bytes,
`flash_attention_bwd[D=128 float32]`, `rmsnorm_bwd[d=5120,12288]`),
which take their launches from phase 11.

Phases 3 and 5 cover the dense configs' instances too: phase 3 holds
attention at D=128 (the bf16 wgmma kernel, two 64-column panels a tile;
float32 on CUDA cores, 4 lanes a row) and decode at D=128, GQA groups 1,
5 and 12 (bf16: the tensor-core instance, one cluster a (row, kv-head),
also at groups 8, 16 and 20 and over a 32,768-position cache; float32:
clusters of at most 4 heads a kv-head), both types, to their plain
versions, and checks that a bf16 D=128 q off 16 bytes raises, that
attention with grad on at D=128 runs the backward kernel and meets the
plain version's gradients, and that at D=160 it raises before any
launch; phase 5 times them at the dense serving shapes
(`timing.dense_calls`: qwen2.5-32b's prefill of 256 tokens, decode at 8
slots over 512-position caches for the three configs, with the decode
launch's clusters, resident clusters, registers and spilled bytes,
rmsnorm at d 5120 and 12288) beside their bound and SDPA's or
F.rms_norm's time; their kernels-line entries (`flash_attention[D=128]`,
`flash_decode[D=128 group g]`, `rmsnorm[d=5120,12288]`) take their
launches from phase 10's bf16 engine runs, the instances they time.

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

Each phase's header prints the seconds since the start, and the end of
the run lists each phase's duration.

The last three lines of standard output are the kernels JSON, the
nvidia-smi line, and {"ok": true, "device": {...}}.  Exits nonzero, and
prints no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
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
# phase 7's engine and serial runs of granite-moe-1b-a400m: depth 24 ->
# 12 (cut to make room for phase 10) -> 8 (for phase 11; the golden run
# holds the full width)
SERVE_LAYERS = 8
# phase 10, the dense configs: qwen2.5-32b's timed run (bf16, depth 64 ->
# 16, ~18.7 GB, -> 8 for phase 11's time), and qwen1.5-32b's and
# mistral-large-123b's engine checks
# (float32, then bf16, depth 64 and 88 -> 2, up to ~14.3 GB) on the first
# requests
DENSE_TIMED_LAYERS = 8
DENSE_CHECK_LAYERS = 2
DENSE_CHECK_REQUESTS = 4
T = None                        # repro_torch.kernels.timing, set by main
# phase 4: (workload, scenario, n_agents, seed, engine[, trace]); the
# lock and queue workloads, worksteal and kv_serving run every cell of
# their golden files, a kv_serving cell replaying the request trace the
# reference generated for it (`trace`, in golden/kv_serving_traces.npz)
# (kv_directory's n=64 serial cell, 6.7 s of steady time, was cut for
# phase 10's time: the serial engine runs every n=16 serial cell below)
KV_CELLS = ([("kv_directory", s, N_MAIN, 4, "fused")
             for s in ("srsp", "rsp", "baseline")]
            + [("kv_directory", "srsp", N_MAIN, 4, "batched"),
               ("kv_directory", "srsp", 256, 4, "fused")])
# golden cells phase 4 leaves out, (workload, scenario, n, engine):
# kv_serving's n=64 rsp fused and srsp batched cells (7.6 s and 6.4 s of
# steady time; rsp and the batched engine run in every other workload's
# n=64 grid and in kv_serving's n=16 cells), cut for phase 10's time
MAIN_SKIPPED = (("kv_serving", "rsp", 64, "fused"),
                ("kv_serving", "srsp", 64, "batched"))
LOCK_QUEUE = ("reader_lock", "producer_consumer", "producer_consumer_mc")
GOLDEN_WORKLOADS = LOCK_QUEUE + ("worksteal", "kv_serving")
TRACES = os.path.join(ROOT, "src", "repro_torch", "golden",
                      "kv_serving_traces.npz")
# phase 6's cells, (workload, seed): the profiler's cost grows with a
# run's kernel records, so only kv_directory is profiled (the other two
# cells took 65.6 s of the 1200 s limit that the training phase needs;
# PERF.md §6 gives each depth cut's seconds)
PROFILED = (("kv_directory", 4),)
# the churn cell phase 4 leaves out: kv_serving's n=64 red control, the
# slowest cell of the run (47.2 s of steady time on a slow host); its
# n=4 pin stays red on both trace layouts (cut for phase 9's time)
CHURN_SKIPPED = ("kv_serving n=64 seed=4 batched_elastic "
                 "crash_holding_lock@0:30.0 crash@180.0 red",)
# the churn cells the bool-layout child runs (names in golden/churn.json)
BOOL_CHURN = ("kv_directory n=64 seed=4 batched_elastic crash_dirty@2:60.0 "
              "crash@120.0 green",
              "kv_directory n=64 seed=4 batched_elastic crash_dirty@2:60.0 "
              "crash@120.0 red")
# the sweep's churned rows (`sweep.measure_churned`) among the churn cells:
# {which: (workload, n_agents, layout of its trace)}
CHURNED_ROWS = {"worksteal": ("worksteal", 4, "partitionable"),
                "kv_serving": ("kv_serving", 4, "legacy")}
# the bool-layout child's cells
BOOL_CELLS = ([(w, "srsp", N_MAIN, 4, "fused")
               for w in ("kv_directory",) + LOCK_QUEUE]
              + [("worksteal", "srsp", N_MAIN, 2, "fused"),
                 ("kv_serving", "srsp", N_MAIN, 4, "fused",
                  "n64_seed4_default")])
# the sweep phase: `repro_torch.workloads.sweep` at the argv of the
# reference's document in golden/sweep.json, on the traces of
# golden/sweep_traces.npz
SWEEP_GOLDEN = os.path.join(ROOT, "src", "repro_torch", "golden",
                            "sweep.json")
SWEEP_TRACES = os.path.join(ROOT, "src", "repro_torch", "golden",
                            "sweep_traces.npz")
# and a full-width slice of the default sweep, held to the committed
# document of the reference's default run, with `pack_ab` and
# `remote_batch_ab` at 64 (`fuse_ab` at 64, 39.1 s of steady time on a
# slow host, was cut for phase 9's time; the golden argv still holds it
# at its sizes)
# (`pack_ab` at 64, run in two grandchildren, was cut for phase 10's time;
# the golden argv holds it at its sizes)
SWEEP_FULL_ARGV = ["--workloads", "producer_consumer_mc", "worksteal",
                   "--scenarios", "srsp", "--sizes", "64", "--no-serving",
                   "--no-pack-ab", "--remote-batch-sizes", "64",
                   "--no-fuse-ab"]
SWEEP_COMMITTED = os.path.join(ROOT, "BENCH_workloads.json")
# phase 9, training granite-moe-1b-a400m: the full run's shape (bf16,
# remat full, AdamW; depth 24 -> TRAIN_LAYERS, cut for phase 11's time)
# and the block of the gradient check
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 256, 4
TRAIN_LAYERS = 12
TRAIN_STEPS = 5                 # 1 warm-up step, then 4 timed
GRAD_CHECK_SHAPE = (2, 128)     # (B, S) of the one-block gradient check
GRAD_CHECK_TOL = 1e-4           # float32, relative norm of a leaf's error
# phase 11, training the dense configs: the gradient check's input (a
# microbatch of 4 x 256 tokens at each config's full width).  In bf16 the
# kernels and the plain versions round to bf16 at other points: a kernel's
# output may sit one bf16 ulp (2^-8 relative) off the plain version's,
# and a gradient leaf passes two such rounding points (the operation's
# output, then the leaf's own bf16 sum), so the two runs may differ by
# 2 x 2^-7 of relative norm (measured 4.3e-3 to 7.6e-3); float32 is held
# to GRAD_CHECK_TOL
DENSE_GRAD_SHAPE = (4, 256)
DENSE_GRAD_TOL = {"float32": GRAD_CHECK_TOL, "bfloat16": 2.0 ** -6}
# the timed run: qwen2.5-32b at depth 64 -> DENSE_TRAIN_LAYERS, bf16,
# AdamW, phase 9's batch shape; then qwen1.5-32b and mistral-large-123b
# at depth 64 and 88 -> DENSE_TRAIN_CHECK_LAYERS, bf16, their own
# optimizers, DENSE_TRAIN_CHECK_STEPS steps.  4 layers of qwen2.5-32b
# are 3.51 B parameters (the vocabulary's two 152,064 x 5,120 leaves
# 1.56 B of them): bf16 weights, float32 moments updated in place and
# the float32 gradient sum, which the step drops before the update
DENSE_TRAIN_LAYERS = 4
DENSE_TRAIN_CHECK_LAYERS = 2
DENSE_TRAIN_CHECK_STEPS = 2
# the training kernels' wrappers by name, and the TPU kernel each stands
# beside (the backward kernels replace none: the reference differentiates
# its jnp forms)
TRAIN_KERNELS = ("flash_attention_lse", "flash_attention_bwd",
                 "rmsnorm_bwd", "topk_router_bwd")
TRAIN_REPLACES = {
    "flash_attention_lse": "src/repro/kernels/flash_attention/kernel.py:72",
    "flash_attention_bwd": "backward; no TPU kernel (the reference "
                           "differentiates its jnp forms)",
    "rmsnorm_bwd": "backward; no TPU kernel (the reference differentiates "
                   "its jnp forms)",
    "topk_router_bwd": "backward; no TPU kernel (the reference "
                       "differentiates its jnp forms)"}
# the dense configs' training instances (phases 3, 5 and 11): the
# kernels line's name of each
DENSE_LSE = "flash_attention_lse[D=128]"
DENSE_BWD = {"bfloat16": "flash_attention_bwd[D=128 bf16]",
             "float32": "flash_attention_bwd[D=128 float32]"}
DENSE_RMS_BWD = "rmsnorm_bwd[d=5120,12288]"
DENSE_TRAIN_KERNELS = (DENSE_LSE, DENSE_BWD["bfloat16"],
                       DENSE_BWD["float32"], DENSE_RMS_BWD)
PHASES = []                     # (header, start) of every phase


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(t_start: float, msg: str) -> None:
    """A phase's header, with the seconds since the run started."""
    now = time.perf_counter()
    PHASES.append((msg, now))
    log(f"{msg}  [at {now - t_start:.1f} s]")


def phase_times(t_end: float) -> list:
    """[(header, seconds)] of every phase."""
    ends = [t for _, t in PHASES[1:]] + [t_end]
    return [(m, e - t) for (m, t), e in zip(PHASES, ends)]


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
    errs.update(check_replica_kernels(torch, C, SF, FT, on, cpu))
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


def check_replica_kernels(torch, C, SF, FT, on, cpu) -> dict:
    """Phase 3, the replica instances: each == its plain version on the
    card and on the CPU, bitwise, on the `*_MANY_CASES` lists (stacked
    inputs at R = 1, 2, 64, the edge cases at R = 2 and 3, idle
    replicas beside busy ones)."""
    dev = torch.device("cuda")
    errs = {"drain_writeback_many": 0.0, "drain_writeback_bool_many": 0.0,
            "plane_commit_many": 0.0, "trip_plan_many": 0.0}
    for kernel, fn, bool_mask in (
            ("drain_writeback_many", SF.drain_writeback_many, False),
            ("drain_writeback_bool_many", SF.drain_writeback_bool_many,
             True)):
        for k, (name, kw, reps, idle) in enumerate(C.DRAIN_MANY_CASES):
            xs = C.stacked(C.dw_inputs, reps, k, idle, **kw,
                           bool_mask=bool_mask)
            got = fn(*on(xs))
            torch.cuda.synchronize()
            e = max(max_abs_err(got, SF.drain_writeback_ref(*on(xs))),
                    max_abs_err(got, SF.drain_writeback_ref(*cpu(xs))))
            if e != 0.0:
                raise AssertionError(f"{kernel} {name} disagrees")
            errs[kernel] = max(errs[kernel], e)
        log(f"  {kernel}: {len(C.DRAIN_MANY_CASES)} cases, max_abs_err="
            f"{errs[kernel]}")
    for k, (name, kw, reps, idle) in enumerate(C.COMMIT_MANY_CASES):
        xs = C.stacked(C.pc_inputs, reps, k, idle, **kw)
        args = on(xs)
        got = FT.plane_commit_many(*args)
        torch.cuda.synchronize()
        e = max(max_abs_err(got, FT.plane_commit_ref(*on(xs))),
                max_abs_err(got, FT.plane_commit_ref(*cpu(xs))),
                max_abs_err(args, on(xs)))         # inputs left as they were
        if e != 0.0:
            raise AssertionError(f"plane_commit_many {name} disagrees")
    log(f"  plane_commit_many: {len(C.COMMIT_MANY_CASES)} cases, "
        f"max_abs_err={errs['plane_commit_many']}")
    for k, (name, kw, reps, idle, cap, fenced) in enumerate(
            C.PLAN_MANY_CASES):
        xs = C.stacked(C.plan_inputs, reps, k, idle, **kw)
        hor = C.horizons(xs[0], fenced)
        hor = None if hor is None else torch.from_numpy(hor)
        got = FT.trip_plan_many(*on(xs[:4]), on(xs[4:])[0] if cap else None,
                                None if hor is None else hor.to(dev),
                                remote_cap=cap)
        want = FT.trip_plan_ref(*cpu(xs[:4]), cpu(xs[4:])[0] if cap
                                else None, hor)
        torch.cuda.synchronize()
        if max_abs_err(list(got), list(want)) != 0.0:
            raise AssertionError(f"trip_plan_many {name} disagrees")
    log(f"  trip_plan_many: {len(C.PLAN_MANY_CASES)} cases, max_abs_err="
        f"{errs['trip_plan_many']}")
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
    lock and queue workloads, worksteal and kv_serving at its default
    traffic (the full-width serving cell has a phase of its own)."""
    return KV_CELLS + [
        (w, c["scenario"], c["n_agents"], c["seed"], c["engine"])
        + ((c["trace"],) if "trace" in c else ())
        for w in GOLDEN_WORKLOADS for c in load_golden(w)["cells"]
        if c.get("traffic", "default") == "default"
        and (w, c["scenario"], c["n_agents"], c["engine"])
        not in MAIN_SKIPPED]


def golden_cell(doc, scenario, n, seed, engine, trace=None) -> dict:
    """The golden cell of this engine (and trace), else the cell's fused
    run (the engines' counters are equal; kv_directory's file holds
    fused runs)."""
    cells = [c for c in doc["cells"] if (
        c["scenario"], c["n_agents"], c["seed"], c.get("trace"))
        == (scenario, n, seed, trace)]
    return next((c for c in cells if c["engine"] == engine), cells[0])


def load_traces() -> dict:
    """The golden request traces on the card: {name: (trace, meta)}."""
    from repro_torch.traffic import trace as TT
    return TT.load_set(TRACES, "cuda")


def held(ctx: str, row: dict, ref: dict) -> None:
    """Raise unless `row` has the golden cell's counters, events and
    verdict."""
    for key in ("events", "check_ok", "check_fails"):
        if row[key] != ref[key]:
            raise AssertionError(f"{ctx}: {key} {row[key]} != {ref[key]}")
    if row["counters"] != ref["counters"]:
        raise AssertionError(f"{ctx}: counters {row['counters']} != "
                             f"golden {ref['counters']}")


def run_cells(cells, launch_counters) -> list:
    """The cells through `run_cell` on the card, each held to its golden
    cell (a kv_serving cell on its golden trace); launch counts set to 0
    first.  Only a workload's first cell runs a warm-up run before its
    timed one.  Raises on any difference."""
    from repro_torch.workloads import sweep
    goldens = {w: load_golden(w) for w in {c[0] for c in cells}}
    traces = load_traces() if any(len(c) > 5 for c in cells) else {}
    for f in launch_counters:
        f.launches = 0
    rows, warmed = [], set()
    for workload, scenario, n, seed, engine, *trace in cells:
        before = [f.launches for f in launch_counters]
        kw = {}
        if trace:
            tr, meta = traces[trace[0]]
            kw = {"build_kw": {"traffic": meta["config"]}, "trace": tr}
        warm = workload not in warmed
        warmed.add(workload)
        row = sweep.run_cell(workload, scenario, n, seed, engine,
                             device="cuda", warmup=warm, **kw)
        row["launches_per_run"] = {
            f.__name__: (f.launches - b) // (2 if warm else 1)
            for f, b in zip(launch_counters, before)}
        ref = golden_cell(goldens[workload], scenario, n, seed, engine,
                          *trace)
        ctx = f"{workload} {scenario} n={n} seed={seed} {engine}"
        held(ctx, row, ref)
        log(f"  {workload:20s} {scenario:10s} n={n:3d} seed={seed} "
            f"{engine:7s} makespan={row['makespan']} events={row['events']}"
            f" check_ok={row['check_ok']} steady_s={row['steady_s']} "
            f"launches/run={row['launches_per_run']}")
        rows.append(row)
    return rows


def counted(launch_counters, fn):
    """(fn(), {kernel: launches}): the launch counts set to 0 just before
    the call and read just after it."""
    for f in launch_counters:
        f.launches = 0
    out = fn()
    return out, {f.__name__: f.launches for f in launch_counters}


def churn_proto(cell):
    """A churn cell's protocol: srsp, its crash fault of
    `workloads.faults`, and `lease_never_expires` for a red cell."""
    from repro_torch.core import protocol as P
    from repro_torch.workloads import faults
    proto = P.get_protocol(cell["scenario"])
    if cell["fault"]:
        name, victim, at = cell["fault"]
        proto = getattr(faults, name)(proto, victim, at)
    return proto if cell["recovery"] else faults.lease_never_expires(proto)


def churned_row(cell) -> str:
    """The `measure_churned` name of a cell that is one of the sweep's
    churned rows (green), else None."""
    return next((w for w, (wl, n, layout) in CHURNED_ROWS.items()
                 if cell["recovery"] and cell["fault"]
                 and (cell["workload"], cell["n_agents"], cell["layout"])
                 == (wl, n, layout)), None)


def run_churn(names=None, launch_counters=()) -> list:
    """The cells of `golden/churn.json` but CHURN_SKIPPED (or those
    `names`) on the card,
    each through `sweep.run_cell` (the sweep's churned rows through
    `sweep.measure_churned`, one run) and held with `==` to its golden
    cell:
    counters, events, check verdict and failures, done / completed /
    offered, recoveries and the final alive mask.  Each cell runs once,
    with no warm-up (the kernels are built and loaded by then).  Logs
    each cell's `steady_s`, loop passes and launches (each count read
    before and after the cell), and requires
    drain_writeback and plane_commit launches in every cell where they
    are among `launch_counters`.
    The zero-churn cell must also equal kv_directory's golden fused cell.
    Raises on any difference."""
    from repro_torch.workloads import harness, sweep
    cells = [c for c in load_golden("churn")["cells"]
             if (c["name"] in names if names is not None
                 else c["name"] not in CHURN_SKIPPED)]
    traces = load_traces()
    passes = [0]
    trip = harness._elastic_trip

    def counted_trip(*a, **kw):
        passes[0] += 1
        return trip(*a, **kw)

    harness._elastic_trip = counted_trip
    rows = []
    try:
        for cell in cells:
            kw = dict(cell["build_kw"])
            tr = None
            if "trace" in cell:
                tr, meta = traces[cell["trace"]]
                kw["traffic"] = meta["config"]
            before = [f.launches for f in launch_counters]
            passes[0] = 0
            which = churned_row(cell)
            if which:
                r = sweep.measure_churned(
                    which, 1, "cuda", sweep.trace_map(
                        [traces[cell["trace"]]] if tr is not None else []),
                    warmup=False)
                row = {"counters": r["counters"], "check_ok": r["check_ok"],
                       "check_fails": r["lost_updates"],
                       "completed": r["completed"],
                       "recovered": r["recovered"], "steady_s":
                       r["steady_s_per_run"]}
                got = {k: row[k] for k in ("counters", "check_ok",
                                           "check_fails", "completed")}
                got["recoveries"] = row["recovered"]
            else:
                row = sweep.run_cell(
                    cell["workload"], cell["scenario"], cell["n_agents"],
                    cell["seed"], cell["engine"], device="cuda",
                    build_kw=kw, trace=tr,
                    events=[tuple(e) for e in cell["churn"]],
                    lease=cell["lease"], proto=churn_proto(cell),
                    warmup=False)
                got = {k: row[k] for k in ("counters", "events", "check_ok",
                                           "check_fails", "done",
                                           "completed", "offered", "alive")}
                got["recoveries"] = row["recovered"]
            for key, val in got.items():
                if val != cell[key]:
                    raise AssertionError(f"{cell['name']}: {key} {val} != "
                                         f"golden {cell[key]}")
            launches = {f.__name__: f.launches - b
                        for f, b in zip(launch_counters, before)}
            if not all(launches.get(k, 1) for k in ("drain_writeback",
                                                    "plane_commit")):
                raise AssertionError(f"{cell['name']}: launches {launches}")
            rec = {"cell": cell["name"], "via": "measure_churned"
                   if which else "run_cell",
                   "makespan": row["counters"]["makespan"],
                   "check_ok": row["check_ok"],
                   "recoveries": got["recoveries"],
                   "steady_s": row["steady_s"],
                   "passes": passes[0], "launches": launches}
            log(f"  {cell['name']}: makespan={rec['makespan']} "
                f"check_ok={rec['check_ok']} recoveries={rec['recoveries']}"
                f" steady_s={rec['steady_s']} passes={rec['passes']} "
                f"launches={launches}"
                + (f" [{rec['via']}]" if which else ""))
            rows.append(rec)
    finally:
        harness._elastic_trip = trip
    if names is None:
        zero = next(c for c in cells if not c["churn"])
        kv = golden_cell(load_golden("kv_directory"), "srsp", N_MAIN, 4,
                         "fused")
        if zero["counters"] != kv["counters"]:
            raise AssertionError("the zero-churn cell left kv_directory's "
                                 "golden counters")
    return rows


# the trace phase: phase 4's n=64 srsp fused cell of each workload
# (worksteal's at seed 2), traced with TRACE_CAP slots, held to
# golden/trace.npz and golden/trace.json (the JAX reference's traces)
TRACE_CAP = 4096
# (producer_consumer's pair, 10.1 s of steady time, was cut for phase
# 10's time: reader_lock and producer_consumer_mc keep the lock and queue
# events in the ring)
TRACE_WORKLOADS = ("kv_directory", "reader_lock", "producer_consumer_mc",
                   "worksteal", "kv_serving")


def load_trace_golden() -> tuple:
    """(golden/trace.json, golden/trace.npz's arrays)."""
    import numpy as np
    base = os.path.join(ROOT, "src", "repro_torch", "golden", "trace")
    with open(base + ".json") as f:
        doc = json.load(f)
    with np.load(base + ".npz") as z:
        return doc, {k: z[k] for k in z.files}


def trace_held(ctx: str, store, name: str, arrays: dict) -> None:
    """Raise unless `store`'s trace is the golden cell `name`'s: the
    decoded columns, head (so dropped), op_hist and turn_hist."""
    import numpy as np

    from repro_torch.obs import export
    tl = store.trace
    dec = export.decode(tl)
    got = {**dec["events"], "head": tl.head.cpu().numpy(),
           "op_hist": tl.op_hist.cpu().numpy(),
           "turn_hist": tl.turn_hist.cpu().numpy()}
    for k, v in got.items():
        want = arrays[f"{name}/{k}"]
        if v.dtype != want.dtype or not np.array_equal(v, want):
            raise AssertionError(f"{ctx}: trace {k} differs from the "
                                 f"golden trace of {name}")


def same_leaves(torch, a, b) -> bool:
    """Two port trees, leaf for leaf, same dtype and bits."""
    from repro_torch import convert
    x, y = convert.leaves(a), convert.leaves(b)
    return len(x) == len(y) and all(
        u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(x, y))


def trace_bench(workload: str, seed: int, traces: dict, golden: dict):
    """A trace golden cell's bench on the card (kv_serving on the
    reference's trace)."""
    from repro_torch import workloads
    mod = workloads.get(workload)
    bench = mod.build("srsp", N_MAIN, seed=seed, device="cuda")
    if workload == "kv_serving":
        bench = mod.with_trace(bench, traces[golden["trace"]][0])
    return bench


# the cells whose traced and untraced runs alternate TRACE_REPEATS times
# (untraced first, then traced first, ...), their `steady_s` the medians
TRACE_TIMED = ("kv_directory", "kv_serving")
TRACE_REPEATS = 1               # a depth dial: ~23 s a repeat (PERF.md §6)


def trace_cells(torch, launch_counters, names=None) -> list:
    """Phase 4, the trace ring: each n=64 srsp fused cell of
    TRACE_WORKLOADS (or `names`) run untraced and traced with TRACE_CAP
    slots, each run timed (no warm-up: phase 4 built and loaded
    everything) with the launch counts read before and after; the
    TRACE_TIMED cells alternate the two TRACE_REPEATS times, the others
    run once (untraced first).  Each traced run's non-trace leaves are
    bitwise the untraced run's, its counters and verdict the golden
    cell's, its trace the golden trace (kv_serving's ring wraps: 6099
    events, 2003 dropped), and each kernel launches as often traced as
    untraced."""
    import statistics

    from repro_torch.obs import trace as TL
    from repro_torch.workloads import harness
    doc, arrays = load_trace_golden()
    golden = {c["name"]: c for c in doc["cells"]}
    traces = load_traces()
    recs = []
    for w in names or TRACE_WORKLOADS:
        seed = 2 if w == "worksteal" else 4
        name = f"{w} n={N_MAIN} seed={seed} fused"
        times = {0: [], TRACE_CAP: []}
        for rep in range(TRACE_REPEATS if w in TRACE_TIMED else 1):
            runs = {}
            for cap in (0, TRACE_CAP)[::-1 if rep % 2 else 1]:
                bench = trace_bench(w, seed, traces, golden[name])
                state = TL.with_trace(bench.state, cap)
                torch.cuda.synchronize()
                before = [f.launches for f in launch_counters]
                t0 = time.perf_counter()
                final = harness.run_fused(bench.wl, state, *bench.ops)
                torch.cuda.synchronize()
                times[cap].append(time.perf_counter() - t0)
                runs[cap] = (final, {
                    f.__name__: f.launches - b
                    for f, b in zip(launch_counters, before)},
                    bench.check(final))
            (off, off_l, _), (on, on_l, check) = runs[0], runs[TRACE_CAP]
            if not same_leaves(torch, TL.strip(on), off):
                raise AssertionError(f"{name}: tracing moved a non-trace "
                                     f"leaf")
            if on_l != off_l:
                raise AssertionError(f"{name}: launches traced {on_l} != "
                                     f"untraced {off_l}")
            held(f"{name} traced", {
                "counters": harness.counters_dict(on.store),
                "events": check["events"], "check_ok": bool(check["ok"]),
                "check_fails": int(check["check_fails"])}, golden[name])
            trace_held(name, on.store, name, arrays)
        summ = TL.summary(on.store)
        if summ != golden[name]["summary"]:
            raise AssertionError(f"{name}: summary {summ} != golden")
        off_s = statistics.median(times[0])
        on_s = statistics.median(times[TRACE_CAP])
        rec = {"cell": name, "steady_s_untraced": off_s,
               "steady_s_traced": on_s, "steady_s_untraced_runs": times[0],
               "steady_s_traced_runs": times[TRACE_CAP], "launches": on_l,
               **summ}
        log(f"  {name}: steady_s untraced {times[0]} traced "
            f"{times[TRACE_CAP]} (medians x{on_s / off_s:.3f}); events "
            f"{summ['trace_events']} dropped {summ['trace_dropped']}; turn "
            f"latency p50/p95/p99 {summ['latency_p50']}/"
            f"{summ['latency_p95']}/{summ['latency_p99']}; launches {on_l} "
            f"both ways")
        recs.append(rec)
    return recs


def trace_demo() -> dict:
    """Phase 4, the trace report's demo on the card: in this process its
    Chrome-trace document `==` the reference's (golden/trace.json), then
    `python3 -m repro_torch.obs.report --demo` in a child process, whose
    output must be the reference's report, check_ok=True, recovered=1."""
    import tempfile

    from repro_torch.obs import export, report
    want = load_trace_golden()[0]["demo"]
    fin, check, label = report.demo(device="cuda", cap=TRACE_CAP)
    doc = json.loads(json.dumps(export.trace_doc(fin.s.store, label=label)))
    if doc != want["doc"] or not check["ok"]:
        raise AssertionError("the report demo's document differs from the "
                             "reference's")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "TRACE_demo.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", "--demo",
             "--cap", str(TRACE_CAP), "--out", out_path], env=env,
            capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        with open(out_path) as f:
            written = json.load(f)
    expect = (f"{want['report']}\ncheck_ok=True recovered=1\n"
              f"wrote {out_path}\n")
    if out.returncode or out.stdout != expect or written != want["doc"]:
        raise AssertionError(f"report --demo ({out.returncode}):\n"
                             f"{out.stdout}\n{out.stderr[-2000:]}")
    for line in out.stdout.splitlines()[:-1]:
        log(f"    | {line}")
    return {"events": doc["srsp"]["events"], "check_ok": True,
            "recovered": 1, "command_s": wall}


def record_op_call(torch):
    """One traced `record_op` at n=64 with every lane active, and one
    `record_turn`, as calls."""
    from repro_torch.core import protocol as P
    from repro_torch.obs import trace as TL
    cfg = P.ProtoConfig(n_caches=N_MAIN, n_words=64 * 1024)
    st = TL.with_trace(P.make_store(cfg, "cuda"), TRACE_CAP)
    active = torch.ones(N_MAIN, dtype=torch.bool, device="cuda")
    addrs = torch.arange(N_MAIN, dtype=torch.int32, device="cuda")
    clock0 = st.counters.cycles - 3.0
    outcome = torch.full((N_MAIN,), TL.OC_HIT, dtype=torch.int32,
                         device="cuda")
    return (lambda: TL.record_op(st, active, TL.LOAD, 0, addrs, clock0,
                                 outcome),
            lambda: TL.record_turn(st, clock0))


def record_op_eager(torch) -> dict:
    """Phase 4 (before any profiler trace): the eager wall time of one
    traced record_op and record_turn call."""
    op, turn = record_op_call(torch)
    rec = {"record_op_eager_ms": T.eager_ms(op),
           "record_turn_eager_ms": T.eager_ms(turn)}
    log(f"  one traced record_op: eager {rec['record_op_eager_ms']:.4f} ms "
        f"a call; record_turn {rec['record_turn_eager_ms']:.4f} ms")
    return rec


def record_op_ops(torch) -> dict:
    """Phase 6: the device operations one traced record_op and one
    record_turn add (torch.profiler)."""
    op, turn = record_op_call(torch)
    ops, turns = T.device_ops(op), T.device_ops(turn)
    rec = {"record_op": sum(ops.values()), "record_turn": sum(turns.values()),
           "record_op_by_name": ops, "record_turn_by_name": turns}
    log(f"  one traced record_op: {rec['record_op']} device operations; "
        f"record_turn {rec['record_turn']}")
    for k, v in sorted(ops.items()):
        log(f"    x{v}  {k[:90]}")
    return rec


def app_drivers() -> list:
    """Phase 4, worksteal's app drivers at the paper's 64 CUs (`run_app`
    on the card): each golden record's counters, `proc_errors` and
    iterations exactly, the SSSP and MIS solutions bit for bit, PageRank
    within rtol 1e-5 (its scatter-add sums in another order)."""
    import numpy as np
    import torch

    from repro_torch.data import graphs
    from repro_torch.workloads import worksteal
    doc = load_golden("worksteal")
    with np.load(os.path.join(ROOT, "src", "repro_torch", "golden",
                              "worksteal_apps.npz")) as z:
        sols = {k: z[k] for k in z.files}
    recs = []
    for a in doc["apps"]:
        g = getattr(graphs, a["graph"])(a["n_nodes"])
        r = worksteal.run_app(a["app"], g, a["scenario"],
                              worksteal.WSConfig(**a["ws"]),
                              max_iters=a["max_iters"], engine=a["engine"],
                              device="cuda")
        ctx = f"run_app {a['app']} {a['scenario']}"
        if (r.counters, r.proc_errors, r.iterations) != (
                a["counters"], a["proc_errors"], a["iterations"]):
            raise AssertionError(f"{ctx}: {r.counters} errors "
                                 f"{r.proc_errors} iterations "
                                 f"{r.iterations} != golden {a}")
        want = sols[a["solution"]]
        if a["app"] == "pagerank":
            err = float(np.max(np.abs(r.solution - want) / np.abs(want)))
            ok = r.solution.dtype == want.dtype and err <= 1e-5
        else:
            err = float(np.max(np.abs(r.solution.astype(np.int64)
                                      - want.astype(np.int64))))
            ok = r.solution.dtype == want.dtype and err == 0
        if not ok:
            raise AssertionError(f"{ctx}: solution off the golden by {err}")
        log(f"  {ctx} on {a['graph']}({a['n_nodes']}): makespan="
            f"{r.makespan} proc_errors={r.proc_errors} iterations="
            f"{r.iterations} solution err={err} wall_s={r.wall_s}")
        recs.append({"app": a["app"], "scenario": a["scenario"],
                     "makespan": r.makespan, "iterations": r.iterations,
                     "solution_err": err, "wall_s": r.wall_s})
    torch.cuda.synchronize()
    return recs


def serving_scale(torch, launch_counters) -> dict:
    """Phase 4, the full-width kv_serving cell (the committed sweep's
    serving shape: n=64, 256 requests per agent, zipf 1.2, bursty): the
    port's own trace drawn on the card and held to the reference's
    (`trace.compare`; the replica phase serves own traces to a green
    check); then the timed run on the reference's trace, held to its
    golden cell, with the launch counts set to 0 just before it and read
    just after."""
    from repro_torch.traffic import trace as TT
    from repro_torch.workloads import harness, kv_serving
    ref = next(c for c in load_golden("kv_serving")["cells"]
               if c["traffic"] == "serving")
    tr, meta = load_traces()[ref["trace"]]
    cfg, n = meta["config"], meta["n_agents"]
    ctx = (f"kv_serving {ref['scenario']} n={n} seed={ref['seed']} "
           f"{ref['engine']} {cfg}")
    t0 = time.perf_counter()
    mine = TT.generate(cfg, n, meta["n_keys"], meta["seed"], "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    cmp = TT.compare(mine, tr, n, cfg.requests_per_agent)
    log(f"  the port's trace on the card ({gen_s:.4f} s) against the "
        f"reference's: {cmp}")
    if not cmp["held"]:
        raise AssertionError(f"{ctx}: the port's trace is not held to the "
                             f"reference's: {cmp}")
    run = harness.runner(ref["engine"])
    bench = kv_serving.with_trace(kv_serving.build(
        ref["scenario"], n, seed=ref["seed"], device="cuda", traffic=cfg),
        tr)
    torch.cuda.synchronize()

    def timed():
        t = time.perf_counter()
        final = run(bench.wl, bench.state)
        torch.cuda.synchronize()
        return final, time.perf_counter() - t

    (final, steady), launches = counted(launch_counters, timed)
    check = bench.check(final)
    row = {"counters": harness.counters_dict(final.store),
           "events": check["events"], "check_ok": bool(check["ok"]),
           "check_fails": int(check["check_fails"])}
    held(ctx, row, ref)
    log(f"  {ctx}: makespan={row['counters']['makespan']} events="
        f"{row['events']} check_ok={row['check_ok']} steady_s={steady} "
        f"launches/run={launches} latency={check['latency']}")
    return {"cell": ctx, **row, "steady_s": steady,
            "launches_per_run": launches, "trace_generation_s": gen_s,
            "trace_compare": cmp, "latency": check["latency"]}


def many_cell_args(cell, traces) -> dict:
    """`sweep.run_vmapped_cell`'s arguments for a cell of
    `golden/many.json`: its fault's protocol, and for kv_serving the
    reference's traces of its seeds with their traffic."""
    from repro_torch.core import protocol as P
    from repro_torch.workloads import faults
    kw = {}
    if cell["fault"]:
        kw["proto"] = getattr(faults, cell["fault"])(
            P.get_protocol(cell["scenario"]))
    if "traces" in cell:
        kw["traces"] = [traces[t][0] for t in cell["traces"]]
        kw["build_kw"] = {"traffic": traces[cell["traces"][0]][1]["config"]}
    return kw


def many_golden(launch_counters, cells=None) -> list:
    """Phase 4, the replica axis: every cell of `golden/many.json` (or
    `cells`) through `sweep.run_vmapped_cell` on the card, one replica run
    of two seeds a cell after one warm-up run of the first, every lane
    held with `==` to the reference's `run_*_many` lanes (counters,
    events, check_ok, check_fails).  Logs each cell's
    `steady_s_per_run`, `steady_s_per_replica`, trips and launches a run
    (with the check's solo drain of each lane); a fused run must launch
    `trip_plan_many` once a pass; the `remote_batch_ab` pair's makespans
    are equal."""
    from repro_torch.workloads import sweep
    doc = load_golden("many")["cells"]
    cells = doc if cells is None else cells
    traces = load_traces()

    def run(cell, warmup=False):
        return sweep.run_vmapped_cell(
            cell["workload"], cell["scenario"], cell["n_agents"],
            cell["seeds"], cell["engine"], device="cuda", warmup=warmup,
            **many_cell_args(cell, traces))

    run(cells[0])                            # the warm-up, not counted
    rows = []
    for cell in cells:
        before = [f.launches for f in launch_counters]
        row = run(cell)
        row["launches_per_run"] = {f.__name__: f.launches - b for f, b in
                                   zip(launch_counters, before)}
        ctx = (f"{cell['workload']} {cell['scenario']} n={cell['n_agents']} "
               f"seeds={cell['seeds']} {cell['engine']} {cell['fault']}")
        for lane, ref in zip(row["lanes"], cell["lanes"]):
            held(f"{ctx} seed {lane['seed']}", lane, ref)
        plans = row["launches_per_run"].get("trip_plan_many")
        if cell["engine"] == "fused" and plans is not None \
                and plans != row["trips"] + 1:
            raise AssertionError(f"{ctx}: {plans} trip_plan_many launches "
                                 f"in {row['trips']} trips")
        log(f"  {ctx}: makespans={[r['counters']['makespan'] for r in row['lanes']]}"
            f" steady_s_per_run={row['steady_s_per_run']} "
            f"steady_s_per_replica={row['steady_s_per_replica']} "
            f"trips={row['trips']} launches/run={row['launches_per_run']}")
        rows.append(dict(row, fault=cell["fault"]))
    pair = [r for r in rows if (r["workload"], r["engine"])
            == ("producer_consumer_mc", "batched")]
    if len({r["makespan"] for r in pair}) > 1:
        raise AssertionError(f"remote_batch_ab makespans differ: "
                             f"{[r['makespan'] for r in pair]}")
    return rows


# the own-trace replica run's replica count: lane 0 the reference's trace,
# the other the port's own draw on the card
SERVING_REPLICAS = 2


def serving_replicas(launch_counters) -> dict:
    """Phase 4, kv_serving at the golden size (n=64, the default traffic)
    as one fused replica run of SERVING_REPLICAS replicas (seeds 4, 5,
    ...): lane 0 replays the reference's trace of the golden cell and is
    held to it, the other lanes serve the traces the port draws on the
    card, each to a green check.  Launch counts set to 0 just before and
    read just after; no warm-up.  (The full-width traffic runs solo in
    the full-width phase; as a replica run it took 219 s of a whole run
    of 1406.5 s, PERF.md §6.)"""
    from repro_torch.workloads import harness, kv_serving, sweep
    ref = golden_cell(load_golden("kv_serving"), "srsp", N_MAIN, 4, "fused",
                      "n64_seed4_default")
    tr, meta = load_traces()[ref["trace"]]
    cfg, n = meta["config"], meta["n_agents"]
    seeds = list(range(ref["seed"], ref["seed"] + SERVING_REPLICAS))
    bench = kv_serving.build("srsp", n, seed=seeds[0], device="cuda",
                             traffic=cfg)

    def states():
        own = harness.init_many(kv_serving.init_state, bench.wl, seeds,
                                "cuda")
        return kv_serving.with_traces(
            bench, [tr] + [None] * (len(seeds) - 1), own).state

    row, launches = counted(launch_counters, lambda: sweep.run_vmapped_cell(
        "kv_serving", "srsp", n, seeds, "fused", device="cuda",
        build_kw={"traffic": cfg}, warmup=False, states=states))
    ctx = f"kv_serving srsp n={n} seeds={seeds} fused {cfg}"
    held(f"{ctx} lane 0", row["lanes"][0], ref)
    if not row["check_ok"]:
        raise AssertionError(f"{ctx}: a lane is red: {row['lanes']}")
    log(f"  {ctx}: makespans={[r['counters']['makespan'] for r in row['lanes']]}"
        f" completed={[r['completed'] for r in row['lanes']]} "
        f"steady_s_per_run={row['steady_s_per_run']} steady_s_per_replica="
        f"{row['steady_s_per_replica']} trips={row['trips']} "
        f"launches/run={launches}")
    return dict(row, launches_per_run=launches)


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
    churn, churn_launches = counted(
        counters, lambda: run_churn(BOOL_CHURN, (SF.drain_writeback_bool,)))
    if not churn_launches["drain_writeback_bool"] \
            or churn_launches["drain_writeback"]:
        raise AssertionError(f"bool layout churn launches {churn_launches}"
                             f": want the bool drain kernel, no packed "
                             f"drain")
    log(f"    launches in the bool-layout churn cells: {churn_launches}")
    for name in launches:
        launches[name] += churn_launches[name]
    many_counters = (SF.drain_writeback_many, SF.drain_writeback_bool_many)
    cell = next(c for c in load_golden("many")["cells"] if (
        c["workload"], c["scenario"], c["engine"])
        == ("kv_directory", "srsp", "fused"))
    many, many_launches = counted(many_counters,
                                  lambda: many_golden((), [cell]))
    if not many_launches["drain_writeback_bool_many"] \
            or many_launches["drain_writeback_many"]:
        raise AssertionError(f"bool layout replica launches {many_launches}"
                             f": want the bool replica drain, no packed one")
    log(f"    launches in the bool-layout replica cell: {many_launches}")
    launches.update(many_launches)
    traced, traced_launches = counted(
        counters, lambda: trace_cells(torch, counters, ["kv_directory"]))
    if not traced_launches["drain_writeback_bool"] \
            or traced_launches["drain_writeback"]:
        raise AssertionError(f"bool layout traced launches "
                             f"{traced_launches}")
    for name in counters:
        launches[name.__name__] += traced_launches[name.__name__]
    print(json.dumps({"rows": rows, "churn": churn, "many": many,
                      "traced": traced, "launches": launches}))
    return 0


# the cells of golden/many.json the replica child leaves out, (workload,
# scenario, engine, fault): kv_directory's rsp and baseline fused cells
# and producer_consumer's (6.0, 4.5 and 8.6 s a run), cut for phase 10's
# time; the other workloads' srsp fused cells and kv_directory's batched
# one keep every engine form on the replica axis
MANY_SKIPPED = (("kv_directory", "rsp", "fused", None),
                ("kv_directory", "baseline", "fused", None),
                ("producer_consumer", "srsp", "fused", None))


def replica_child(torch, SF, FT) -> int:
    """Phase 4's replica runs in a child process, so that the process
    that traces with torch.profiler (phases 5 and 6) never runs the
    replica engines (PERF.md §7): the cells of `golden/many.json`, then
    the full-width kv_serving shape, with the launch counts set to 0
    just before each and read just after, one JSON line last."""
    counters = (SF.drain_writeback, SF.drain_writeback_many,
                FT.plane_commit_many, FT.trip_plan_many)
    cells = [c for c in load_golden("many")["cells"]
             if (c["workload"], c["scenario"], c["engine"], c.get("fault"))
             not in MANY_SKIPPED]
    many, launches = counted(counters, lambda: many_golden(counters, cells))
    log(f"    launches in the replica cells: {launches}")
    scale = serving_replicas(counters)
    untraced = next(r for r in many if (r["workload"], r["scenario"],
                                        r["engine"], r["fault"])
                    == ("kv_directory", "srsp", "fused", None))
    traced, traced_launches = counted(counters, lambda: trace_replicas(
        torch, counters, untraced["launches_per_run"]))
    for name in launches:
        launches[name] += scale["launches_per_run"][name] \
            + traced_launches[name]
    print(json.dumps({"many": many, "serving_replicas": scale,
                      "traced": traced, "launches": launches}))
    return 0


def trace_replicas(torch, launch_counters, untraced_launches: dict) -> dict:
    """The replica child: kv_directory n=64 srsp fused over seeds 4 and 5
    in one traced replica run (each solo state given TRACE_CAP slots,
    then stacked), each lane's trace held to its seed's golden trace and
    its counters to the golden lanes of `many.json`; launches equal the
    untraced replica cell's (`untraced_launches`)."""
    from repro_torch import workloads
    from repro_torch.obs import trace as TL
    from repro_torch.workloads import harness, sweep
    mod = workloads.get("kv_directory")
    bench = mod.build("srsp", N_MAIN, seed=4, device="cuda")
    seeds = [4, 5]
    cell = next(c for c in load_golden("many")["cells"] if (
        c["workload"], c["scenario"], c["engine"], c["fault"])
        == ("kv_directory", "srsp", "fused", None))
    _, arrays = load_trace_golden()
    before = [f.launches for f in launch_counters]
    row = sweep.run_vmapped_cell(
        "kv_directory", "srsp", N_MAIN, seeds, "fused", device="cuda",
        warmup=False, keep_stores=True, states=lambda: harness.stack([
            TL.with_trace(mod.init_state(bench.wl, s, "cuda"), TRACE_CAP)
            for s in seeds]))
    launches = {f.__name__: f.launches - b
                for f, b in zip(launch_counters, before)}
    ctx = f"kv_directory srsp n={N_MAIN} seeds={seeds} fused traced"
    for lane, store, ref, seed in zip(row["lanes"], row["_stores"],
                                      cell["lanes"], seeds):
        held(f"{ctx} seed {seed}", lane, ref)
        trace_held(f"{ctx} seed {seed}", store,
                   f"kv_directory n={N_MAIN} seed={seed} fused", arrays)
    if launches != untraced_launches:
        raise AssertionError(f"{ctx}: launches {launches} != untraced "
                             f"{untraced_launches}")
    log(f"  {ctx}: each lane's trace == its seed's golden trace; "
        f"steady_s_per_run={row['steady_s_per_run']}; launches {launches}"
        f" as untraced; latency p99 {row['latency_p99']}")
    return {"cell": ctx, "steady_s_per_run": row["steady_s_per_run"],
            "launches": launches,
            **{k: row[k] for k in ("latency_p50", "latency_p95",
                                   "latency_p99", "latency_turns",
                                   "trace_events", "trace_dropped")}}


def sweep_child(SF, FT) -> int:
    """The sweep phase in a child process started with REPRO_TRACE=1 (so
    that the process that traces with torch.profiler never runs the
    replica engines): `python3 -m repro_torch.workloads.sweep` as its
    `main` at golden/sweep.json's argv, on the card, replaying the
    reference's kv_serving traces, without the untimed warm-up calls
    (they hold no modeled column; `-m cuda -k sweep` runs them), with the
    launch counts set to 0 just before and read just after; its own
    `check_doc` (traced) must pass and every modeled column
    (`sweep_doc.modeled`) must equal the golden document's.  Then
    `SWEEP_FULL_ARGV` through `sweep.run_sweep` (no warm-ups, counted
    too), every row `==` the committed document's row of its label in
    `sweep_doc.ROW_COLUMNS`.  One JSON line last."""
    import tempfile
    from repro_torch.obs import trace as TL
    from repro_torch.workloads import sweep, sweep_doc
    if not TL.TRACE:
        raise AssertionError("the sweep child needs REPRO_TRACE=1")
    with open(SWEEP_GOLDEN) as f:
        golden = json.load(f)
    argv = golden.pop("provenance")["argv"]
    counters = (SF.drain_writeback, SF.drain_writeback_many,
                FT.plane_commit, FT.plane_commit_many, FT.trip_plan,
                FT.trip_plan_many)
    traces = sweep.reference_traces(SWEEP_TRACES, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sweep.json")
        t0 = time.perf_counter()
        rc, launches = counted(counters, lambda: sweep.main(
            argv + ["--out", out, "--trace-out",
                    os.path.join(tmp, "trace.json")], traces,
            warmup=False))
        wall = time.perf_counter() - t0
        with open(out) as f:
            doc = json.load(f)
    if rc != 0:
        raise AssertionError(f"the sweep exited {rc}: check_doc failed")
    diff = sweep_doc.diff_modeled(doc, golden)
    if diff:
        raise AssertionError(f"the sweep's document differs from "
                             f"golden/sweep.json in {len(diff)} modeled "
                             f"columns: {diff[:20]}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched in the sweep: "
                             f"{launches}")
    rows = doc["runs"] + doc["serving"]
    log(f"    {len(rows)} rows, {len(doc['comparisons'])} comparisons == "
        f"golden/sweep.json in every modeled column; check_doc passed "
        f"(traced); {wall:.1f} s; kernel_mode {doc['kernel_mode']}")

    with open(SWEEP_COMMITTED) as f:
        committed = json.load(f)
    t0 = time.perf_counter()
    full, full_launches = counted(counters, lambda: sweep.run_sweep(
        sweep.parser().parse_args(SWEEP_FULL_ARGV), warmup=False))
    full_wall = time.perf_counter() - t0
    diff = sweep_doc.diff_modeled(full, committed,
                                  columns=sweep_doc.ROW_COLUMNS)
    if diff:
        raise AssertionError(f"the full-width slice differs from "
                             f"BENCH_workloads.json: {diff[:20]}")
    for name, n in full_launches.items():
        launches[name] += n
    held = sum(len(full[sec]) for sec in sweep_doc.LABELED)
    log(f"    full width ({' '.join(SWEEP_FULL_ARGV)}): {held} rows == "
        f"BENCH_workloads.json in {', '.join(sweep_doc.ROW_COLUMNS)}; "
        f"{full_wall:.1f} s; launches {full_launches}")
    print(json.dumps({"wall_s": wall, "full_wall_s": full_wall,
                      "launches": launches,
                      "rows": [{k: r[k] for k in (
                          "workload", "scenario", "n_agents", "engine",
                          "compile_s", "steady_s_per_run", "bench_wall_s")
                          if k in r} for r in rows],
                      "full_rows": [{k: r[k] for k in (
                          "workload", "scenario", "n_agents", "engine",
                          "steady_s_per_run") if k in r}
                          for sec in sweep_doc.LABELED for r in full[sec]],
                      "pack_ab": doc["pack_ab"] + full["pack_ab"],
                      "comparisons": len(doc["comparisons"])}))
    return 0


def run_child(flag: str, tag: str, env=None, timeout=600) -> dict:
    """This script in a child process with `flag`: its log lines are
    echoed under `[tag]` and its last line's JSON returned; a nonzero
    exit fails the run."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  [{tag}] {line.strip()}")
    if out.returncode != 0:
        raise AssertionError(f"the {tag} child failed "
                             f"({out.returncode}):\n{out.stdout[-4000:]}\n"
                             f"{out.stderr[-4000:]}")
    res = json.loads(lines[-1])
    log(f"    launches in the {tag} child: {res['launches']}")
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
# the replica instances (`*_many`) replace the same Pallas kernels under
# jax.vmap's batch grid axis
SIM_REPLACES.update({f"{k}_many": v for k, v in list(SIM_REPLACES.items())})
# the bool instance is a template instance of the packed kernel's source,
# and each replica instance lives in its solo kernel's source
SIM_SOURCES = {"drain_writeback_bool": "drain_writeback",
               "drain_writeback_many": "drain_writeback",
               "drain_writeback_bool_many": "drain_writeback",
               "plane_commit_many": "plane_commit",
               "trip_plan_many": "trip_plan"}


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


def profile_cell(torch, workload: str, seed: int, steady_s: float) -> dict:
    """Phase 6: device busy time of one fused n=64 srsp run of
    `workload`, from torch.profiler's CUDA kernel records, against the
    unprofiled `steady_s` of that cell (phase 4): the device's idle
    share."""
    from repro_torch import workloads
    from repro_torch.workloads import harness
    bench = workloads.get(workload).build("srsp", N_MAIN, seed=seed,
                                          device="cuda")
    busy_s, kernels = device_busy(
        torch, lambda: harness.run_fused(bench.wl, bench.state, *bench.ops))
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    rec = {"cell": f"{workload} srsp n={N_MAIN} seed={seed} fused",
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
            for key in (name, dense_key(name, case[1])):
                if key:
                    errs[key] = max(errs.get(key, 0.0), e)
            log(f"  {name} {case[0]}: rel err {rel:.3g}")
    check_dense_refusals(torch, C, ops["flash_attention"])
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


# the dense configs' kernel instances (phases 3, 5 and 10): the kernels
# line's name of each, and the configs whose phase-10 bf16 run launches
# it
DENSE_GROUPS = {5: "qwen2.5-32b", 1: "qwen1.5-32b", 12: "mistral-large-123b"}
DENSE_RMS = "rmsnorm[d=5120,12288]"


def dense_key(name: str, kw: dict):
    """The dense instance a case of `C.FLOAT_CASES[name]` exercises (its
    kernels-line name), or None."""
    if name == "flash_attention" and kw["d"] == 128:
        return "flash_attention[D=128]"
    if name == "flash_decode" and kw["d"] == 128 \
            and kw["hq"] // kw["hkv"] in DENSE_GROUPS:
        return f"flash_decode[D=128 group {kw['hq'] // kw['hkv']}]"
    if name == "rmsnorm" and kw["shape"][-1] in T.DENSE_RMS_D:
        return DENSE_RMS
    return None


def dense_launched_by(key: str) -> list:
    """The phase-10 engine runs that count `key`'s launches, all in
    bfloat16, the type phase 5 times: attention's D=128 instance in
    qwen2.5-32b's timed run, decode's group g in the run of that group's
    config, rmsnorm at d 5120 and 12288 in all three."""
    if key.startswith("flash_attention"):
        names = ["qwen2.5-32b"]
    elif key.startswith("flash_decode"):
        names = [DENSE_GROUPS[int(key.split("group ")[1][:-1])]]
    else:
        names = list(DENSE_GROUPS.values())
    return [f"{n} bfloat16" for n in names]


def check_dense_refusals(torch, C, FA) -> None:
    """Phase 3: what the dense instances do not take raises on the card,
    and nothing falls back: a bf16 D=128 q off 16 bytes (TMA's rule; the
    wgmma kernel is the only bf16 D=128 one) raises RuntimeError; and
    attention with grad on at D=128 runs the training instance and the
    backward kernel (one launch each), its gradients within BWD_TOL of
    torch.autograd through the plain version, while at D=160 (no backward
    instance) it raises NotImplementedError before any launch."""
    dev = torch.device("cuda")
    q, k, v = (C.to_dtype(x, "bfloat16").to(dev)
               for x in C.attn_inputs(1, 1, 10, 2, 64, 128))
    want = FA.flash_attention(q, k, v)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(
        q.shape)
    off.copy_(q)
    try:
        FA.flash_attention(off, k, v)
    except RuntimeError as e:
        log(f"  flash_attention bf16 D=128, q 2 bytes off 16: raises ({e})")
    else:
        raise AssertionError("flash_attention took a misaligned D=128 q")
    if not torch.equal(FA.flash_attention(q, k, v), want):
        raise AssertionError("flash_attention D=128 after a refusal differs")
    gen = torch.Generator(device=dev).manual_seed(12)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    before = (FA.flash_attention_lse.launches,
              FA.flash_attention_bwd.launches)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention(*ins), ins, do)
    torch.cuda.synchronize()
    launched = (FA.flash_attention_lse.launches - before[0],
                FA.flash_attention_bwd.launches - before[1])
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(FA.flash_attention_ref(*ins), ins, do)
    rel = max(C.within(g, w, "bfloat16") for g, w in zip(got, want))
    log(f"  flash_attention with grad at D=128 bf16: launches (lse, bwd) "
        f"{launched}, gradients within {rel:.3g} of the plain version's")
    if launched != (1, 1) or rel > C.BWD_TOL["bfloat16"]:
        raise AssertionError(f"training attention at D=128: launches "
                             f"{launched}, error {rel}")
    q6, k6, v6 = (C.to_dtype(x, "bfloat16").to(dev).requires_grad_()
                  for x in C.attn_inputs(1, 1, 10, 2, 64, 160))
    before = (FA.flash_attention_lse.launches, FA.flash_attention.launches)
    try:
        FA.flash_attention(q6, k6, v6)
    except NotImplementedError as e:
        log(f"  flash_attention with grad at D=160: {e}")
    else:
        raise AssertionError("training attention at D=160 did not raise")
    if (FA.flash_attention_lse.launches,
            FA.flash_attention.launches) != before:
        raise AssertionError("training attention at D=160 launched")


def decode_instance(torch, FD, b, hq, hkv, s, d) -> dict:
    """The bf16 decode call's launch: its clusters of 8 CTAs, how many the
    card holds at once, and, for the tensor-core instance, its registers
    and local (spilled) bytes a thread as the loaded module reports
    them."""
    bf = torch.bfloat16
    rec = {"instance": "mma" if FD.uses_mma(bf, d) else "cuda cores",
           "clusters": FD.clusters(b, hq, hkv, d, bf),
           "resident_clusters": FD.resident_clusters(hq, hkv, s, d, bf)}
    if FD.uses_mma(bf, d):
        rec.update(FD.mma_attributes(d))
    return rec


def decode_note(rec: dict) -> str:
    return (f"{rec['instance']} instance, {rec['clusters']} clusters of 8 "
            f"CTAs, {rec['resident_clusters']} resident at once"
            + (f", {rec['registers']} registers, {rec['local_bytes']} "
               f"local bytes a thread" if "registers" in rec else ""))


def measure_dense(torch, C, ops, errs) -> list:
    """Phase 5, the dense configs' instances at their bfloat16 serving
    shapes (`T.dense_calls`): device time per call of the kernel, of its
    plain version and of one PyTorch call of the same function
    (scaled_dot_product_attention, F.rms_norm), eager time, and the
    bound (bytes over 3.35 TB/s or bf16 flops over 989 TFLOP/s; rmsnorm's
    ops over 67 TOP/s).  `launches` is filled from phase 10."""
    dev = torch.device("cuda")
    FA, FD, RN = (ops[n] for n in ("flash_attention", "flash_decode",
                                   "rmsnorm"))
    out = {}
    for call in T.dense_calls(C, FA, FD, RN, dev):
        name = call["name"]
        key = (DENSE_RMS if name == "rmsnorm" else
               "flash_attention[D=128]" if name == "flash_attention" else
               f"flash_decode[D=128 group {call['hq'] // call['hkv']}]")
        b_ms, b_by = bound(call["bytes"], call["ops"],
                           OPS_PER_S if name == "rmsnorm" else BF16_FLOPS)
        rec = {"name": key, "route": "cuda",
               "source": f"src/repro_torch/csrc/{name}.cu",
               "replaces": SERVE_REPLACES[name], "launches": None,
               "max_abs_err": errs[key], "ms": T.device_ms(call["fn"]),
               "plain_ms": T.device_ms(call["plain"]), "bound_ms": b_ms,
               "bound_by": b_by,
               "library_ms": T.device_ms(call["library"]),
               "shape": call["shape"], "eager_ms": T.eager_ms(call["fn"])}
        if name == "flash_decode":
            rec.update(decode_instance(torch, FD, T.DENSE_SLOTS, call["hq"],
                                       call["hkv"], T.DENSE_MAX_LEN, 128))
        log(f"  {key} {call['shape']}: {rec['ms']:.5f} ms/call (plain "
            f"{rec['plain_ms']:.5f}, library {rec['library_ms']:.5f}), "
            f"eager {rec['eager_ms']:.5f} ms, bound {b_ms:.7f} ms ({b_by})"
            + (f"; {decode_note(rec)}" if name == "flash_decode" else ""))
        if key in out:           # rmsnorm's second width
            out[key]["by_shape"].append(rec)
        else:
            out[key] = rec | {"by_shape": [rec]}
    return list(out.values())


# the TPU kernel each serving kernel replaces
SERVE_REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:24",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:62",
    "topk_router": "src/repro/kernels/topk_router/kernel.py:43"}


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

    by_shape("rmsnorm", SERVE_REPLACES["rmsnorm"], rms_norm_call)

    # every prefill length of phase 7's prompts; the longest is the
    # kernel's entry, the others go to its `by_length`
    by_length = []
    for s in sorted(set(prompt_lens)):
        q, k, v = (randn(1, 16, s, 64), randn(1, 8, s, 64),
                   randn(1, 8, s, 64))
        entry("flash_attention", SERVE_REPLACES["flash_attention"],
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

    # decode: the first four prompts half-way through their new tokens,
    # the shape that `T.decode_calls` (and so the A/B of timing.py) times
    lens = tuple(n + SERVE_NEW // 2 for n in prompt_lens[:SERVE_SLOTS])
    if lens != T.GRANITE_DECODE_LENS:
        raise AssertionError(f"phase 7's decode kv_len {lens} is not "
                             f"timing.GRANITE_DECODE_LENS "
                             f"{T.GRANITE_DECODE_LENS}")
    (call,) = T.decode_calls(C, FD, dev)
    entry("flash_decode", SERVE_REPLACES["flash_decode"], call["shape"],
          call["fn"], call["plain"], call["library"], call["bytes"],
          call["ops"], BF16_FLOPS,
          note=lambda rec: decode_instance(torch, FD, SERVE_SLOTS, 16, 8,
                                           SERVE_MAX_LEN, 64))
    log(f"    flash_decode: {decode_note(out[-1])}")

    by_shape("topk_router", SERVE_REPLACES["topk_router"],
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
    under torch.profiler (`T.trace`, CUDA activity only), from its CUDA
    kernel records.  Raises when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    kernels = [e for e in T.trace(fn, cpu=False)
               if e.device_type == DeviceType.CUDA]
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


def serve_golden(torch, base=None, path=None) -> dict:
    """The golden config of `base` (granite-moe-1b-a400m's CONFIG unless
    named; `repro_torch.serve.golden`: full width, 2 layers, float32,
    numpy weights) teacher-forced on the golden file's tokens (`path`,
    granite's unless named), top-5 logits within GOLDEN_TOL of the JAX
    reference's and greedy tokens equal wherever the margin exceeds
    2 * GOLDEN_TOL; then the `Engine` on the golden's requests, its
    tokens the golden's wherever the margin exceeds 2 * GOLDEN_TOL."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.models.registry import build
    from repro_torch.serve import golden as G
    from repro_torch.serve import reference
    from repro_torch.serve.engine import Engine, Request
    dev = torch.device("cuda")
    golden = G.load(path or G.PATH)
    cfg = G.config(base)
    model = build(cfg)
    t0 = time.perf_counter()
    params = convert.lm_params_to_torch(convert.numpy_lm_params(cfg, G.SEED),
                                        dev, torch.float32)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_par = sum(x.numel() for x in _leaves(params))
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
    log(f"  golden {cfg.name} {G.reduced(base)} ({n_par / 1e9:.3f} B "
        f"parameters, {load_s:.1f} s to draw and load): {res['steps']} "
        f"teacher-forced steps, top-5 max abs err {res['max_abs_err']:.3g} "
        f"(tol {GOLDEN_TOL}), {res['near_ties']} steps with a top-1/top-2 "
        f"margin <= {2 * GOLDEN_TOL}, greedy mismatches "
        f"{res['mismatches']}; engine (slots={G.SLOTS}) divergences "
        f"{eng_div}")
    if res["max_abs_err"] > GOLDEN_TOL or res["mismatches"] or any(
            d is not None and not d[2] for d in eng_div):
        raise AssertionError(f"the golden serving run of {cfg.name} "
                             f"disagrees: {res} {eng_div}")
    del params, logits
    torch.cuda.empty_cache()
    return dict(res, engine_divergence=eng_div, params=n_par)


def engine_vs_serial(torch, model, params, reqs, counters=(),
                     warm_up=False, slots=SERVE_SLOTS,
                     max_len=SERVE_MAX_LEN) -> dict:
    """`reqs` through the `Engine` (slots, max_len) and through the
    serial one-request-at-a-time run: token for token equal in float32,
    in bfloat16 wherever the serial top-1/top-2 margin exceeds
    BF16_MARGIN; raises otherwise.  With `warm_up` one short request
    runs first; the `counters`' launch counts are set to 0 just before
    the engine run and read just after it."""
    from repro_torch.serve import reference
    from repro_torch.serve.engine import Engine, Request
    dtype = model.cfg.dtype
    serial = [reference.serial_generate(model, params, r.prompt,
                                        r.max_new_tokens, max_len)
              for r in reqs]
    engine = Engine(model, params, max_len=max_len, slots=slots)
    if warm_up:
        engine.generate([Request(prompt=reqs[1].prompt, max_new_tokens=4)])
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
    log(f"    engine slots={slots} max_len={max_len}, prompts "
        f"{[len(r.prompt) for r in reqs]}: {n_tok} tokens in {wall:.3f} s; "
        f"divergences from the serial run (step, margin, allowed): {div}; "
        f"serial steps with margin <= {BF16_MARGIN}: {below}")
    if any(d is not None and (dtype == "float32" or not d[2]) for d in div):
        raise AssertionError(f"{model.cfg.name} {dtype} engine != serial "
                             f"run: {div}")
    return {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "divergence": div, "serial_steps_below_margin": below,
            "launches": launches,
            "first_tokens": [o.out[:8].tolist() for o in out]}


def decode_profile(torch, model, params, reqs, counters=(),
                   slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN) -> dict:
    """Where the time goes: prefill ms of each request alone (B=1), the
    decode step's ms over `slots` slots holding the first requests'
    caches (a host clock over 20 steps after 3 warm-ups), the
    `counters`' launches in one step, then one step and the longest
    prompt's prefill under torch.profiler: device busy time, idle share,
    kernel launches, the top kernels and the port's kernels."""
    import numpy as np

    from repro_torch.serve.engine import insert
    dev = torch.device("cuda")
    lens = [len(r.prompt) for r in reqs]
    pre = []
    for r in reqs:
        tok = torch.as_tensor(r.prompt[None].astype(np.int64), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(params, {"tokens": tok})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    del cache
    stacked = model.init_cache(slots, max_len, dev)
    for i, r in enumerate(reqs[:slots]):
        _, cache = model.prefill(params, {"tokens": torch.as_tensor(
            r.prompt[None].astype(np.int64), device=dev)})
        insert(stacked, model.grow_cache(cache, max_len), i)
    del cache
    kv = torch.tensor(lens[:slots], dtype=torch.int32, device=dev)
    tok = torch.zeros((slots, 1), dtype=torch.long, device=dev)
    moe = {"moe_groups": slots} if model.cfg.moe else {}

    def step():
        model.decode_step(params, stacked, tok, kv, **moe)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n_steps = 20
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    _, per_step = counted(counters, step)
    busy_s, kernels = device_busy(torch, step)
    idle = 1.0 - busy_s * 1e3 / step_ms
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    # the longest prompt's prefill under the profiler: where the
    # attention kernel's time sits in it
    longest = max(range(len(reqs)), key=lambda i: lens[i])
    ptok = torch.as_tensor(reqs[longest].prompt[None].astype(np.int64),
                           device=dev)
    pre_busy_s, pre_kernels = device_busy(
        torch, lambda: model.prefill(params, {"tokens": ptok}))
    rec = {"prefill_ms": pre, "decode_ms_per_step": step_ms,
           "decode_launches_per_step": per_step,
           "decode_busy_ms": busy_s * 1e3, "decode_idle_share": idle,
           "decode_kernel_launches": sum(e.count for e in kernels),
           "decode_top": [{"name": e.key[:60], "count": e.count,
                           "device_ms": _dev_us(e) / 1e3} for e in top],
           "decode_port_kernels": _port_kernels(kernels),
           "prefill_longest_busy_ms": pre_busy_s * 1e3,
           "prefill_longest_port_kernels": _port_kernels(pre_kernels)}
    log(f"    prefill ms per request (prompt lengths {lens}): "
        f"{[round(x, 3) for x in pre]}; decode {step_ms:.3f} ms per step "
        f"({slots} slots); launches a step by kernel: {per_step}")
    log(f"    one decode step under torch.profiler: device busy "
        f"{busy_s * 1e3:.3f} ms of {step_ms:.3f} ms: idle share "
        f"{idle:.4f}; {rec['decode_kernel_launches']} kernel launches")
    for t in rec["decode_top"]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:5d}  {t['name']}")
    log(f"    the port's kernels in that step: "
        f"{rec['decode_port_kernels']}")
    log(f"    prefill of {lens[longest]} tokens under torch.profiler: "
        f"device busy {rec['prefill_longest_busy_ms']:.3f} ms; the port's "
        f"kernels: {rec['prefill_longest_port_kernels']}")
    return rec


def serve_path(torch, counters) -> dict:
    """Phase 7: the serving path of granite-moe-1b-a400m; `counters` are
    the serving kernels' wrappers, whose launch counts are set to 0 just
    before the timed bfloat16 engine run and read just after it."""
    import dataclasses

    from repro_torch.configs import granite_moe_1b
    from repro_torch.models.registry import build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rec = {}

    # (1) the golden config, teacher-forced on the JAX reference's tokens
    log("  (1) the golden run")
    rec["golden"] = serve_golden(torch)

    # (2) the model at SERVE_LAYERS layers: engine against the serial run,
    # f32 then bf16
    reqs = serve_requests(granite_moe_1b.CONFIG.vocab)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(granite_moe_1b.CONFIG, dtype=dtype,
                                  n_layers=SERVE_LAYERS)
        model = build(cfg)
        t0 = time.perf_counter()
        params = model.init(0, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_par = sum(x.numel() for x in _leaves(params))
        log(f"  (2) {cfg.name} {cfg.n_layers} layers {dtype}: "
            f"{n_par / 1e9:.3f} B parameters, init {init_s:.2f} s")
        run = engine_vs_serial(torch, model, params, reqs,
                               counters if dtype == "bfloat16" else (),
                               warm_up=dtype == "bfloat16")
        rec[dtype] = dict(run, init_s=init_s, params=n_par)
        if dtype == "float32":
            del params, model
            torch.cuda.empty_cache()
            continue
        rec["launches"] = run["launches"]
        rec["tokens_per_s"] = run["tokens_per_s"]
        log(f"    launches in that run: {run['launches']}")
        if not all(run["launches"].values()):
            raise AssertionError(f"a serving kernel never launched: "
                                 f"{run['launches']}")

        # (3) where the time goes, bf16
        log(f"  (3) bf16: {rec['tokens_per_s']:.1f} tokens/s over the "
            f"engine run")
        rec.update(decode_profile(torch, model, params, reqs))
    return rec


def dense_child(torch) -> int:
    """Phase 10 in a child process: the dense configs on the card, one
    model at a time, each freed before the next.  (1) qwen2.5-32b's
    golden run (full width, 2 layers, float32, numpy weights with nonzero
    QKV biases) held to golden/qwen2_5_serve.json; (2) qwen2.5-32b at
    full width and DENSE_TIMED_LAYERS layers in bfloat16 (`lm_init` on
    the card): phase 7's requests through the engine against the serial
    run, the dense kernels' launch counts set to 0 just before the engine
    run and read just after, then where the time goes; (3) qwen1.5-32b
    and mistral-large-123b at full width and DENSE_CHECK_LAYERS layers:
    DENSE_CHECK_REQUESTS requests in float32, engine == serial run token
    for token, then in bfloat16, equal wherever the serial margin exceeds
    BF16_MARGIN; every dense kernel launched in every run.  One JSON line
    last, with the launches by config and type."""
    import dataclasses

    from repro_torch.configs import mistral_large_123b, qwen1_5_32b, \
        qwen2_5_32b
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_decode import ops as FD
    from repro_torch.kernels.rmsnorm import ops as RN
    from repro_torch.models.registry import build
    from repro_torch.serve import golden as G
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (RN.rmsnorm, FA.flash_attention, FD.flash_decode)
    t0 = time.perf_counter()

    def part(msg):
        log(f"  {msg}  [child at {time.perf_counter() - t0:.1f} s]")

    part("(1) qwen2.5-32b golden")
    golden = serve_golden(torch, qwen2_5_32b.CONFIG, G.QWEN_PATH)

    part(f"(2) qwen2.5-32b, {DENSE_TIMED_LAYERS} layers, bfloat16")
    cfg = dataclasses.replace(qwen2_5_32b.CONFIG, n_layers=DENSE_TIMED_LAYERS)
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    n_par = sum(x.numel() for x in _leaves(params))
    log(f"    {n_par / 1e9:.3f} B parameters, init {init_s:.2f} s")
    reqs = serve_requests(cfg.vocab)
    timed = engine_vs_serial(torch, model, params, reqs, counters,
                             warm_up=True)
    launches = {f"{cfg.name} bfloat16": timed["launches"]}
    log(f"    {timed['tokens_per_s']:.1f} tokens/s over the engine run; "
        f"launches in it: {timed['launches']}")
    timed.update(decode_profile(torch, model, params, reqs, counters),
                 init_s=init_s, params=n_par,
                 peak_memory=torch.cuda.max_memory_allocated())
    del params, model
    torch.cuda.empty_cache()

    checks = {}
    for base in (qwen1_5_32b.CONFIG, mistral_large_123b.CONFIG):
        for dtype in ("float32", "bfloat16"):
            part(f"(3) {base.name}, {DENSE_CHECK_LAYERS} layers, {dtype}")
            cfg = dataclasses.replace(base, n_layers=DENSE_CHECK_LAYERS,
                                      dtype=dtype)
            model = build(cfg)
            params = model.init(0, dev)
            n_par = sum(x.numel() for x in _leaves(params))
            n_bytes = sum(x.numel() * x.element_size()
                          for x in _leaves(params))
            log(f"    {n_par / 1e9:.3f} B parameters "
                f"({n_bytes / 2**30:.2f} GiB)")
            run = engine_vs_serial(
                torch, model, params,
                serve_requests(cfg.vocab)[:DENSE_CHECK_REQUESTS], counters)
            launches[f"{cfg.name} {dtype}"] = run["launches"]
            log(f"    launches in the engine run: {run['launches']}")
            checks[f"{cfg.name} {dtype}"] = dict(run, params=n_par)
            del params, model
            torch.cuda.empty_cache()
    for name, counts in launches.items():
        if not all(counts.values()):
            raise AssertionError(f"a dense kernel never launched in "
                                 f"{name}'s run: {counts}")
    part("done")
    print(json.dumps({"golden": golden, "timed": timed, "checks": checks,
                      "launches": launches}))
    return 0


# the __global__ functions of csrc/ that the serving path launches
PORT_KERNELS = ("rmsnorm_rows_kernel", "wgmma_kernel", "flash_kernel",
                "decode_kernel", "mma_decode_kernel", "topk_router_kernel")


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


def check_training_kernels(torch, C, FA, RN, TR) -> dict:
    """Phase 3, the training kernels: the forward's training instance
    (`flash_attention_lse`) and the three backward kernels, each against
    its plain version on the card on `cases.TRAIN_ATTN_CASES`,
    `RMS_BWD_CASES` and `ROUTER_BWD_CASES` (`C.check_attn_train`,
    `check_rms_bwd`, `check_router_bwd`).  Returns the largest absolute
    error per kernel."""
    dev = torch.device("cuda")
    errs = dict.fromkeys(TRAIN_KERNELS + DENSE_TRAIN_KERNELS, 0.0)
    for k, case in enumerate(C.TRAIN_ATTN_CASES):
        fwd, bwd = C.check_attn_train(FA, k, dev)
        lse_key, bwd_key = ("flash_attention_lse", "flash_attention_bwd") \
            if case[1]["d"] < 128 else (DENSE_LSE, DENSE_BWD[case[2]])
        errs[lse_key] = max(errs[lse_key], fwd)
        errs[bwd_key] = max(errs[bwd_key], bwd)
        log(f"  flash_attention_lse / _bwd {case[0]}: abs err {fwd:.3g} / "
            f"{bwd:.3g}")
    for k, case in enumerate(C.RMS_BWD_CASES):
        e = C.check_rms_bwd(RN, k, dev)
        key = DENSE_RMS_BWD if case[1]["shape"][-1] in T.DENSE_RMS_D \
            else "rmsnorm_bwd"
        errs[key] = max(errs[key], e)
        log(f"  rmsnorm_bwd {case[0]}: abs err {e:.3g}")
    for k, case in enumerate(C.ROUTER_BWD_CASES):
        e = C.check_router_bwd(TR, k, dev)
        errs["topk_router_bwd"] = max(errs["topk_router_bwd"], e)
        log(f"  topk_router_bwd {case[0]}: abs err {e:.3g}")
    return errs


def measure_training(torch, C, FA, RN, TR, errs) -> list:
    """Phase 5, the training kernels at the shapes of phase 9's full run
    (a microbatch of 4 x 256 tokens, bf16; `timing.train_calls`): device
    time per call
    of the kernel, of its plain version and of one PyTorch call of the
    same function (the backward through scaled_dot_product_attention and
    the backward of F.rms_norm, each the time of forward and backward
    less the forward's, both captured whole: autograd runs a backward on
    its forward's stream; none for the router), beside the bound: the
    bytes each input is read once and each output written once, or the
    flops (the backward's 2.5 times the forward's causal matmul flops).
    `launches` is filled from phase 9."""
    dev = torch.device("cuda")
    attn, rms = T.train_calls(C, FA, RN, dev)
    out = [call_record(attn, "flash_attention_lse",
                       TRAIN_REPLACES["flash_attention_lse"],
                       errs["flash_attention_lse"], BF16_FLOPS,
                       prefix="fwd_"),
           call_record(attn, "flash_attention_bwd",
                       TRAIN_REPLACES["flash_attention_bwd"],
                       errs["flash_attention_bwd"], BF16_FLOPS),
           call_record(rms, "rmsnorm_bwd", TRAIN_REPLACES["rmsnorm_bwd"],
                       errs["rmsnorm_bwd"], OPS_PER_S)]
    rows, e, k = TRAIN_MICRO * TRAIN_SEQ, 32, 8
    logits = C.to_torch(C.router_inputs(9, rows, e)).to(dev)
    rw, ridx = TR.topk_router(logits, k)
    rdw = torch.randn((rows, k), generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    router = {"name": "topk_router_bwd", "shape":
              f"w/idx/dw [{rows},{k}] -> dlogits [{rows},{e}] f32",
              "fn": lambda: TR.topk_router_bwd(rw, ridx, rdw, e),
              "plain": lambda: TR.topk_router_bwd_ref(rw, ridx, rdw, e),
              "library": lambda: None,
              "bytes": 12 * rows * k + 4 * rows * e,
              "ops": rows * (3 * k + e)}
    out.append(call_record(router, "topk_router_bwd",
                           TRAIN_REPLACES["topk_router_bwd"],
                           errs["topk_router_bwd"], OPS_PER_S))
    out[-1]["library_note"] = "no one PyTorch call computes it"
    return out


def call_record(call: dict, name: str, replaces: str, err: float,
                rate: float, prefix: str = "") -> dict:
    """A kernels-line record of one timed call of `timing` (its keys
    `fn`, `plain`, `library`, `bytes`, `ops`, or with `prefix` "fwd_" the
    forward's): device ms of the kernel, its plain version and the
    library call, eager ms, and the bound at `rate` operations a
    second."""
    def get(key):
        return call[prefix + key]
    fn = call["fwd"] if prefix else call["fn"]
    src = "flash_attention" if prefix else call["name"]
    b_ms, b_by = bound(get("bytes"), get("ops"), rate)
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/csrc/{src}.cu",
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "ms": T.device_ms(fn), "plain_ms": T.device_ms(get("plain")),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": get("library")(), "shape": call["shape"],
           "eager_ms": T.eager_ms(fn)}
    lib = "none" if rec["library_ms"] is None \
        else f"{rec['library_ms']:.5f}"
    log(f"  {name} {call['shape']}: {rec['ms']:.5f} ms/call (plain "
        f"{rec['plain_ms']:.5f}, library {lib}), eager "
        f"{rec['eager_ms']:.5f} ms, bound {b_ms:.7f} ms ({b_by})")
    return rec


def measure_dense_training(torch, C, FA, RN, errs) -> list:
    """Phase 5, the dense configs' training instances at their training
    microbatch (`timing.dense_train_calls`: 4 x 256 tokens): attention's
    training forward at D=128 (`flash_attention_lse[D=128]`, beside
    SDPA's forward) and the backward at D=128 in bf16 (one shape a
    config, with the kernel's registers and spilled bytes) and in
    float32 (qwen2.5-32b's heads), beside the backward through SDPA;
    `rmsnorm_bwd` at d 5120 and 12288 beside F.rms_norm's backward.
    Records as `call_record`'s, each with its shapes under `by_shape`;
    `launches` is filled from phase 11."""
    dev = torch.device("cuda")
    out = {}
    for call in T.dense_train_calls(C, FA, RN, dev):
        if call["name"] == "rmsnorm_bwd":
            recs = [call_record(call, DENSE_RMS_BWD,
                                TRAIN_REPLACES["rmsnorm_bwd"],
                                errs[DENSE_RMS_BWD], OPS_PER_S)]
        else:
            bf = "float32" not in call["shape"]
            key = DENSE_BWD["bfloat16" if bf else "float32"]
            rec = call_record(call, key,
                              TRAIN_REPLACES["flash_attention_bwd"],
                              errs[key], BF16_FLOPS if bf else OPS_PER_S)
            rec["config"] = call["config"]
            recs = [rec]
            if bf:
                kw = call["kw"]
                rec.update(FA.bwd_attributes(128))
                log(f"    group {kw['hq'] // kw['hkv']}: {rec['registers']} "
                    f"registers, {rec['local_bytes']} local bytes a thread")
                fwd = call_record(call, DENSE_LSE,
                                  TRAIN_REPLACES["flash_attention_lse"],
                                  errs[DENSE_LSE], BF16_FLOPS,
                                  prefix="fwd_")
                fwd["config"] = call["config"]
                recs.append(fwd)
        for rec in recs:
            if rec["name"] in out:
                out[rec["name"]]["by_shape"].append(rec)
            else:
                out[rec["name"]] = rec | {"by_shape": [rec]}
    return list(out.values())


def train_wrappers():
    """{name: wrapper} of every kernel a training step launches: the
    serving kernels' forwards (attention through its training instance)
    and the three backward kernels."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rmsnorm import ops as RN
    from repro_torch.kernels.topk_router import ops as TR
    return {"rmsnorm": RN.rmsnorm, "flash_attention": FA.flash_attention,
            "topk_router": TR.topk_router,
            "flash_attention_lse": FA.flash_attention_lse,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "rmsnorm_bwd": RN.rmsnorm_bwd,
            "topk_router_bwd": TR.topk_router_bwd}


def block_grad_check(torch, cfg, kind: str, shape: tuple, seed: int,
                     tol: float, label: str) -> dict:
    """One full-width block of `cfg` (FFN `kind`) on a [B, S, d] input
    (`shape` = (B, S)) through torch.autograd on the card, against the
    same block with every kernel swapped for its plain version (the
    layers' `rmsnorm` and `blockwise_attention` and the MoE's router
    patched to `rmsnorm_ref`, `flash_attention_ref` and
    `topk_router_ref`, which torch.autograd differentiates): every
    gradient leaf, and the input's, within `tol` of relative norm.  QKV
    biases, where the config has them, are drawn nonzero (`lm_init`
    draws zeros).  The kernel run must launch every training kernel of
    the block, the plain run none."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rmsnorm import ops as RN
    from repro_torch.kernels.topk_router import ops as TR
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TM
    dev = torch.device("cuda")
    b, s = shape
    plain = {(L, "rmsnorm"): lambda x, w, eps=1e-6: RN.rmsnorm_ref(x, w, eps),
             (L, "blockwise_attention"):
                 lambda q, k, v, scale=None: FA.flash_attention_ref(
                     q, k, v, scale=scale),
             (M, "topk_router"): TR.topk_router_ref}
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = TM.block_init(gen, cfg, kind)
    if cfg.qkv_bias:
        for name in ("bias_q", "bias_k", "bias_v"):
            x = p["attn"][name]
            p["attn"][name] = ((torch.rand(x.shape, generator=gen, device=dev)
                                * 2 - 1) * cfg.d_model ** -0.5).to(x.dtype)
    h = torch.randn((b, s, cfg.d_model), generator=gen,
                    device=dev).to(p["attn"]["wq"].dtype)
    r = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    live = TM.tree_map(lambda x: x.detach().requires_grad_(True), p)
    named = list(_named_leaves(live))
    hh = h.requires_grad_(True)

    def grads():
        y, aux = TM.block_train(live, cfg, kind, hh, pos)
        return torch.autograd.grad((y.float() * r).sum() + aux,
                                   [x for _, x in named] + [hh])
    wrappers = train_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    got = grads()
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in wrappers.items()}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
        want = grads()
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    plain_launched = sum(fn.launches for fn in wrappers.values()) \
        - sum(launched.values())
    need = ["rmsnorm", "flash_attention_lse", "flash_attention_bwd",
            "rmsnorm_bwd"] + (["topk_router", "topk_router_bwd"]
                              if kind == "moe" else [])
    if any(not launched[n] for n in need) or plain_launched:
        raise AssertionError(f"grad check {label}: kernel launches "
                             f"{launched}, plain run {plain_launched}")
    rel = [float((g.float() - w.float()).norm()
                 / w.float().norm().clamp(min=1e-30))
           for g, w in zip(got, want)]
    worst = sorted(zip(rel, [n for n, _ in named] + ["input"]),
                   reverse=True)[:3]
    log(f"  {label} block [{b},{s},{cfg.d_model}] ({cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads{', QKV bias' if cfg.qkv_bias else ''}): "
        f"{len(rel)} gradients, largest relative error {max(rel):.3g} (tol "
        f"{tol:.3g}; worst {', '.join(f'{n} {e:.3g}' for e, n in worst)}); "
        f"launches {launched}")
    if max(rel) > tol or not all(bool(torch.isfinite(g).all())
                                 for g in got):
        raise AssertionError(f"grad check {label}: relative errors {rel}")
    return {"max_rel_err": max(rel), "leaves": len(rel), "tol": tol,
            "worst": [[n, e] for e, n in worst], "launches": launched}


def grad_check(torch) -> dict:
    """Phase 9 (1): one full-width granite block, dense and MoE, in
    float32 (`block_grad_check` on a GRAD_CHECK_SHAPE input, within
    GRAD_CHECK_TOL)."""
    import dataclasses

    from repro_torch.configs import granite_moe_1b
    cfg = dataclasses.replace(granite_moe_1b.CONFIG, dtype="float32")
    return {kind: block_grad_check(torch, cfg, kind, GRAD_CHECK_SHAPE, 11,
                                   GRAD_CHECK_TOL, f"{kind} f32")
            for kind in ("dense", "moe")}


def full_step_grads(torch, cfg=None, label="full model") -> dict:
    """Phase 9 (1): one lm_loss step of the bf16 model at full width and
    TRAIN_LAYERS layers (or of `cfg`) on a training microbatch: every
    parameter leaf's gradient must be finite with a nonzero norm (a
    kernel output outside the autograd graph leaves its inputs' leaves
    without one)."""
    import dataclasses

    from repro_torch.configs import granite_moe_1b
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build
    from repro_torch.train.train_step import value_and_grad
    if cfg is None:
        cfg = dataclasses.replace(granite_moe_1b.CONFIG,
                                  n_layers=TRAIN_LAYERS)
    model = build(cfg)
    params = model.init(1, "cuda")
    pipe = TokenPipeline(cfg.vocab, TRAIN_MICRO, TRAIN_SEQ, seed=1,
                         device="cuda")
    batch = next(pipe)
    pipe.close()
    (loss, metrics), grads = value_and_grad(model.loss, params, batch)
    norms = {p: float(g.float().norm()) for p, g in _named_leaves(grads)}
    bad = {k: v for k, v in norms.items() if not (v > 0 and v < float("inf"))}
    log(f"  {label}, one microbatch: loss {float(loss):.6f} (xent "
        f"{float(metrics['xent']):.6f}, aux {float(metrics['aux']):.6f}); "
        f"{len(norms)} gradient leaves, smallest norm "
        f"{min(norms.values()):.4g} ({min(norms, key=norms.get)})")
    if bad or not torch.isfinite(loss):
        raise AssertionError(f"leaves without a finite nonzero gradient: "
                             f"{bad}")
    del params, grads
    torch.cuda.empty_cache()
    return {"loss": float(loss), "leaves": len(norms),
            "min_grad_norm": min(norms.values())}


def golden_train(torch) -> dict:
    """Phase 9 (2): the golden run (`repro_torch.train.golden.run`) on the
    card, on the golden's own batches, held to
    golden/granite_moe_train.json within `golden.GRANITE.tol`; and how
    many of
    those tokens this machine's `TokenPipeline` draws otherwise (numpy's
    zipf differs between numpy versions; logged, not held)."""
    from repro_torch.train import golden as G
    spec = G.GRANITE
    doc = G.load()
    want = G.batches(doc, "cuda")
    drawn = G.pipeline_batches("cuda")
    differ = sum(int((a["tokens"] != b["tokens"]).sum())
                 for a, b in zip(drawn, want))
    t0 = time.perf_counter()
    rec = G.run("cuda", want)
    gap = G.compare(doc, rec)
    log(f"  golden config (full width, {spec.n_layers} layers, f32, batch "
        f"{spec.batch}x{spec.seq}, microbatch {spec.microbatch}, adamw, "
        f"{spec.steps} steps) in {time.perf_counter() - t0:.2f} s: losses "
        f"{[s['loss'] for s in rec['steps']]}; relative gap to the JAX run "
        f"{gap} (tol {spec.tol}); this machine's TokenPipeline draws "
        f"{differ} of the golden's {spec.steps * spec.batch * spec.seq} "
        f"tokens otherwise (numpy {__import__('numpy').__version__})")
    if max(gap.values()) > spec.tol:
        raise AssertionError(f"golden training run off by {gap}")
    return {"steps": rec["steps"], "gap": gap, "tol": spec.tol,
            "pipeline_tokens_differing": differ}


def _named_leaves(tree, prefix: str = ""):
    """(path, leaf) of a tree of dicts, keys in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def _params_equal(torch, a: dict, b: dict) -> bool:
    return all(pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in
               zip(_named_leaves(a), _named_leaves(b)))


def full_run(torch) -> dict:
    """Phase 9 (3): `Trainer` on the model at full width and TRAIN_LAYERS
    layers (bf16, batch 8 x 256 in microbatches of 4, AdamW, remat full):
    1 warm-up step and
    4 timed, with every training kernel's launch count set to 0 just
    before and read just after; losses finite; step ms (median of the
    timed steps), tokens/s, peak memory; then two runs of the same 2
    steps, bitwise equal in loss and parameters; then one step under
    torch.profiler for the device's busy time and idle share."""
    import dataclasses

    from repro_torch.configs import granite_moe_1b
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(granite_moe_1b.CONFIG, n_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       microbatch=TRAIN_MICRO, log_every=1)
    wrappers = train_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    tr = Trainer(cfg, tcfg, device="cuda")
    state = tr.run()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    tr_step_times = tr.step_times
    step_s = statistics.median(tr_step_times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log(f"  {TRAIN_LAYERS} layers: losses {losses}; step s "
        f"{tr.step_times}; median "
        f"of the timed steps {step_s * 1e3:.3f} ms, {tokens / step_s:.1f} "
        f"tokens/s; peak memory {peak / 2**30:.3f} GiB")
    log(f"    launches in the run: {launches}; a step: {per_step}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    # the serving instance of attention stays idle: training's forward is
    # the training instance
    if launches["flash_attention"] or not all(
            launches[n] for n in wrappers if n != "flash_attention"):
        raise AssertionError(f"training launches {launches}")

    # the device's busy time over one more step of the same run
    step_fn = tr._step_fn
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=tcfg.seed,
                         device="cuda")
    batch = next(pipe)
    pipe.close()
    params, opt = state["params"], state["opt"]
    busy_s, kernels = device_busy(torch, lambda: step_fn(params, opt, batch))
    top = sorted(kernels, key=_dev_us, reverse=True)[:10]
    prof = {"device_busy_ms": busy_s * 1e3, "step_ms": step_s * 1e3,
            "idle_share": 1.0 - busy_s / step_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_ms": _dev_us(e) / 1e3} for e in top]}
    log(f"  one step under torch.profiler: device busy "
        f"{prof['device_busy_ms']:.3f} ms of {prof['step_ms']:.3f} ms: "
        f"idle share {prof['idle_share']:.4f}; "
        f"{prof['kernel_launches']} kernel launches")
    for t in prof["top"]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:6d}  {t['name']}")
    del state, params, opt, tr
    torch.cuda.empty_cache()

    # two runs of the same 2 steps: the same bits
    runs = []
    for _ in range(2):
        t2 = Trainer(cfg, TrainConfig(steps=2, batch=TRAIN_BATCH,
                                      seq=TRAIN_SEQ, microbatch=TRAIN_MICRO,
                                      log_every=1), device="cuda")
        st = t2.run()
        runs.append(([m["loss"] for m in t2.metrics_log], st["params"]))
        del st
    same = runs[0][0] == runs[1][0] and _params_equal(torch, runs[0][1],
                                                      runs[1][1])
    log(f"  two runs of 2 steps: losses {runs[0][0]} and {runs[1][0]}; "
        f"bitwise equal (losses and parameters): {same}")
    if not same:
        raise AssertionError("two runs of the same steps differ")
    del runs
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": list(tr_step_times),
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "max_memory_allocated": peak, "launches": launches,
            "launches_per_step": per_step, "profile": prof,
            "repeat_bitwise": same}


def restart_run(torch, spec=None, base=None) -> dict:
    """Phase 9 (4), phase 11 (2): `Trainer` at the size of the golden
    `spec` (default granite's), from its numpy weights (`base`, their
    tree on the card, or drawn here), 3 steps, with a checkpoint every 2
    steps and a failure injected at step 2 (after the step-2 checkpoint)
    restarts once, and its final parameters are bitwise the
    uninterrupted run's."""
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.models import transformer as TM
    from repro_torch.train import golden as G
    from repro_torch.train.trainer import TrainConfig, Trainer
    spec = spec or G.GRANITE
    cfg = G.config(spec)
    if base is None:
        base = convert.lm_params_to_torch(
            convert.numpy_lm_params(cfg, spec.seed), "cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT,
                                                                  "build"))
    finals, restarts = [], []
    t0 = time.perf_counter()
    try:
        for ckpt_dir, fail_at in ((None, None), (ckpt, 2)):
            tcfg = TrainConfig(steps=3, batch=spec.batch, seq=spec.seq,
                               microbatch=spec.microbatch, lr=spec.lr,
                               warmup=spec.warmup, ckpt_dir=ckpt_dir,
                               ckpt_every=2, log_every=1)
            tr = Trainer(cfg, tcfg, device="cuda")
            params = TM.tree_map(torch.clone, base)
            finals.append(tr.run(fail_at=fail_at, params=params)["params"])
            restarts.append(tr.restarts)
            del tr, params
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = _params_equal(torch, finals[0], finals[1])
    log(f"  {spec.arch} golden size, 3 steps, checkpoint every 2, failure "
        f"at step 2: restarts {restarts[1]}; final parameters bitwise the "
        f"uninterrupted run's: {same} ({time.perf_counter() - t0:.1f} s)")
    del finals
    torch.cuda.empty_cache()
    if restarts != [0, 1] or not same:
        raise AssertionError(f"restart run: restarts {restarts}, equal "
                             f"{same}")
    return {"restarts": restarts[1], "bitwise": same}


def train_child(torch) -> int:
    """Phase 9 in a child process, with PyTorch's deterministic
    algorithms on (`trainer.deterministic`, before the first product on
    the card): the gradient check, the golden run, the full run and the
    restart run; one JSON line last, with the full run's launches."""
    from repro_torch.train.trainer import deterministic
    deterministic()
    t0 = time.perf_counter()

    def part(msg):
        log(f"  {msg}  [child at {time.perf_counter() - t0:.1f} s]")
    part("(1) gradients")
    grads = grad_check(torch)
    full_grads = full_step_grads(torch)
    part("(2) the golden run")
    gold = golden_train(torch)
    part("(3) the full run")
    full = full_run(torch)
    part("(4) restart")
    restart = restart_run(torch)
    part("done")
    print(json.dumps({"grad_check": grads, "full_step_grads": full_grads,
                      "golden": gold, "full": full, "restart": restart,
                      "launches": full["launches"]}))
    return 0


def dense_train_launches(rec: dict, launches: dict) -> None:
    """Fill a dense training instance's kernels-line record (and each of
    its shapes) with its launches in phase 11: the bf16 instances' in the
    bf16 run of the shape's config (`rmsnorm_bwd[d=5120,12288]`: d 5120
    in the two qwens', 12288 in mistral-large-123b's), the float32
    backward's in the golden run."""
    if rec["name"] == DENSE_BWD["float32"]:
        n = launches["mistral-large-123b float32 golden"][
            "flash_attention_bwd"]
        for sub in rec["by_shape"]:
            sub["launches"] = n
        rec["launches"] = n
        return
    wrapper = rec["name"].split("[")[0]
    total = 0
    for sub in rec["by_shape"]:
        if rec["name"] == DENSE_RMS_BWD:
            names = [c for c in launches if c.endswith("bfloat16")
                     and (c.startswith("mistral") == ("12288" in
                                                      sub["shape"]))]
        else:
            names = [f"{sub['config']} bfloat16"]
        sub["launches"] = sum(launches[c][wrapper] for c in names)
        total += sub["launches"]
    rec["launches"] = total


def dense_grad_check(torch) -> dict:
    """Phase 11 (1): one full-width block of each dense config
    (qwen2.5-32b: d 5120, 40/8 heads, QKV bias; qwen1.5-32b: 40/40, bias;
    mistral-large-123b: d 12288, 96/8), in float32 and in bf16
    (`block_grad_check` on a DENSE_GRAD_SHAPE input, within
    DENSE_GRAD_TOL of the type)."""
    import dataclasses

    from repro_torch.configs import mistral_large_123b, qwen1_5_32b, \
        qwen2_5_32b
    out = {}
    for base in (qwen2_5_32b.CONFIG, qwen1_5_32b.CONFIG,
                 mistral_large_123b.CONFIG):
        for dtype in ("float32", "bfloat16"):
            key = f"{base.name} {dtype}"
            out[key] = block_grad_check(
                torch, dataclasses.replace(base, dtype=dtype), "dense",
                DENSE_GRAD_SHAPE, 13, DENSE_GRAD_TOL[dtype], key)
            torch.cuda.empty_cache()
    return out


def dense_golden_train(torch) -> dict:
    """Phase 11 (2): the golden run of mistral-large-123b
    (`train.golden.MISTRAL_LARGE`: full width, 1 layer, float32, numpy
    weights, 3 Adafactor steps of 2 x 64 tokens) on the golden's batches,
    held to `golden/mistral_large_train.json` within its `tol`; a second
    run bitwise the first (losses and parameters); then `restart_run` at
    that size.  The float32 D=128 backward's launches are the first
    run's."""
    from repro_torch import convert
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as TM
    from repro_torch.train import golden as G
    spec = G.MISTRAL_LARGE
    doc = G.load(spec.path)
    want = G.batches(doc, "cuda")
    cfg = G.config(spec)
    t0 = time.perf_counter()
    base = convert.lm_params_to_torch(
        convert.numpy_lm_params(cfg, spec.seed), "cuda")
    init_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        t1 = time.perf_counter()
        before = FA.flash_attention_bwd.launches
        rec = G.run("cuda", want, spec, TM.tree_map(torch.clone, base))
        torch.cuda.synchronize()
        rec["launches"] = FA.flash_attention_bwd.launches - before
        rec["s"] = time.perf_counter() - t1
        runs.append(rec)
    gap = G.compare(doc, runs[0])
    same = [st["loss"] for st in runs[0]["steps"]] \
        == [st["loss"] for st in runs[1]["steps"]] \
        and _params_equal(torch, runs[0]["params"], runs[1]["params"])
    n_par = sum(x.numel() for _, x in _named_leaves(runs[0]["params"]))
    log(f"  golden {spec.arch} ({', '.join(spec.reduced)}; "
        f"{n_par / 1e9:.3f} B parameters, numpy weights on the card in "
        f"{init_s:.1f} s), "
        f"{spec.optimizer}: runs of {runs[0]['s']:.2f} and "
        f"{runs[1]['s']:.2f}"
        f" s; losses {[st['loss'] for st in runs[0]['steps']]}; relative "
        f"gap to the JAX run {gap} (tol {spec.tol}); rerun bitwise: {same}")
    if max(gap.values()) > spec.tol:
        raise AssertionError(f"golden {spec.arch} training run off by "
                             f"{gap}")
    if not same:
        raise AssertionError(f"two golden {spec.arch} runs differ")
    launches = runs[0]["launches"]
    steps = runs[0]["steps"]
    del runs
    torch.cuda.empty_cache()
    restart = restart_run(torch, spec, base)
    del base
    torch.cuda.empty_cache()
    return {"steps": steps, "gap": gap, "tol": spec.tol,
            "rerun_bitwise": same, "restart": restart, "params": n_par,
            "launches": {"flash_attention_bwd": launches}}


def dense_timed_train(torch) -> dict:
    """Phase 11 (3): `Trainer` on qwen2.5-32b at full width and
    DENSE_TRAIN_LAYERS layers (bf16, batch 8 x 256 in microbatches of 4,
    AdamW, remat full; `lm_init` on the card): 1 warm-up step and 4
    timed, with the training kernels' launch counts set to 0 just before
    and read just after; `flash_attention_bwd` once a layer a microbatch
    a step; finite losses, step ms (median of the timed steps), tokens/s,
    peak memory, launches a step; then one step under torch.profiler
    (device busy time, idle share, device time by kernel name); then
    one microbatch's gradient in every leaf finite and nonzero."""
    import dataclasses

    from repro_torch.configs import qwen2_5_32b
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(qwen2_5_32b.CONFIG,
                              n_layers=DENSE_TRAIN_LAYERS)
    tcfg = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       microbatch=TRAIN_MICRO, log_every=1)
    wrappers = train_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    tr = Trainer(cfg, tcfg, device="cuda")
    state = tr.run()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    n_par = sum(x.numel() for _, x in _named_leaves(state["params"]))
    losses = [m["loss"] for m in tr.metrics_log]
    step_times = list(tr.step_times)
    step_s = statistics.median(step_times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log(f"  {cfg.name}, {DENSE_TRAIN_LAYERS} layers, bf16 "
        f"({n_par / 1e9:.3f} B parameters): losses {losses}; step s "
        f"{step_times}; median of the timed steps {step_s * 1e3:.3f} ms,"
        f" {tokens / step_s:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"    launches in the run: {launches}; a step: {per_step}")
    want_bwd = TRAIN_STEPS * (TRAIN_BATCH // TRAIN_MICRO) \
        * DENSE_TRAIN_LAYERS
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if launches["flash_attention_bwd"] != want_bwd or launches[
            "flash_attention"] or not all(
            launches[n] for n in ("rmsnorm", "flash_attention_lse",
                                  "rmsnorm_bwd")):
        raise AssertionError(f"training launches {launches}, want "
                             f"{want_bwd} of flash_attention_bwd")
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=tcfg.seed,
                         device="cuda")
    batch = next(pipe)
    pipe.close()
    params, opt = state["params"], state["opt"]
    step_fn = tr._step_fn
    busy_s, kernels = device_busy(torch,
                                  lambda: step_fn(params, opt, batch))
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]
    prof = {"device_busy_ms": busy_s * 1e3, "step_ms": step_s * 1e3,
            "idle_share": 1.0 - busy_s / step_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_ms": _dev_us(e) / 1e3} for e in top]}
    log(f"  one step under torch.profiler: device busy "
        f"{prof['device_busy_ms']:.3f} ms of {prof['step_ms']:.3f} ms: "
        f"idle share {prof['idle_share']:.4f}; "
        f"{prof['kernel_launches']} kernel launches")
    for t in prof["top"]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:6d}  {t['name']}")
    del state, params, opt, tr, step_fn
    torch.cuda.empty_cache()
    grads = full_step_grads(torch, cfg, f"{cfg.name} {DENSE_TRAIN_LAYERS} "
                                        f"layers bf16")
    return {"config": cfg.name, "layers": DENSE_TRAIN_LAYERS,
            "params": n_par, "losses": losses,
            "step_s": step_times,
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "max_memory_allocated": peak, "launches": launches,
            "launches_per_step": per_step, "profile": prof,
            "grads": grads}


def dense_check_train(torch) -> dict:
    """Phase 11 (4): qwen1.5-32b and mistral-large-123b at full width and
    DENSE_TRAIN_CHECK_LAYERS layers, bf16, each with its own optimizer
    (AdamW, Adafactor), DENSE_TRAIN_CHECK_STEPS steps of `Trainer` at
    phase 9's batch shape, the training kernels' launch counts set to 0
    just before and read just after: finite losses, `flash_attention_bwd`
    and `rmsnorm_bwd` launched; then one microbatch's gradient in every
    leaf finite and nonzero."""
    import dataclasses

    from repro_torch.configs import mistral_large_123b, qwen1_5_32b
    from repro_torch.train.trainer import TrainConfig, Trainer
    out = {}
    for base in (qwen1_5_32b.CONFIG, mistral_large_123b.CONFIG):
        cfg = dataclasses.replace(base, n_layers=DENSE_TRAIN_CHECK_LAYERS)
        wrappers = train_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        tr = Trainer(cfg, TrainConfig(steps=DENSE_TRAIN_CHECK_STEPS,
                                      batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                      microbatch=TRAIN_MICRO, log_every=1),
                     device="cuda")
        state = tr.run()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        losses = [m["loss"] for m in tr.metrics_log]
        log(f"  {cfg.name}, {cfg.n_layers} layers, bf16, {cfg.optimizer}: "
            f"losses {losses}; step s {tr.step_times}; launches {launches}")
        if not all(math.isfinite(x) for x in losses) or not all(
                launches[n] for n in ("flash_attention_bwd", "rmsnorm_bwd",
                                      "flash_attention_lse", "rmsnorm")):
            raise AssertionError(f"{cfg.name}: losses {losses}, launches "
                                 f"{launches}")
        del state, tr
        torch.cuda.empty_cache()
        out[cfg.name] = {"layers": cfg.n_layers, "optimizer": cfg.optimizer,
                         "losses": losses, "launches": launches,
                         "grads": full_step_grads(
                             torch, cfg, f"{cfg.name} {cfg.n_layers} "
                                         f"layers bf16")}
    return out


def dense_train_child(torch) -> int:
    """Phase 11 in a child process, with PyTorch's deterministic
    algorithms on (`trainer.deterministic`): the dense configs' gradient
    check, mistral-large-123b's golden run (with its rerun and restart),
    qwen2.5-32b's timed run, and the other two configs' checks; one JSON
    line last, with the launches by run."""
    from repro_torch.train.trainer import deterministic
    deterministic()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def part(msg):
        log(f"  {msg}  [child at {time.perf_counter() - t0:.1f} s]")
    part("(1) gradients of one full-width block")
    grads = dense_grad_check(torch)
    part("(2) mistral-large-123b's golden run, rerun and restart")
    gold = dense_golden_train(torch)
    part(f"(3) qwen2.5-32b, {DENSE_TRAIN_LAYERS} layers, bfloat16, timed")
    timed = dense_timed_train(torch)
    part(f"(4) qwen1.5-32b and mistral-large-123b, "
         f"{DENSE_TRAIN_CHECK_LAYERS} layers, bfloat16")
    checks = dense_check_train(torch)
    part("done")
    launches = {f"{timed['config']} bfloat16": timed["launches"],
                "mistral-large-123b float32 golden": gold["launches"]}
    launches.update({f"{name} bfloat16": rec["launches"]
                     for name, rec in checks.items()})
    print(json.dumps({"grad_check": grads, "golden": gold, "timed": timed,
                      "checks": checks, "launches": launches}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record as JSON to this path")
    ap.add_argument("--bool-layout-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--replica-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sweep-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dense-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dense-train-child", action="store_true",
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
    if args.replica_child:
        return replica_child(torch, SF, FT)
    if args.sweep_child:
        return sweep_child(SF, FT)
    if args.train_child:
        return train_child(torch)
    if args.dense_child:
        return dense_child(torch)
    if args.dense_train_child:
        return dense_train_child(torch)
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
    phase(t_start, "[3] the training kernels: flash_attention's training "
                   "instance and the three backward kernels")
    errs.update(check_training_kernels(torch, C, FA, RN, TR))

    phase(t_start, "[4] main path: the simulator's workloads through "
                   "run_cell")
    counters = (SF.drain_writeback, FT.plane_commit, FT.trip_plan)
    cells = main_cells()
    rows, launches = counted(counters, lambda: run_cells(cells, counters))
    log(f"    launches in the golden cells: {launches}")
    phase(t_start, "[4] worksteal's app drivers: run_app at the paper's "
                   "64 CUs")
    apps, app_launches = counted(counters, app_drivers)
    log(f"    launches in the app drivers: {app_launches}")
    phase(t_start, "[4] full-width kv_serving: the committed sweep's "
                   "serving shape")
    scale = serving_scale(torch, counters)
    phase(t_start, "[4] elastic engines: crash red/green, zero churn, "
                   "leave/join (golden/churn.json)")
    churn, churn_launches = counted(counters,
                                    lambda: run_churn(None, counters[:2]))
    log(f"    launches in the churn cells: {churn_launches}")
    phase(t_start, "[4] the trace ring: the six n=64 srsp fused cells "
                   "untraced and traced (golden/trace.*), the report demo")
    traced, trace_launches = counted(counters,
                                     lambda: trace_cells(torch, counters))
    log(f"    launches in the traced and untraced cells: {trace_launches}")
    if not all(trace_launches.values()):
        raise AssertionError(f"a kernel never launched in the trace "
                             f"cells: {trace_launches}")
    demo = trace_demo()
    trace_op = record_op_eager(torch)
    for name in launches:
        launches[name] += app_launches[name] \
            + scale["launches_per_run"][name] + churn_launches[name] \
            + trace_launches[name]
    log(f"    launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    phase(t_start, "[4] replica axis, in a child process: golden/many.json "
                   "through run_vmapped_cell, kv_serving on own traces "
                   f"({SERVING_REPLICAS} replicas), a traced replica run")
    replica = run_child("--replica-child", "replica")
    many, scale_many = replica["many"], replica["serving_replicas"]
    for name in ("drain_writeback_many", "plane_commit_many",
                 "trip_plan_many"):
        launches[name] = replica["launches"][name]
    if not all(launches.values()):
        raise AssertionError(f"a replica kernel never launched: {launches}")
    phase(t_start, "[4] co-scheduled remote batches")
    batches = remote_batches()
    phase(t_start, "[4] the bool metadata layout, REPRO_NO_PACK=1 in a "
                   "child process")
    bool_run = run_child("--bool-layout-child", "bool",
                         dict(os.environ, REPRO_NO_PACK="1"))
    for name in ("drain_writeback_bool", "drain_writeback_bool_many"):
        launches[name] = bool_run["launches"][name]
    phase(t_start, "[4] the sweep: python3 -m repro_torch.workloads.sweep "
                   "at golden/sweep.json's argv, then a full-width slice, "
                   "traced, in a child process")
    sweep_run = run_child("--sweep-child", "sweep",
                          dict(os.environ, REPRO_TRACE="1",
                               REPRO_TRACE_CAP="4096"))
    for name, n in sweep_run["launches"].items():
        launches[name] += n

    phase(t_start, "[5] kernel times at the n=64 shapes and the serving "
                   "shapes")
    lens = [len(r.prompt) for r in serve_requests(
        granite_moe_1b.CONFIG.vocab)]
    # the serving kernels first: `measure` traces, and no time is taken
    # after a trace in this phase
    serving, one_op = measure_serving(torch, C, serve_ops, errs, lens)
    dense = measure_dense(torch, C, serve_ops, errs)
    training = measure_training(torch, C, FA, RN, TR, errs)
    dense_training = measure_dense_training(torch, C, FA, RN, errs)
    kernels = measure(torch, C, SF, FT, errs, launches) + serving \
        + dense + training + dense_training
    check_one_op(one_op)

    phase(t_start, "[6] where the time goes: one fused n=64 srsp "
                   "kv_directory run under torch.profiler")
    prof = [profile_cell(torch, w, seed, rows[cells.index((
        w, "srsp", N_MAIN, seed, "fused"))]["steady_s"])
        for w, seed in PROFILED]
    trace_op.update(record_op_ops(torch))

    phase(t_start, "[7] serving path: granite-moe-1b-a400m through "
                   "repro_torch.serve.engine")
    counters = [RN.rmsnorm, FA.flash_attention, FD.flash_decode,
                TR.topk_router]
    serve = serve_path(torch, counters)
    for rec in kernels:
        if rec["launches"] is None and rec["name"] in serve["launches"]:
            rec["launches"] = serve["launches"][rec["name"]]

    phase(t_start, "[8] cross-pod delta sync: make_pod_sync, 4 pods "
                   "stacked on the card")
    sync_recs, flush_entry = delta_sync_path(torch, SF)
    kernels.append(flush_entry)

    phase(t_start, "[9] training granite-moe-1b-a400m (repro_torch.train), "
                   "deterministic algorithms on, in a child process")
    train = run_child("--train-child", "train", timeout=900)
    for rec in kernels:
        if rec["name"] in TRAIN_KERNELS:
            rec["launches"] = train["launches"][rec["name"]]
    if not all(train["launches"][n] for n in TRAIN_KERNELS):
        raise AssertionError(f"a training kernel never launched: "
                             f"{train['launches']}")

    phase(t_start, "[10] dense serving: qwen2.5-32b (golden, timed), "
                   "qwen1.5-32b and mistral-large-123b, in a child process")
    dense_run = run_child("--dense-child", "dense", timeout=600)
    for rec in kernels:
        if rec["name"] in [r["name"] for r in dense]:
            base = rec["name"].split("[")[0]
            rec["launches"] = sum(dense_run["launches"][c][base]
                                  for c in dense_launched_by(rec["name"]))

    phase(t_start, "[11] dense training: qwen2.5-32b (timed), qwen1.5-32b and "
                   "mistral-large-123b (golden), deterministic algorithms "
                   "on, in a child process")
    dense_train = run_child("--dense-train-child", "dense train",
                            timeout=600)
    for rec in kernels:
        if rec["name"] in DENSE_TRAIN_KERNELS:
            dense_train_launches(rec, dense_train["launches"])
    if not all(rec["launches"] for rec in kernels):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{[r['name'] for r in kernels if not r['launches']]}")
    t_end = time.perf_counter()
    total_s = t_end - t_start
    for msg, secs in phase_times(t_end):
        log(f"    {secs:8.1f} s  {msg}")
    log(f"    total {total_s:.1f} s")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "build_s": build_s, "cells": rows,
                       "apps": apps, "serving_scale": scale,
                       "churn": churn, "many": many,
                       "serving_replicas": scale_many,
                       "trace": {"cells": traced, "demo": demo,
                                 "record_op": trace_op,
                                 "replica": replica["traced"],
                                 "bool": bool_run["traced"]},
                       "remote_batches": batches,
                       "bool_layout": bool_run, "sweep": sweep_run,
                       "kernels": kernels, "profile": prof,
                       "serve": serve, "delta_sync": sync_recs,
                       "train": train, "dense": dense_run,
                       "dense_train": dense_train,
                       "total_s": total_s,
                       "phases": phase_times(t_end),
                       "ptxas": reports}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
