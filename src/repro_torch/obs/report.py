"""Trace report command (`repro.obs.report`, DESIGN.md §11).

    python -m repro_torch.obs.report TRACE.json  # report an exported trace
    python -m repro_torch.obs.report --demo      # run + trace the demo cell

The demo runs the pinned churned worksteal cell (srsp, n=4, seed 3, the
victim 0 dies holding its lock at clock 5, its CRASH event at 400, a
lease-expiry recovery drain; the richest event mix: local and remote
sync ops, probes, a CHURN instant and a RECOVER drain) on the batched
elastic engine with tracing enabled in-process (`trace.with_trace`),
exports Perfetto-loadable JSON and prints the text report.  It runs on
the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

# the demo cell: tests/test_churn.py's pinned geometry
DEMO_SCENARIO, DEMO_N, DEMO_SEED, DEMO_CHUNKS = "srsp", 4, 3, 12
DEMO_VICTIM, DEMO_AT, DEMO_EVT = 0, 5.0, 400.0
DEMO_LABEL = f"worksteal/{DEMO_SCENARIO}/n={DEMO_N}/batched_elastic+crash"


def demo(cap: int = None, device=None) -> tuple:
    """Run the demo cell traced: (final ElasticState, check dict,
    label)."""
    import torch

    from repro_torch.core import protocol as P
    from repro_torch.kernels import common
    from repro_torch.obs import trace as T
    from repro_torch.workloads import faults, harness, worksteal

    dev = common.resolve_device(device)
    proto = faults.crash_holding_lock(P.get_protocol(DEMO_SCENARIO),
                                      DEMO_VICTIM, DEMO_AT)
    bench = worksteal.build(DEMO_SCENARIO, DEMO_N, seed=DEMO_SEED,
                            proto=proto, device=dev,
                            n_chunks_max=DEMO_CHUNKS)
    eb = harness.make_elastic(bench, events=[(DEMO_EVT, DEMO_VICTIM,
                                              "crash")])
    state = T.with_trace(eb.state, cap)
    with torch.profiler.record_function(f"demo:{DEMO_LABEL}"):
        fin = harness.run_batched_elastic(eb.wl, state, *eb.ops)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return fin, eb.check(fin), DEMO_LABEL


def _run_demo(args) -> int:
    from repro_torch.obs import export
    fin, res, label = demo(args.cap, args.device)
    doc = export.write_trace(args.out, fin.s.store, label=label)
    rec = float(fin.s.store.counters.recoveries.sum())
    print(export.text_report(doc))
    print(f"check_ok={res['ok']} recovered={rec:.0f}")
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", nargs="?", help="exported trace JSON to report")
    ap.add_argument("--demo", action="store_true",
                    help="run + trace the demo cell, then report it")
    ap.add_argument("--cap", type=int, default=None,
                    help="ring capacity for --demo (default REPRO_TRACE_CAP)")
    ap.add_argument("--out", default="TRACE_demo.json",
                    help="output JSON for --demo")
    ap.add_argument("--device", default=None,
                    help="device for --demo (default: the GPU)")
    args = ap.parse_args(argv)
    if args.demo:
        return _run_demo(args)
    if not args.trace:
        ap.error("need a trace JSON path or --demo")
    from repro_torch.obs import export
    with open(args.trace) as f:
        doc = json.load(f)
    print(export.text_report(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
