"""Golden simulator counters for the PyTorch port.

`src/repro_torch/golden/<workload>.json` holds the JAX reference's full
`counters_dict`, `events` and self-check verdict for the cells the port's
chip smoke run reproduces bitwise on the card, one file per workload:
kv_directory, reader_lock, producer_consumer and producer_consumer_mc.
Two checks:

* tier-1: the golden makespans equal the committed `BENCH_workloads.json`
  rows (seed 4 at n=16 and n=64, and kv_directory's n=256 `fuse_ab`
  cell);
* slow: regenerating every file from the JAX package gives the
  committed cells exactly.

Regenerate the files with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write [WORKLOAD ...]

A file whose cells come out unchanged is left as it is, provenance
included.
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "src" / "repro_torch" / "golden"

# (scenario, n_agents, seed, engine).  kv_directory: the paper's 64-CU GPU
# for all three protocols at two seeds, plus the sweep's n=256 fused A/B
# cell.  The lock and queue workloads: the three protocols at n=64 and
# n=16, the batched and serial engines, and the scope_only staleness
# demo, whose check is red.
KV_CELLS = ([(s, 64, seed, "fused") for seed in (0, 4)
             for s in ("srsp", "rsp", "baseline")]
            + [("srsp", 256, 4, "fused")])
LOCK_QUEUE_CELLS = ([(s, 64, 4, "fused") for s in ("srsp", "rsp", "baseline")]
                    + [("srsp", 64, 4, "batched"), ("srsp", 16, 4, "serial")]
                    + [(s, 16, 4, "fused") for s in ("rsp", "baseline",
                                                     "scope_only")])
CELLS = {"kv_directory": KV_CELLS, "reader_lock": LOCK_QUEUE_CELLS,
         "producer_consumer": LOCK_QUEUE_CELLS,
         "producer_consumer_mc": LOCK_QUEUE_CELLS}
# the committed sweep's makespans at seed 4 (BENCH_workloads.json rows):
# {workload: {(scenario, n): makespan}}
BENCH_MAKESPANS = {
    "reader_lock": {("srsp", 16): 1028.0, ("rsp", 16): 3740.0,
                    ("baseline", 16): 1370.0, ("srsp", 64): 1220.0,
                    ("rsp", 64): 13180.0},
    "producer_consumer": {("srsp", 16): 7920.0, ("rsp", 16): 20312.0,
                          ("baseline", 16): 7225.0, ("srsp", 64): 31680.0,
                          ("rsp", 64): 228728.0},
    "producer_consumer_mc": {("srsp", 16): 3976.0, ("rsp", 16): 10552.0,
                             ("baseline", 16): 3825.0, ("srsp", 64): 4072.0,
                             ("rsp", 64): 31524.0},
}


def golden_path(workload: str) -> pathlib.Path:
    return GOLDEN_DIR / f"{workload}.json"


def golden_from_jax(workload: str) -> dict:
    """Run every golden cell of `workload` through the JAX reference."""
    from repro import workloads
    from repro.workloads import harness

    mod = workloads.get(workload)
    cells = []
    for scenario, n, seed, engine in CELLS[workload]:
        bench = mod.build(scenario, n, seed=seed)
        final = harness.runner(engine)(bench.wl, bench.state, *bench.ops)
        check = bench.check(final)
        cells.append({"scenario": scenario, "n_agents": n, "seed": seed,
                      "engine": engine,
                      "counters": harness.counters_dict(final.store),
                      "events": check["events"],
                      "check_ok": bool(check["ok"]),
                      "check_fails": int(check["check_fails"])})
    return {"cells": cells}


def _provenance(workload: str) -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    engines = sorted({c[3] for c in CELLS[workload]})
    return {"reference": f"repro (JAX) {workload}, harness.runner(engine), "
                         "CPU backend, kernel_mode ref",
            "jax_commit": commit,
            "engine": engines[0] if len(engines) == 1 else engines,
            "generator": "tests/test_torch_golden.py --write"}


def _golden(workload: str) -> dict:
    return json.loads(golden_path(workload).read_text())


def _cell(doc, scenario, n, seed, engine="fused"):
    return next(c for c in doc["cells"] if (
        c["scenario"], c["n_agents"], c["seed"], c["engine"])
        == (scenario, n, seed, engine))


def _bench_rows(workload):
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    return {(r["scenario"], r["n_agents"]): r for r in bench["runs"]
            if r["workload"] == workload and r["engine"] == "batched"}


def test_golden_makespans_match_committed_bench():
    doc = _golden("kv_directory")
    rows = _bench_rows("kv_directory")
    for scenario in ("srsp", "rsp", "baseline"):
        got = _cell(doc, scenario, 64, 4)
        assert got["counters"] == rows[(scenario, 64)]["counters"], scenario
        assert got["events"] == rows[(scenario, 64)]["events"] == 544
        assert got["check_ok"]
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    fuse = next(r for r in bench["fuse_ab"]
                if r["n_agents"] == 256 and r["engine"] == "fused")
    assert _cell(doc, "srsp", 256, 4)["counters"]["makespan"] \
        == fuse["makespan"] == 2031.0
    seed0 = [_cell(doc, s, 64, 0)["counters"]["makespan"]
             for s in ("srsp", "rsp", "baseline")]
    assert seed0 == [1328.0, 13790.0, 1405.0]
    assert {(c["scenario"], c["n_agents"], c["seed"], c["engine"])
            for c in doc["cells"]} == set(KV_CELLS)


@pytest.mark.parametrize("workload", sorted(BENCH_MAKESPANS))
def test_lock_queue_golden_matches_committed_bench(workload):
    """Every golden cell with a committed sweep row (seed 4, the batched
    engine's row; the engines' counters are equal) has that row's
    counters, events and verdict, and the makespans are the sweep's.  A
    row's `check_fails` sums the sweep's two replicas (seeds 4 and 5), so
    it is not compared."""
    doc = _golden(workload)
    assert {(c["scenario"], c["n_agents"], c["seed"], c["engine"])
            for c in doc["cells"]} == set(LOCK_QUEUE_CELLS)
    rows = _bench_rows(workload)
    for c in doc["cells"]:
        row = rows[(c["scenario"], c["n_agents"])]
        ctx = (workload, c["scenario"], c["n_agents"], c["engine"])
        assert c["counters"] == row["counters"], ctx
        assert (c["events"], c["check_ok"]) \
            == (row["events"], row["check_ok"]), ctx
    for (scenario, n), makespan in BENCH_MAKESPANS[workload].items():
        engine = "serial" if (scenario, n) == ("srsp", 16) else "fused"
        assert _cell(doc, scenario, n, 4, engine)["counters"]["makespan"] \
            == makespan, (scenario, n)
    assert not _cell(doc, "scope_only", 16, 4)["check_ok"]
    assert all(c["check_ok"] for c in doc["cells"]
               if c["scenario"] != "scope_only")


@pytest.mark.slow
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_golden_regenerates_from_jax(workload):
    assert golden_from_jax(workload)["cells"] == _golden(workload)["cells"]


def write(workload: str) -> None:
    path = golden_path(workload)
    cells = golden_from_jax(workload)["cells"]
    if path.exists() and _golden(workload)["cells"] == cells:
        print(f"{path}: unchanged")
        return
    doc = {"provenance": _provenance(workload), "cells": cells}
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write "
                 "[WORKLOAD ...]")
    names = [a for a in sys.argv[1:] if a != "--write"] or sorted(CELLS)
    for name in names:
        write(name)
