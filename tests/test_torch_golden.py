"""Golden kv_directory counters for the PyTorch port.

`src/repro_torch/golden/kv_directory.json` holds the JAX reference's full
`counters_dict`, `events` and self-check verdict for the cells the port's
chip smoke run reproduces bitwise on the card.  Two checks:

* tier-1: the golden makespans equal the committed `BENCH_workloads.json`
  rows (seed 4 at n=64, and the n=256 `fuse_ab` cell);
* slow: regenerating the whole file from the JAX package gives the
  committed cells exactly.

Regenerate the file with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "kv_directory.json"

# (scenario, n_agents, seed): the paper's 64-CU GPU for all three
# protocols at two seeds, plus the sweep's n=256 fused A/B cell
CELLS = ([(s, 64, seed) for seed in (0, 4)
          for s in ("srsp", "rsp", "baseline")]
         + [("srsp", 256, 4)])
ENGINE = "fused"


def golden_from_jax() -> dict:
    """Run every golden cell through the JAX reference (fused engine)."""
    from repro import workloads
    from repro.workloads import harness

    mod = workloads.get("kv_directory")
    cells = []
    for scenario, n, seed in CELLS:
        bench = mod.build(scenario, n, seed=seed)
        final = harness.runner(ENGINE)(bench.wl, bench.state, *bench.ops)
        check = bench.check(final)
        cells.append({"scenario": scenario, "n_agents": n, "seed": seed,
                      "engine": ENGINE,
                      "counters": harness.counters_dict(final.store),
                      "events": check["events"],
                      "check_ok": bool(check["ok"]),
                      "check_fails": int(check["check_fails"])})
    return {"cells": cells}


def _provenance() -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    return {"reference": "repro (JAX) kv_directory, harness.run_fused, "
                         "CPU backend, kernel_mode ref",
            "jax_commit": commit, "engine": ENGINE,
            "generator": "tests/test_torch_golden.py --write"}


def _golden() -> dict:
    return json.loads(GOLDEN.read_text())


def _cell(doc, scenario, n, seed):
    return next(c for c in doc["cells"] if (c["scenario"], c["n_agents"],
                                            c["seed"]) == (scenario, n, seed))


def test_golden_makespans_match_committed_bench():
    doc = _golden()
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    rows = {(r["scenario"], r["n_agents"]): r for r in bench["runs"]
            if r["workload"] == "kv_directory" and r["engine"] == "batched"}
    for scenario in ("srsp", "rsp", "baseline"):
        got = _cell(doc, scenario, 64, 4)
        assert got["counters"] == rows[(scenario, 64)]["counters"], scenario
        assert got["events"] == rows[(scenario, 64)]["events"] == 544
        assert got["check_ok"]
    fuse = next(r for r in bench["fuse_ab"]
                if r["n_agents"] == 256 and r["engine"] == "fused")
    assert _cell(doc, "srsp", 256, 4)["counters"]["makespan"] \
        == fuse["makespan"] == 2031.0
    seed0 = [_cell(doc, s, 64, 0)["counters"]["makespan"]
             for s in ("srsp", "rsp", "baseline")]
    assert seed0 == [1328.0, 13790.0, 1405.0]
    assert {(c["scenario"], c["n_agents"], c["seed"])
            for c in doc["cells"]} == set(CELLS)


@pytest.mark.slow
def test_golden_regenerates_from_jax():
    assert golden_from_jax()["cells"] == _golden()["cells"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    doc = {"provenance": _provenance(), **golden_from_jax()}
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {GOLDEN}")
