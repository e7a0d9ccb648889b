"""The committed kv_serving sweep rows, reproduced by the port.

`BENCH_workloads.smoke.json` and `BENCH_workloads.json` were written by
a JAX whose threefry used the legacy (non-partitionable) layout: under
the installed default the same cells draw other traces.  So the JAX
package generates each cell's trace under
`jax.threefry_partitionable(False)` and the port replays it
(`kv_serving.with_trace`); the port itself has no legacy layout.  The
rows' counters (makespans 3619.99951171875 / 11598.0 / 3866.99951171875
for srsp / rsp / baseline at n=16 seed 1 in the smoke sweep, and
3225.72900390625 for the full sweep's srsp lane 0, n=16 seed 4), events
and verdicts must come out exactly.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.traffic import trace as JT  # noqa: E402
from repro.workloads import kv_serving as jkv  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import harness, kv_serving  # noqa: E402

torch.use_deterministic_algorithms(True)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 16


def _row(doc: str, scenario: str) -> dict:
    bench = json.loads((ROOT / doc).read_text())
    return next(r for r in bench["runs"] if (
        r["workload"], r["scenario"], r["n_agents"], r["engine"])
        == ("kv_serving", scenario, N, "batched"))


def _legacy_trace(seed: int) -> TR.RequestTrace:
    cfg = jkv.Config(n_agents=N)
    with jax.threefry_partitionable(False):
        jt = JT.generate(cfg.traffic, N, cfg.n_pages, seed)
    return TR.RequestTrace(*(torch.from_numpy(np.array(c)) for c in jt))


@pytest.mark.parametrize("doc,scenario,seed,makespan", [
    ("BENCH_workloads.smoke.json", "srsp", 1, 3619.99951171875),
    ("BENCH_workloads.smoke.json", "rsp", 1, 11598.0),
    ("BENCH_workloads.smoke.json", "baseline", 1, 3866.99951171875),
    ("BENCH_workloads.json", "srsp", 4, 3225.72900390625)])
def test_legacy_traces_reproduce_committed_rows(doc, scenario, seed,
                                                makespan):
    row = _row(doc, scenario)
    b = kv_serving.with_trace(
        kv_serving.build(scenario, N, seed=seed, device="cpu"),
        _legacy_trace(seed))
    final = harness.run_batched(b.wl, b.state)
    check = b.check(final)
    counters = harness.counters_dict(final.store)
    assert counters["makespan"] == row["makespan"] == makespan
    # the smoke rows are one replica; the full sweep's counters are lane 0
    assert counters == row["counters"]
    assert check["events"] == row["events"] and check["ok"]
