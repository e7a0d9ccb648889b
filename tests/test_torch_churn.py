"""The port's elastic engines, crash faults and recovery drain, without
JAX (the live JAX comparisons are in test_torch_churn_b.py to _e.py).

* zero churn: `serial_elastic` and `batched_elastic` with an empty
  schedule are bitwise the port's `serial` and `batched`, for all six
  workloads at n=8;
* the registries: five engines, the three crash faults, `recover_b` on
  every registered protocol;
* `golden/churn.json` (written by the JAX reference,
  tests/test_torch_golden.py): its cells at n <= 16 reproduce on the CPU
  with `==`, and the file holds what the reference is known to give
  (the sweep's churned rows, the zero-churn cell equal to the
  kv_directory golden cell, red and green where they should be);
* the kv_serving n=4 seed 3 pair on the JAX trace, pinned to what the
  reference outputs;
* `sweep.measure_churned` gives the committed sweep's two churn rows.

Every comparison is `==`, under `torch.use_deterministic_algorithms`.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, workloads  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.traffic import trace as TT  # noqa: E402
from repro_torch.workloads import faults, harness, sweep  # noqa: E402
from test_torch_golden import CHURN_CELLS  # noqa: E402

torch.use_deterministic_algorithms(True)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "golden"
NAMES = ["kv_directory", "reader_lock", "producer_consumer",
         "producer_consumer_mc", "worksteal", "kv_serving"]
RESULT_KEYS = ("counters", "events", "check_ok", "check_fails", "done",
               "completed", "offered")


def _doc() -> dict:
    return json.loads((GOLDEN / "churn.json").read_text())


def _traces() -> dict:
    return TT.load_set(str(GOLDEN / "kv_serving_traces.npz"), "cpu")


def cell_proto(cell) -> P.Protocol:
    """The cell's protocol: srsp, its crash fault, and without the
    recovery drain for a red cell."""
    proto = P.get_protocol(cell["scenario"])
    if cell["fault"]:
        name, victim, at = cell["fault"]
        proto = getattr(faults, name)(proto, victim, at)
    return proto if cell["recovery"] else faults.lease_never_expires(proto)


def run_churn_cell(cell, device="cpu") -> dict:
    """The golden cell through `sweep.run_cell` on `device`."""
    kw = dict(cell["build_kw"])
    tr = None
    if "trace" in cell:
        tr, meta = TT.load_set(str(GOLDEN / "kv_serving_traces.npz"),
                               device)[cell["trace"]]
        kw["traffic"] = meta["config"]
    return sweep.run_cell(cell["workload"], cell["scenario"],
                          cell["n_agents"], cell["seed"], cell["engine"],
                          device=device, build_kw=kw, trace=tr,
                          events=[tuple(e) for e in cell["churn"]],
                          lease=cell["lease"], proto=cell_proto(cell))


def assert_held(row, cell):
    for key in RESULT_KEYS:
        assert row[key] == cell[key], (cell["name"], key, row[key],
                                       cell[key])
    assert row["recovered"] == cell["recoveries"], cell["name"]
    assert row["alive"] == cell["alive"], cell["name"]


@pytest.mark.parametrize("plain", ["serial", "batched"])
@pytest.mark.parametrize("name", NAMES)
def test_zero_churn_elastic_is_the_plain_engine(name, plain):
    mod = workloads.get(name)
    b = mod.build("srsp", 8, seed=3, device="cpu")
    want = harness.runner(plain)(b.wl, b.state, *b.ops)
    eb = harness.make_elastic(mod.build("srsp", 8, seed=3, device="cpu"))
    got = harness.runner(plain + "_elastic")(eb.wl, eb.state, *eb.ops)
    for x, y in zip(convert.leaves(got.s), convert.leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y), (name, plain)
    assert bool(got.alive.all()) and bool(got.fired.all())
    assert bool((got.recover_at == harness.BIG).all())
    assert eb.check(got)["ok"]


def test_registries_name_the_elastic_engines_and_crash_faults():
    assert harness.engines() == ("batched", "batched_elastic", "fused",
                                 "serial", "serial_elastic")
    for name in P.protocols():
        assert P.get_protocol(name).recover_b is P.b_recover, name
    srsp = P.get_protocol("srsp")
    assert faults.crash_holding_lock(srsp, 1, 7.0).crash_gate == (1, 7.0)
    assert faults.crash_dirty(srsp, 1, 7.0).release_loc_b \
        is not srsp.release_loc_b
    red = faults.lease_never_expires(srsp)
    assert red.recover_b is None and red.name == "srsp+lease_never_expires"
    sched = harness.make_churn([(5.0, 1, "crash"), (9.5, 1, harness.JOIN)],
                               2.0, "cpu")
    assert sched.clock.tolist() == [5.0, 9.5]
    assert sched.kind.tolist() == [harness.CRASH, harness.JOIN]
    assert (sched.clock.dtype, sched.agent.dtype, sched.lease.shape) \
        == (torch.float32, torch.int32, ())
    empty = harness.make_churn(device="cpu")
    assert empty.clock.tolist() == [float(torch.tensor(
        harness.BIG, dtype=torch.float32))]


SMALL = [c for c in _doc()["cells"] if c["n_agents"] <= 16]


@pytest.mark.parametrize("k", range(len(SMALL)),
                         ids=[c["name"] for c in SMALL])
def test_small_churn_golden_cells_on_cpu(k):
    assert_held(run_churn_cell(SMALL[k]), SMALL[k])


def _find(doc, **kw):
    return [c for c in doc["cells"]
            if all(c.get(k) == v for k, v in kw.items())]


def test_churn_golden_holds_what_the_reference_gives():
    doc = _doc()
    assert [c["name"] for c in doc["cells"]] == [
        c["name"] for c in CHURN_CELLS]
    bench = json.loads((ROOT / "BENCH_workloads.json").read_text())
    for i, (workload, layout) in ((60, ("worksteal", "partitionable")),
                                  (61, ("kv_serving", "legacy"))):
        row = bench["runs"][i]
        cell, = _find(doc, workload=workload, n_agents=4, recovery=True,
                      layout=layout)
        assert (cell["counters"]["makespan"], cell["recoveries"],
                cell["check_fails"], cell["check_ok"], cell["events"]) \
            == (row["makespan"], row["recovered"], row["lost_updates"],
                row["check_ok"], row["events"])
        assert cell["completed"] == row["completed"]
    assert _find(doc, workload="worksteal", n_agents=4, recovery=True)[0][
        "counters"]["makespan"] == 1179.5
    kvs = _find(doc, workload="kv_serving", n_agents=4, recovery=True)
    assert [c["counters"]["makespan"] for c in kvs] \
        == [2214.790283203125, 2307.369873046875]
    zero, = _find(doc, name="kv_directory n=64 seed=4 batched_elastic "
                            "zero_churn")
    kv = json.loads((GOLDEN / "kv_directory.json").read_text())
    fused, = [c for c in kv["cells"] if (c["scenario"], c["n_agents"],
                                         c["seed"], c["engine"])
              == ("srsp", 64, 4, "fused")]
    assert zero["counters"] == fused["counters"]
    assert zero["counters"]["makespan"] == 1263.0
    assert zero["alive"] == [True] * 64 and zero["recoveries"] == 0.0
    for c in doc["cells"]:
        if c["fault"]:
            victim = c["fault"][1]
            assert not c["alive"][victim], c["name"]
            assert c["recoveries"] == (1.0 if c["recovery"] else 0.0), \
                c["name"]
            # worksteal's n=64 run has no red control: it checks green
            red_ok = (c["workload"], c["n_agents"]) == ("worksteal", 64)
            assert c["check_ok"] == (c["recovery"] or red_ok), c["name"]
        else:
            assert c["check_ok"] and all(c["alive"]), c["name"]
    red, = _find(doc, workload="kv_serving", n_agents=64, recovery=False)
    assert red["done"] is False
    lj = _find(doc, workload="kv_directory", churn=[[50.0, 2, "leave"],
                                                    [150.0, 2, "join"]])
    assert [c["counters"]["makespan"] for c in lj] \
        == [1283.0, 1067.0, 1067.0]
    assert lj[1]["counters"] == lj[2]["counters"]


@pytest.mark.parametrize("layout,green", [("partitionable", True),
                                          ("partitionable", False),
                                          ("legacy", True)])
def test_kv_serving_crash_pair_pinned_to_the_reference(layout, green):
    """srsp, crash_holding_lock (victim 0 at 30), CRASH at 180,
    pages_per_agent=1, n=4 seed 3 on the JAX trace.  Without recovery
    the reference gives done=True, ok=False, 10 check failures, 73 of 96
    completed and no recovery (tests/test_kv_serving.py expects not
    done); the port gives the same."""
    cell, = _find(_doc(), workload="kv_serving", n_agents=4,
                  recovery=green, layout=layout)
    row = run_churn_cell(cell)
    assert_held(row, cell)
    got = (row["done"], row["check_ok"], row["check_fails"],
           row["completed"], row["offered"], row["recovered"])
    if green:
        assert got == (True, True, 0, 73, 96, 1.0)
    else:
        assert got == (True, False, 10, 73, 96, 0.0)


def test_run_churned_cell_gives_the_sweep_rows():
    """`sweep.measure_churned` gives the committed sweep's two churned
    rows (kv_serving on the legacy-layout trace the committed row drew)."""
    ws = sweep.measure_churned("worksteal", 1, "cpu")
    assert (ws["makespan"], ws["recovered"], ws["lost_updates"],
            ws["completed"], ws["check_ok"]) == (1179.5, 1.0, 0, None, True)
    traces = sweep.trace_map([_traces()["n4_seed3_ppa1_legacy"]])
    kv = sweep.measure_churned("kv_serving", 1, "cpu", traces)
    assert (kv["makespan"], kv["recovered"], kv["lost_updates"],
            kv["completed"], kv["check_ok"]) \
        == (2307.369873046875, 1.0, 0, 73, True)
    assert ws["steady_s_per_run"] > 0 and kv["steady_s_per_run"] > 0


def test_crash_recovery_serial_is_batched():
    """The worksteal n=4 pin, green, on both elastic engines: crash
    recovery is engine-equivalent in the port (every leaf)."""
    proto = faults.crash_holding_lock(P.get_protocol("srsp"), 0, 5.0)
    finals = []
    for engine in ("serial_elastic", "batched_elastic"):
        b = workloads.get("worksteal").build("srsp", 4, seed=3, proto=proto,
                                             device="cpu", n_chunks_max=12)
        eb = harness.make_elastic(b, [(400.0, 0, "crash")])
        finals.append(harness.runner(engine)(eb.wl, eb.state, *eb.ops))
        assert eb.check(finals[-1])["ok"]
    for x, y in zip(*(convert.leaves(f) for f in finals)):
        assert torch.equal(x, y)
    assert float(finals[0].s.store.counters.recoveries) == 1.0
