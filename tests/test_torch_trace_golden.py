"""The port's traced runs against the reference's golden traces
(`src/repro_torch/golden/trace.npz`, `trace.json`, written by
`tests/test_torch_golden.py --write trace`), on the CPU:

* every n=16 cell (the six workloads fused, kv_directory serial, batched
  and batched elastic under leave/join): the decoded columns, `head`,
  `dropped`, `op_hist` and `turn_hist` `==`, the summary, the exported
  trace's meta block and the counters `==` the reference's;
* kv_directory's n=64 cells, seeds 4 and 5, the same way;
* the report demo (worksteal n=4, a crash and its recovery drain on the
  batched elastic engine): the same, its whole Chrome-trace document
  and its text report;
* the files themselves: every cell of `TRACE_CELLS` present, the
  kv_serving n=64 cell wrapping its ring, the n=64 cells' counters the
  solo golden files'.

The other n=64 cells are held on the card (`chip_smoke.py`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import workloads  # noqa: E402
from repro_torch.obs import export, report  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import harness  # noqa: E402
from test_torch_golden import (  # noqa: E402
    TRACE_CAP, TRACE_CELLS, TRACE_COLS, TRACES_PATH, _golden, _trace_golden,
    trace_cell_name)

torch.use_deterministic_algorithms(True)

DOC, ARRAYS = _trace_golden()
CELLS = {c["name"]: c for c in DOC["cells"]}
SMALL = [c for c in TRACE_CELLS if c[1] <= 16]
# the n=64 cells that run in a few seconds on the CPU
KV64 = [c for c in TRACE_CELLS if c[:2] == ("kv_directory", 64)]


def port_bench(cell, device="cpu"):
    """A traced golden cell's bench in the port (kv_serving on the
    reference's request trace), untraced."""
    w, n, seed, engine, churn = cell
    bench = workloads.get(w).build("srsp", n, seed=seed, device=device)
    if w == "kv_serving":
        tr, _ = TR.load_set(str(TRACES_PATH), device)[
            CELLS[trace_cell_name(cell)]["trace"]]
        bench = workloads.get(w).with_trace(bench, tr)
    if engine.endswith("_elastic"):
        bench = harness.make_elastic(bench, [tuple(e) for e in churn])
    return bench


def run_port(cell, cap=TRACE_CAP, device="cpu"):
    """(final state, its store, check) of a golden cell in the port with
    a log of `cap` slots (0: untraced)."""
    bench = port_bench(cell, device)
    final = harness.runner(cell[3])(bench.wl, T.with_trace(bench.state, cap),
                                    *bench.ops)
    store = final.s.store if cell[3].endswith("_elastic") else final.store
    return final, store, bench.check(final)


def held_to_golden(store, name):
    """Raise unless `store`'s trace is the golden cell `name`'s."""
    tl = store.trace
    dec = export.decode(tl)
    for k in TRACE_COLS:
        want = ARRAYS[f"{name}/{k}"]
        got = dec["events"][k]
        assert got.dtype == want.dtype, (name, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {k}")
    assert int(tl.head) == int(ARRAYS[f"{name}/head"]), name
    for k in ("op_hist", "turn_hist"):
        np.testing.assert_array_equal(getattr(tl, k).cpu().numpy(),
                                      ARRAYS[f"{name}/{k}"],
                                      err_msg=f"{name} {k}")


@pytest.mark.parametrize("cell", SMALL, ids=[trace_cell_name(c)
                                             for c in SMALL])
def test_small_golden_cell(cell):
    name = trace_cell_name(cell)
    ref = CELLS[name]
    _, store, check = run_port(cell)
    held_to_golden(store, name)
    assert T.summary(store) == ref["summary"]
    assert export.trace_meta(store, label=name) == ref["meta"]
    assert harness.counters_dict(store) == ref["counters"]
    assert (int(check["events"]), bool(check["ok"]),
            int(check["check_fails"])) == (ref["events"], ref["check_ok"],
                                           ref["check_fails"])
    assert ref["meta"]["dropped"] == 0 and ref["summary"]["latency_turns"]


@pytest.mark.parametrize("cell", KV64, ids=[trace_cell_name(c)
                                            for c in KV64])
def test_kv_directory_n64_golden_cell(cell):
    name = trace_cell_name(cell)
    _, store, _ = run_port(cell)
    held_to_golden(store, name)
    assert T.summary(store) == CELLS[name]["summary"]
    assert harness.counters_dict(store) == CELLS[name]["counters"]


def test_demo_is_the_golden_demo(tmp_path, capsys):
    fin, check, label = report.demo(device="cpu", cap=TRACE_CAP)
    want = DOC["demo"]
    assert label == want["label"]
    held_to_golden(fin.s.store, "demo")
    doc = export.trace_doc(fin.s.store, label=label)
    assert json.loads(json.dumps(doc)) == want["doc"]
    assert export.text_report(doc) == want["report"]
    assert (bool(check["ok"]), float(fin.s.store.counters.recoveries.sum())) \
        == (want["check_ok"], want["recovered"]) == (True, 1.0)
    path = tmp_path / "demo.json"
    assert report.main(["--demo", "--device", "cpu", "--cap",
                        str(TRACE_CAP), "--out", str(path)]) == 0
    out = capsys.readouterr().out
    assert out == (f"{want['report']}\ncheck_ok=True recovered=1\n"
                   f"wrote {path}\n")
    assert json.loads(path.read_text()) == want["doc"]
    assert report.main([str(path)]) == 0
    assert capsys.readouterr().out == want["report"] + "\n"


def test_demo_event_mix():
    kinds = DOC["demo"]["doc"]["srsp"]["kinds"]
    assert kinds == {"acquire": 8, "churn": 1, "load": 9, "recover": 1,
                     "release": 5, "store": 3}
    assert sum(kinds.values()) == int(ARRAYS["demo/head"]) == 27


def test_golden_files_hold_every_cell():
    assert DOC["cap"] == TRACE_CAP
    assert [c["name"] for c in DOC["cells"]] \
        == [trace_cell_name(c) for c in TRACE_CELLS]
    names = [trace_cell_name(c) for c in TRACE_CELLS] + ["demo"]
    assert sorted(ARRAYS) == sorted(f"{nm}/{k}" for nm in names
                                    for k in TRACE_COLS
                                    + ("head", "op_hist", "turn_hist"))
    for nm in names:
        head = int(ARRAYS[f"{nm}/head"])
        assert ARRAYS[f"{nm}/clock"].shape == (min(head, TRACE_CAP),), nm
    wrap = CELLS["kv_serving n=64 seed=4 fused"]["summary"]
    assert (wrap["trace_events"], wrap["trace_dropped"]) == (6099, 2003)
    assert all(c["summary"]["trace_dropped"] == 0 for c in DOC["cells"]
               if c["name"] != "kv_serving n=64 seed=4 fused")


def test_golden_n64_cells_are_the_solo_golden_cells():
    """Tracing changes no counter: each n=64 traced cell has the solo
    golden file's counters and verdict (seed 5 from many.json)."""
    many = next(c for c in _golden("many")["cells"] if (
        c["workload"], c["scenario"], c["engine"])
        == ("kv_directory", "srsp", "fused"))
    for c in DOC["cells"]:
        if c["n_agents"] != 64:
            continue
        if c["seed"] == 5:
            want = next(lane for lane in many["lanes"] if lane["seed"] == 5)
        else:
            want = next(g for g in _golden(c["workload"])["cells"] if (
                g["scenario"], g["n_agents"], g["seed"], g["engine"],
                g.get("traffic", "default"))
                == ("srsp", 64, c["seed"], "fused", "default"))
        assert (c["counters"], c["events"], c["check_ok"],
                c["check_fails"]) == (want["counters"], want["events"],
                                      want["check_ok"],
                                      want["check_fails"]), c["name"]
