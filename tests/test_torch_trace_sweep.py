"""The sweep's latency and trace columns (`repro.workloads.sweep`'s
`_latency_cols` and `_request_latency`) in the port's rows, on the CPU:
`run_cell`, `run_vmapped_cell` (lane 0's store) and `measure_churned`
traced give the golden summary of the same cell, kv_serving rows report
the per-request latencies (`latency_source == "requests"`) traced or
not, and untraced rows give None/0; the command exports a traced row
(`--trace-out`) and writes `stragglers` with its rows (`--out`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
from repro_torch.obs import export, metrics  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import sweep  # noqa: E402
from test_torch_golden import TRACE_CAP, TRACES_PATH  # noqa: E402
from test_torch_trace_golden import CELLS, DOC  # noqa: E402

torch.use_deterministic_algorithms(True)

UNTRACED = {"latency_p50": None, "latency_p95": None, "latency_p99": None,
            "latency_turns": 0, "trace_events": 0, "trace_dropped": 0,
            "latency_source": None}


@pytest.fixture(params=[False, True], ids=["untraced", "traced"])
def traced(request, monkeypatch):
    """REPRO_TRACE as the sweep sees it: make_store allocates the
    golden's capacity, or nothing."""
    monkeypatch.setattr(T, "TRACE", request.param)
    monkeypatch.setattr(T, "DEFAULT_CAP", TRACE_CAP)
    return request.param


def _cols(row):
    return {k: row[k] for k in sweep.LATENCY_KEYS}


def _turns(summary):
    return dict(summary, latency_source="turns")


@pytest.mark.parametrize("engine", ["fused", "serial"])
def test_run_cell_columns(traced, engine):
    row = sweep.run_cell("kv_directory", "srsp", 16, 4, engine,
                         device="cpu", warmup=False)
    want = CELLS[f"kv_directory n=16 seed=4 {engine}"]
    assert _cols(row) == (_turns(want["summary"]) if traced else UNTRACED)
    assert row["counters"] == want["counters"]


def test_kv_serving_rows_report_request_latency(traced):
    want = CELLS["kv_serving n=16 seed=4 fused"]
    tr, meta = TR.load_set(str(TRACES_PATH), "cpu")[want["trace"]]
    row = sweep.run_cell("kv_serving", "srsp", 16, 4, "fused", device="cpu",
                         build_kw={"traffic": meta["config"]}, trace=tr,
                         warmup=False)
    assert row["counters"] == want["counters"]
    assert row["latency_source"] == "requests"
    assert (row["trace_events"], row["trace_dropped"]) == (
        (want["summary"]["trace_events"], 0) if traced else (0, 0))
    lat = row["latency_p50"], row["latency_p95"], row["latency_p99"]
    assert all(isinstance(x, float) for x in lat) and lat[0] <= lat[2]
    assert row["latency_turns"] == row["events"]
    if traced:   # requests, not turns
        assert row["latency_turns"] != want["summary"]["latency_turns"]


def test_kv_serving_replica_rows_pool_request_latency():
    """Two replicas, the first on the reference's trace of its seed, the
    second on the port's own draw: both lanes' request histograms,
    pooled."""
    tr, meta = TR.load_set(str(TRACES_PATH), "cpu")["n16_seed4_default"]
    row = sweep.run_vmapped_cell(
        "kv_serving", "srsp", 16, [4, 5], "fused", device="cpu",
        build_kw={"traffic": meta["config"]}, traces=[tr, None],
        warmup=False, keep_stores=True)
    assert row["latency_source"] == "requests"
    assert row["latency_turns"] == sum(lane["events"]
                                       for lane in row["lanes"])
    assert len(row["_stores"]) == 2 and row["trace_events"] == 0


def test_vmapped_cell_columns_are_lane_0s(traced):
    row = sweep.run_vmapped_cell("kv_directory", "srsp", 16, [4, 5],
                                 "fused", device="cpu", warmup=False,
                                 keep_stores=True)
    want = CELLS["kv_directory n=16 seed=4 fused"]["summary"]
    assert _cols(row) == (_turns(want) if traced else UNTRACED)
    assert T.summary(row["_stores"][0]) == (want if traced else {
        k: v for k, v in UNTRACED.items() if k != "latency_source"})


def test_churned_row_columns_are_the_demos(traced):
    """The sweep's churned worksteal row is the report demo's cell."""
    row = sweep.measure_churned("worksteal", 1, device="cpu", warmup=False)
    want = DOC["demo"]["doc"]["srsp"]["turn_latency"]
    assert _cols(row) == (_turns(want) if traced else UNTRACED)
    assert row["recovered"] == 1.0 and row["check_ok"]


def test_request_latency_pools_histograms():
    h1 = np.zeros(metrics.N_BUCKETS, np.int64)
    h2 = np.zeros(metrics.N_BUCKETS, np.int64)
    h1[3], h2[10] = 5, 1
    row = {"trace_events": 7}
    sweep._request_latency(row, [{"latency_hist": h1.tolist()},
                                 {"latency_hist": h2.tolist()}])
    s = metrics.summarize(h1 + h2)
    assert row == {"trace_events": 7, "latency_p50": s["p50"],
                   "latency_p95": s["p95"], "latency_p99": s["p99"],
                   "latency_turns": 6, "latency_source": "requests"}
    for events, source in ((7, "turns"), (0, None)):
        row = {"trace_events": events}
        sweep._request_latency(row, [{"ok": True}])
        assert row["latency_source"] == source


def test_command_exports_a_traced_row(tmp_path, monkeypatch, capsys):
    """`--cell` at a small width on the CPU, traced: `--out` holds the
    rows and `stragglers`, `--trace-out` the Perfetto document of the
    first row's lane 0, with its label."""
    monkeypatch.setattr(T, "TRACE", True)
    monkeypatch.setattr(T, "DEFAULT_CAP", TRACE_CAP)
    monkeypatch.setattr(sweep, "SERVING_SCALE_N", 16)
    monkeypatch.setattr(common, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    out, trace_out = tmp_path / "rows.json", tmp_path / "trace.json"
    assert sweep.main(["--cell", "kv_directory", "--replicas", "2",
                       "--out", str(out), "--trace-out",
                       str(trace_out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["stragglers"] == [] and len(doc["rows"]) == 1
    row = doc["rows"][0]
    want = CELLS["kv_directory n=16 seed=4 fused"]
    assert _cols(row) == _turns(want["summary"])
    assert "_stores" not in row and row["wall_s"] > 0
    trace = json.loads(trace_out.read_text())
    assert trace["srsp"]["label"] == "kv_directory/srsp/n=16/R=2/fused"
    assert {k: v for k, v in trace["srsp"].items() if k != "label"} \
        == {k: v for k, v in want["meta"].items() if k != "label"}
    assert "sRSP trace report: kv_directory/srsp/n=16/R=2/fused" \
        in export.text_report(trace)
    assert f"wrote {trace_out}" in capsys.readouterr().out
