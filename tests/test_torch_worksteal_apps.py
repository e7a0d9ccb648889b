"""worksteal's app drivers: the port's `run_app` against the JAX
package's at the example's small size (`examples/worksteal_graphs.py
--wgs 4 --nodes 384 --iters 2`).

PageRank on collab_like, SSSP on road_like and MIS on router_like, under
srsp and rsp: counters, `proc_errors` (0) and iterations equal; the SSSP
and MIS solutions bit for bit (MIS draws its priorities from the port's
threefry); PageRank within rtol 1e-5 (tests/test_worksteal.py's
tolerance: its scatter-add may sum in another order).  The single-thread
oracles `reference_solution` agree the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import graphs as JG  # noqa: E402
from repro.workloads import worksteal as JWS  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.workloads import worksteal as WS  # noqa: E402

torch.use_deterministic_algorithms(True)

APPS = [("pagerank", "collab_like"), ("sssp", "road_like"),
        ("mis", "router_like")]
NODES, WGS, ITERS = 384, 4, 2


def _ws(mod, g):
    return mod.WSConfig(n_wgs=WGS, chunk_cap=32,
                        n_chunks_max=min((g.n + 31) // 32, 256))


def _same_solution(app, got, want):
    if app == "pagerank":
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scenario", ["srsp", "rsp"])
@pytest.mark.parametrize("app,graph", APPS)
def test_run_app_matches_jax(app, graph, scenario):
    jg, g = getattr(JG, graph)(NODES), getattr(G, graph)(NODES)
    want = JWS.run_app(app, jg, scenario, _ws(JWS, jg), max_iters=ITERS)
    got = WS.run_app(app, g, scenario, _ws(WS, g), max_iters=ITERS,
                     device="cpu")
    assert got.counters == want.counters
    assert (got.proc_errors, got.iterations, got.makespan) \
        == (want.proc_errors, want.iterations, want.makespan) \
        == (0, want.iterations, want.counters["makespan"])
    _same_solution(app, got.solution, want.solution)
    _same_solution(app, got.solution,
                   WS.reference_solution(app, g, max_iters=ITERS))


@pytest.mark.parametrize("app,graph", APPS)
def test_reference_solution_matches_jax(app, graph):
    g = getattr(G, graph)(NODES)
    got = WS.reference_solution(app, g, max_iters=ITERS)
    want = JWS.reference_solution(app, getattr(JG, graph)(NODES),
                                  max_iters=ITERS)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_run_app_rejects_unknown_names():
    g = G.collab_like(64)
    ws = WS.WSConfig(n_wgs=2, chunk_cap=32, n_chunks_max=2)
    with pytest.raises(ValueError, match="unknown app"):
        WS.run_app("bfs", g, "srsp", ws, device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        WS.WorkStealSim(ws, "nope", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        WS.WorkStealSim(ws, "srsp", "nope", device="cpu")


def test_entry_points_need_a_device_or_cpu():
    """Without a GPU the slice's entry points raise unless the CPU is
    named: `run_cell` of both workloads, `run_app` and the trace
    generator."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from repro_torch.traffic import samplers, trace
    from repro_torch.workloads import sweep
    for workload in ("worksteal", "kv_serving"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep.run_cell(workload, "srsp", 8, 0, "fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WS.run_app("sssp", G.road_like(64), "srsp",
                   WS.WSConfig(n_wgs=2, chunk_cap=32, n_chunks_max=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace.generate(samplers.TrafficConfig(), 4, 8, 0)
