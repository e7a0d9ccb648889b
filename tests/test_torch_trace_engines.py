"""Tracing is an observer (DESIGN.md §11): a traced run leaves every
non-trace leaf bitwise the untraced run's, on all five engines and the
two replica engines, in both metadata layouts (kv_directory, n=16, port
against port).  The replica engines (R=2, seeds 4 and 5) give each lane
its solo run's trace, lane 0 the golden one, and no replica's trace
moves while another replica's turn form runs.  PyTorch's vmap fallback
warning is an error here.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, workloads  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.workloads import harness  # noqa: E402
from test_torch_trace_golden import held_to_golden  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED, SEEDS, CAP = 16, 4, (4, 5), 4096
LEAVE_JOIN = [(50.0, 2, "leave"), (150.0, 2, "join")]
ENGINES = ("serial", "batched", "fused", "serial_elastic",
           "batched_elastic")


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


@pytest.fixture(params=[True, False], ids=["packed", "bool"])
def layout(request, monkeypatch):
    monkeypatch.setattr(P, "PACKED", request.param)
    return request.param


def same_tree(a, b, ctx):
    x, y = convert.leaves(a), convert.leaves(b)
    assert len(x) == len(y), ctx
    for k, (u, v) in enumerate(zip(x, y)):
        assert u.dtype == v.dtype and torch.equal(u, v), (ctx, k)


def _bench(engine, seed=SEED):
    b = workloads.get("kv_directory").build("srsp", N, seed=seed,
                                            device="cpu")
    return harness.make_elastic(b, LEAVE_JOIN) if engine.endswith(
        "_elastic") else b


def _run(engine, cap):
    b = _bench(engine)
    return harness.runner(engine)(b.wl, T.with_trace(b.state, cap), *b.ops)


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_leaves_every_other_leaf_alone(engine, layout):
    off = _run(engine, 0)
    on = _run(engine, CAP)
    store = on.s.store if engine.endswith("_elastic") else on.store
    assert (store.wvalid.dtype == torch.bool) == (not layout)
    assert int(store.trace.head) > 0 and store.trace.turn_hist.sum() > 0
    same_tree(T.strip(on), off, engine)
    if engine.endswith("_elastic"):
        kinds = store.trace.kind[:int(store.trace.head)]
        assert int((kinds == T.CHURN).sum()) == 2     # the leave, the join


@pytest.mark.parametrize("engine", ["fused", "batched"])
def test_replica_lanes_are_solo_traced_runs(engine, layout):
    b = _bench(engine)
    mod = workloads.get("kv_directory")

    def states(cap):
        return harness.stack([T.with_trace(mod.init_state(b.wl, s, "cpu"),
                                           cap) for s in SEEDS])

    run = harness.runner_many(engine)
    on = run(b.wl, states(CAP), *b.ops)
    off = run(b.wl, states(0), *b.ops)
    same_tree(T.strip(on), off, engine)
    for k, seed in enumerate(SEEDS):
        sb = _bench(engine, seed)
        solo = harness.runner(engine)(sb.wl, T.with_trace(sb.state, CAP),
                                      *sb.ops)
        same_tree(harness.lane(on, k), solo, (engine, seed))
    held_to_golden(harness.lane(on, 0).store,
                   f"kv_directory n={N} seed={SEED} {engine}")


def test_a_finished_replica_keeps_its_trace():
    """Lanes of different lengths (producer_consumer_mc): the shorter
    lane's trace and turn histogram stop moving when it finishes, as its
    solo run's do."""
    mod = workloads.get("producer_consumer_mc")
    b = mod.build("srsp", N, seed=SEEDS[0], device="cpu")
    st = harness.stack([T.with_trace(mod.init_state(b.wl, s, "cpu"), CAP)
                        for s in SEEDS])
    fin = harness.run_fused_many(b.wl, st, *b.ops)
    trips = []
    for k, seed in enumerate(SEEDS):
        sb = mod.build("srsp", N, seed=seed, device="cpu")
        solo = harness.run_fused(sb.wl, T.with_trace(sb.state, CAP), *sb.ops)
        same_tree(harness.lane(fin, k), solo, seed)
        trips.append(int(solo.store.trace.turn_hist.sum()))
    assert trips[0] != trips[1]


def test_untraced_replica_run_launches_no_trace_work(monkeypatch):
    """With tracing off the replica loop never calls `record_turn`."""
    calls = []
    monkeypatch.setattr(T, "record_turn",
                        lambda st, c0: calls.append(1) or st)
    b = _bench("fused")
    mod = workloads.get("kv_directory")
    harness.run_fused_many(b.wl, harness.init_many(mod.init_state, b.wl,
                                                   SEEDS, "cpu"), *b.ops)
    assert not calls
