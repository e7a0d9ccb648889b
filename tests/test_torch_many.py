"""The replica axis (`harness.run_batched_many` / `run_fused_many`)
against the JAX package at n=8 over two seeds: kv_directory here, the
other vmappable workloads in test_torch_many_b.py to _e.py, which share
this file's helpers; the replica kernels' plain versions in
test_torch_many_kernels.py.

Each cell runs the reference's `run_*_many` on `jax.vmap(init_state)`
of the seeds, which it donates (so every JAX call gets fresh states and
the initial state is copied out first), and the port's twin on
`harness.init_many` of the same seeds, held leaf by leaf, bit for bit,
`rounds` included; the starting states are held equal too.  Each lane
is also held to the port's solo run of its seed, `rounds` included, and
its check to the reference lane's.  PyTorch's vmap fallback warning ("a
performance drop because we have not yet implemented the batching rule")
is an error here: the replica path runs on batching rules only.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import workloads as jworkloads  # noqa: E402
from repro.workloads import faults as jfaults  # noqa: E402
from repro.workloads import harness as jharness  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.workloads import faults, harness, sweep  # noqa: E402
from test_torch_workloads import _same_tree  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEEDS = 8, (3, 4)


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """PyTorch's per-example fallback for an op without a batching rule
    warns; here it fails the test."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def same_port(a, b, ctx):
    """Two port trees, leaf by leaf, bit for bit."""
    x, y = convert.leaves(a), convert.leaves(b)
    assert len(x) == len(y), ctx
    for k, (u, v) in enumerate(zip(x, y)):
        assert u.dtype == v.dtype and torch.equal(u, v), (ctx, k)


def _protos(scenario, fault):
    """(JAX protocol, port protocol) of a scenario, with `fault` (a name
    of `faults`) applied, or (None, None)."""
    if fault is None:
        return None, None
    return (getattr(jfaults, fault)(jharness.resolve_proto(scenario)),
            getattr(faults, fault)(harness.resolve_proto(scenario)))


def jax_many(name, scenario, engine, fault=None, seeds=SEEDS):
    """(initial states as numpy, final states, bench) of the reference's
    replica run; the initial states are copied before the call donates
    them."""
    mod = jworkloads.get(name)
    b = mod.build(scenario, N, seed=seeds[0],
                  proto=_protos(scenario, fault)[0])
    states = jax.vmap(lambda s: mod.init_state(b.wl, s))(
        jnp.asarray(seeds, jnp.int32))
    init = jax.tree.map(np.array, states)
    final = jharness.runner_many(engine)(b.wl, states)
    return init, final, b


def port_bench(name, scenario, fault=None, seed=SEEDS[0]):
    return workloads.get(name).build(scenario, N, seed=seed,
                                     proto=_protos(scenario, fault)[1],
                                     device="cpu")


def check_cell(name, scenario, engine, fault=None, states=None):
    """The port's replica run against the reference's, leaf by leaf; each
    lane against the port's solo run from that lane's initial state and
    the reference lane's check.  `states(bench, jax_init)` gives the
    port's initial states (default: `init_many` of the seeds, held equal
    to the reference's)."""
    init, jfinal, jb = jax_many(name, scenario, engine, fault)
    b = port_bench(name, scenario, fault)
    if states is None:
        st = harness.init_many(workloads.get(name).init_state, b.wl, SEEDS,
                               "cpu")
        _same_tree(st, init, (name, "init"))
    else:
        st = states(b, init)
    lanes = [harness.lane(st, k) for k in range(len(SEEDS))]
    final = harness.runner_many(engine)(b.wl, st, *b.ops)
    ctx = (name, scenario, engine, fault)
    _same_tree(final, jfinal, ctx)
    for k, lane0 in enumerate(lanes):
        solo = harness.runner(engine)(b.wl, lane0, *b.ops)
        lane = harness.lane(final, k)
        same_port(lane, solo, ctx + (k,))
        assert b.check(lane) == jb.check(
            jax.tree.map(lambda x: x[k], jfinal)), ctx + (k,)
    jax.clear_caches()
    return final


@pytest.mark.parametrize("scenario,engine", [
    ("srsp", "fused"), ("srsp", "batched"), ("rsp", "batched")])
def test_kv_directory_many_matches_jax(scenario, engine):
    final = check_cell("kv_directory", scenario, engine)
    assert [int(r) for r in final.rounds] == [68, 68]


def test_registries_name_the_replica_engines():
    assert sorted(harness.ENGINES_MANY) == ["batched", "fused"]
    assert harness.runner_many("fused") is harness.run_fused_many
    with pytest.raises(KeyError, match="registered"):
        harness.runner_many("serial")
    for name in workloads.available():
        assert workloads.get(name).VMAPPABLE \
            == jworkloads.get(name).VMAPPABLE, name


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_a_finished_replica_stays_frozen(engine):
    """Replica 1 owes one update an agent and finishes many trips before
    replica 0: it ends as its solo run does, and a replica that starts
    finished keeps its state bit for bit while the other runs."""
    b = port_bench("kv_directory", "srsp")
    mod = workloads.get("kv_directory")
    st = harness.init_many(mod.init_state, b.wl, SEEDS, "cpu")
    st = st._replace(upd_quota=torch.stack([st.upd_quota[0],
                                            torch.ones_like(st.upd_quota[1])]))
    final = harness.runner_many(engine)(b.wl, st)
    solos = [harness.runner(engine)(b.wl, harness.lane(st, k))
             for k in range(2)]
    for k in range(2):
        same_port(harness.lane(final, k), solos[k], (engine, k))
    assert int(solos[1].rounds) < int(solos[0].rounds) - 20
    done = harness.stack([harness.lane(st, 0), solos[1]])
    final = harness.runner_many(engine)(b.wl, done)
    same_port(harness.lane(final, 1), solos[1], (engine, "frozen"))
    same_port(harness.lane(final, 0), solos[0], (engine, "runs"))


def test_stacked_jax_state_carries_across():
    """`convert.from_numpy` of a stacked JAX state is the port's stacked
    state, and back."""
    mod = jworkloads.get("kv_directory")
    b = mod.build("srsp", N, seed=0)
    states = jax.vmap(lambda s: mod.init_state(b.wl, s))(
        jnp.asarray(SEEDS, jnp.int32))
    port = convert.from_numpy(jax.tree.map(np.asarray, states), "cpu")
    _same_tree(port, states, "stacked")
    assert port.store.l1.shape[0] == len(SEEDS)
    back = convert.to_numpy(port)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(states)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_replica_run_makes_one_host_read_a_trip(monkeypatch):
    """The loop reads the device once a trip (one `.tolist()`), and the
    fused engine makes one replica-axis trip_plan call a trip."""
    from repro_torch.kernels.fused_turn import ops as FT
    plans, reads = [], []
    many = FT.trip_plan_many

    def counted(*a, **k):
        plans.append(a[0].shape)
        return many(*a, **k)

    monkeypatch.setattr(FT, "trip_plan_many", counted)
    real = torch.Tensor.tolist

    def tolist(t):
        reads.append(tuple(t.shape))
        return real(t)

    b = port_bench("kv_directory", "srsp")
    st = harness.init_many(workloads.get("kv_directory").init_state, b.wl,
                           SEEDS, "cpu")
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    harness.run_fused_many(b.wl, st)
    monkeypatch.setattr(torch.Tensor, "tolist", real)
    assert plans and all(s == (len(SEEDS), N) for s in plans)
    # one read a pass; the last pass finds no replica live
    assert reads == [(6,)] * len(plans)


@pytest.mark.parametrize("bound", [1, 2, 4])
def test_lane_scan_flags_lanes_past_its_bound(bound):
    """On the replica path a bounded `lane_scan` takes each replica's
    first `bound` active lanes in ascending order and flags the replicas
    whose mask held more."""
    from repro_torch.core import protocol as P
    active = torch.tensor([[True, False, True, False],
                           [False, True, False, False]])

    def scan(a, k):
        with P.lane_bound(k) as over:
            c = P.lane_scan(a, lambda c, j: c * 10 + j + 1,
                            torch.zeros((), dtype=torch.int64))
        return c, torch.stack(over).any()

    got, over = torch.func.vmap(scan, in_dims=(0, None))(active, bound)
    assert got.tolist() == ([1, 2] if bound == 1 else [13, 2])
    assert over.tolist() == [bound == 1, False]


def test_replica_loop_raises_when_a_remote_turn_outgrows_its_bound():
    """A remote turn whose ops act for more agents than its form's mask
    (here the serial turn acting for every agent) makes the replica
    loop raise instead of dropping lanes."""
    import dataclasses
    b = port_bench("producer_consumer_mc", "srsp")
    wl = b.wl
    every = torch.ones(N, dtype=torch.bool)
    wide = dataclasses.replace(
        wl, remote_addr=None,
        remote_turn=lambda w, s, wg, *o: wl.remote_turn_b(w, s, every, *o))
    mod = workloads.get("producer_consumer_mc")
    with pytest.raises(RuntimeError, match="lane_bound"):
        harness.run_batched_many(
            wide, harness.init_many(mod.init_state, wl, SEEDS, "cpu"),
            *b.ops)


def test_sweep_replica_cell_and_ab_pairs():
    """`run_vmapped_cell` gives the sweep row (lane 0's makespan, every
    lane checked); the two A/B pairs give identical makespans."""
    row = sweep.run_vmapped_cell("kv_directory", "srsp", N, SEEDS, "fused",
                                 device="cpu")
    assert row["n_replicas"] == 2 and row["check_ok"]
    assert row["steady_s_per_replica"] == row["steady_s_per_run"] / 2
    assert [r["seed"] for r in row["lanes"]] == list(SEEDS)
    solo = sweep.run_cell("kv_directory", "srsp", N, SEEDS[0], "fused",
                          device="cpu")
    assert (row["makespan"], row["counters"], row["events"]) \
        == (solo["makespan"], solo["counters"], solo["events"])
    fuse = [sweep.measure_fuse(N, 2, 1, engine, "cpu", warmup=False)
            for engine in ("fused", "batched")]
    assert [r["engine"] for r in fuse] == ["fused", "batched"]
    assert fuse[0]["makespan"] == fuse[1]["makespan"]
    ab = [sweep.measure_remote_batch(N, 2, 1, batched, "cpu", warmup=False)
          for batched in (True, False)]
    assert [r["remote_batch"] for r in ab] == [True, False]
    assert ab[0]["makespan"] == ab[1]["makespan"]
    with pytest.raises(ValueError, match="not vmappable"):
        sweep.run_vmapped_cell("worksteal", "srsp", N, SEEDS, device="cpu")
