"""The lock and queue workloads end to end: the port against the JAX
package at n=8 (reader_lock here; producer_consumer and
producer_consumer_mc in test_torch_workloads_pc.py and
test_torch_workloads_mc.py, and the protocol faults in
test_torch_faults.py, which share this file's helpers).

Each workload under srsp, rsp, baseline and scope_only: one JAX run (its
default kernel mode on the CPU, `ref`) is held leaf by leaf, bit for
bit, against the port's serial, batched and fused runs from the same
initial state, and the counters, `events` and self-check verdicts must
be equal.  The JAX package's engines are bitwise equal to each other
(tests/test_workloads.py), so its serial run, the quickest to compile,
stands for all three, with one documented exception (DESIGN.md §9):
where producer_consumer_mc co-schedules remote drains (protocols with
batched remote twins), the batch permutes same-trip PA-TBL insertions,
so there the port's serial run is held to the JAX serial run and its
batched and fused runs to the JAX fused run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import workloads as jworkloads  # noqa: E402
from repro.workloads import harness as jharness  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.workloads import harness  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED = 8, 3
ENGINES = ("serial", "batched", "fused")
SCENARIOS = ("srsp", "rsp", "baseline", "scope_only")


def _same_tree(port, ref, ctx):
    """Leaf by leaf, bit for bit (planes through their numpy views)."""
    a, b = convert.leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b), ctx
    for k, (x, y) in enumerate(zip(a, b)):
        x, y = x.numpy(), np.asarray(y)
        if x.dtype != y.dtype:
            x = x.view(y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=str((ctx, k)))


def _co_schedules(name, scenario):
    """Does the batched engine co-schedule remote turns of this cell?"""
    return name == "producer_consumer_mc" \
        and P.get_protocol(harness.SCENARIO_PROTOCOLS[scenario]) \
        .remote_batchable


def _jax_run(name, scenario, engine="serial", proto=None):
    b = jworkloads.get(name).build(scenario, N, seed=SEED, proto=proto)
    final = jharness.runner(engine)(b.wl, b.state, *b.ops)
    return final, b.check(final)


def _port_bench(name, scenario, proto=None):
    return workloads.get(name).build(scenario, N, seed=SEED, proto=proto,
                                     device="cpu")


def _port_run(name, scenario, engine, proto=None):
    b = _port_bench(name, scenario, proto)
    final = harness.runner(engine)(b.wl, b.state, *b.ops)
    return final, b.check(final)


def check_every_engine(name, scenario, red=("scope_only",)):
    """The port's three engines against the JAX package's run(s); the
    self-check is red exactly in the `red` scenarios."""
    groups = [("serial",), ("batched", "fused")] \
        if _co_schedules(name, scenario) else [ENGINES]
    for group in groups:
        jengine = "serial" if "serial" in group else "fused"
        jfinal, jcheck = _jax_run(name, scenario, jengine)
        assert jcheck["ok"] == (scenario not in red), jcheck
        for engine in group:
            tfinal, tcheck = _port_run(name, scenario, engine)
            ctx = (name, scenario, engine, jengine)
            _same_tree(tfinal, jfinal, ctx)
            assert tcheck == jcheck, ctx
            assert harness.counters_dict(tfinal.store) \
                == jharness.counters_dict(jfinal.store), ctx
    jax.clear_caches()


def test_registry_lists_the_ported_workloads():
    assert workloads.available() == jworkloads.available() == [
        "kv_directory", "kv_serving", "producer_consumer",
        "producer_consumer_mc", "reader_lock", "worksteal"]
    with pytest.raises(KeyError, match="available"):
        workloads.get("no_such_workload")


@pytest.mark.parametrize("name", ["reader_lock", "producer_consumer",
                                  "producer_consumer_mc"])
def test_initial_state_matches_jax(name):
    jb = jworkloads.get(name).build("srsp", N, seed=SEED)
    _same_tree(_port_bench(name, "srsp").state, jb.state, name)
    back = convert.from_numpy(jax.tree.map(np.asarray, jb.state), "cpu")
    assert type(back).__name__ == type(jb.state).__name__


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_engine_matches_jax(scenario):
    check_every_engine("reader_lock", scenario)
