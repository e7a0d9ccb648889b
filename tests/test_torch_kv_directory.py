"""kv_directory end to end: the port against the JAX package at n=8.

Both packages start from the same state (the JAX package's initial
state carried over with `repro_torch.convert.from_numpy`), run the same
engine, and must end in the same state, leaf by leaf and bit for bit.
The JAX package runs in its default kernel mode on the CPU (`ref`).
Inside the port, serial, batched and fused runs must agree bitwise too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import workloads as jworkloads  # noqa: E402
from repro.workloads import harness as jharness  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.workloads import harness, sweep  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED = 8, 3
JMOD = jworkloads.get("kv_directory")
TMOD = workloads.get("kv_directory")


def _same_tree(port, ref, ctx):
    a, b = convert.leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b), ctx
    for k, (x, y) in enumerate(zip(a, b)):
        x, y = x.numpy(), np.asarray(y)
        if x.dtype != y.dtype:
            x = x.view(y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=str((ctx, k)))


def _port_run(scenario, engine, state=None):
    bench = TMOD.build(scenario, N, seed=SEED, device="cpu")
    final = harness.runner(engine)(bench.wl, bench.state if state is None
                                   else state)
    return final, bench.check(final)


@pytest.mark.parametrize("scenario,engine", [
    ("srsp", "fused"), ("rsp", "fused"), ("baseline", "fused"),
    ("srsp", "serial"), ("srsp", "batched")])
def test_final_state_matches_jax(scenario, engine):
    jb = JMOD.build(scenario, N, seed=SEED)
    start = convert.from_numpy(jax.tree.map(np.asarray, jb.state), "cpu")
    # the port's own initial state is the carried-over one
    _same_tree(TMOD.build(scenario, N, seed=SEED, device="cpu").state,
               jb.state, "init")
    jfinal = jharness.runner(engine)(jb.wl, jb.state, *jb.ops)
    tfinal, tcheck = _port_run(scenario, engine, start)
    _same_tree(tfinal, jfinal, (scenario, engine))
    jcheck = jb.check(jfinal)
    assert tcheck == jcheck and tcheck["ok"]
    assert harness.counters_dict(tfinal.store) \
        == jharness.counters_dict(jfinal.store)


@pytest.mark.parametrize("scenario", ["srsp", "rsp", "baseline"])
def test_engines_agree_inside_the_port(scenario):
    fused, _ = _port_run(scenario, "fused")
    for engine in ("serial", "batched"):
        other, check = _port_run(scenario, engine)
        assert check["ok"]
        for x, y in zip(convert.leaves(other), convert.leaves(fused)):
            assert torch.equal(x, y), (scenario, engine)


def test_run_cell_reports_the_sweep_row():
    row = sweep.run_cell("kv_directory", "srsp", N, SEED, "fused",
                         device="cpu")
    final, check = _port_run("srsp", "fused")
    assert row["counters"] == harness.counters_dict(final.store)
    assert row["makespan"] == row["counters"]["makespan"]
    assert row["check_ok"] and row["check_fails"] == 0
    assert row["events"] == check["events"]
    assert row["steady_s"] > 0 and row["device"] == "cpu"


def test_convert_round_trip():
    jb = JMOD.build("srsp", N, seed=SEED)
    jfinal = jharness.run_fused(jb.wl, jb.state)
    ref = jax.tree.map(np.asarray, jfinal)
    back = convert.to_numpy(convert.from_numpy(ref, "cpu"))
    for x, y in zip(convert.leaves(back), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
