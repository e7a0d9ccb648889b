"""kv_serving end to end: the port against the JAX package at n=8,
replaying the trace the JAX package generated.

The bench's streams are replaced with `driver.from_trace` of the JAX
trace (`kv_serving.with_trace`), so the runs are held leaf by leaf, bit
for bit, with counters, `events` and the self-check (latency histogram
included) equal.  The comparison rule is test_torch_workloads.py's:
where the protocol co-schedules remote lookups (srsp, baseline,
scope_only), the reference's serial and fused runs differ in the latency
histogram, so the port's serial run is held to the JAX serial run and
its batched and fused runs to the JAX fused run; under rsp the JAX
serial run stands for all three.  The port's own draw of the trace
(`init_state`) serves every request with a green check.  srsp and rsp
here; baseline and scope_only in test_torch_kv_serving_b.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import workloads as jworkloads  # noqa: E402
from repro.traffic import trace as JT  # noqa: E402
from repro.workloads import harness as jharness  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import harness, kv_serving  # noqa: E402
from test_torch_workloads import _same_tree  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED = 8, 3


def _jax_bench(scenario):
    return jworkloads.get("kv_serving").build(scenario, N, seed=SEED)


def _jax_trace(jb) -> TR.RequestTrace:
    cfg = jb.wl.cfg
    jt = JT.generate(cfg.traffic, N, cfg.n_pages, SEED)
    return TR.RequestTrace(*(torch.from_numpy(np.array(c)) for c in jt))


def _port_bench(scenario, tr):
    b = workloads.get("kv_serving").build(scenario, N, seed=SEED,
                                          device="cpu")
    return kv_serving.with_trace(b, tr)


def test_replayed_initial_state_matches_jax():
    jb = _jax_bench("srsp")
    _same_tree(_port_bench("srsp", _jax_trace(jb)).state, jb.state, "init")


def check_every_engine(scenario):
    """The port's three engines against the JAX package's run(s)."""
    jb = _jax_bench(scenario)
    tr = _jax_trace(jb)
    co = _port_bench(scenario, tr).wl.remote_cap
    groups = [("serial",), ("batched", "fused")] if co \
        else [("serial", "batched", "fused")]
    for group in groups:
        jengine = "serial" if "serial" in group else "fused"
        jb = _jax_bench(scenario)
        jfinal = jharness.runner(jengine)(jb.wl, jb.state)
        jcheck = jb.check(jfinal)
        assert jcheck["ok"] == (scenario != "scope_only"), jcheck
        for engine in group:
            b = _port_bench(scenario, tr)
            final = harness.runner(engine)(b.wl, b.state)
            ctx = (scenario, engine, jengine)
            _same_tree(final, jfinal, ctx)
            assert b.check(final) == jcheck, ctx
            assert harness.counters_dict(final.store) \
                == jharness.counters_dict(jfinal.store), ctx
    jax.clear_caches()


@pytest.mark.parametrize("scenario", ["srsp", "rsp"])
def test_every_engine_matches_jax(scenario):
    check_every_engine(scenario)


def test_own_trace_serves_every_request():
    b = workloads.get("kv_serving").build("srsp", N, seed=SEED,
                                          device="cpu")
    final = harness.run_fused(b.wl, b.state)
    check = b.check(final)
    assert check["ok"] and check["done"], check
    assert check["completed"] == check["offered"] == N * 24
