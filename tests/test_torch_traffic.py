"""The port's traffic subsystem and latency histograms against the JAX
package's (`repro.traffic`, `repro.obs.metrics`).

* `metrics.bucket_index` bit for bit, edges and the clamp included;
* `trace.save`/`load` across packages: a JAX trace loads in the port and
  a port trace in the JAX package, columns and provenance exact;
* `trace.generate` held to the JAX draw of the same provenance
  (`trace.compare`): every agent's keys and kinds bit for bit, arrival
  clocks within `arrival_rtol`;
* `driver`: tests/test_traffic.py's cases on a JAX trace loaded into the
  port: `from_trace` leaf for leaf, lbnr against a host loop, the
  predicates partitioning `pending`, the `remote_bound` fence and
  exhaustion, the `wait_cycles` clamp, retire/admit touching only the
  quota.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.obs import metrics as JM  # noqa: E402
from repro.traffic import driver as JD  # noqa: E402
from repro.traffic import samplers as JS  # noqa: E402
from repro.traffic import trace as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.traffic import driver as D  # noqa: E402
from repro_torch.traffic import samplers as S  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402

torch.use_deterministic_algorithms(True)

N_AGENTS = 4
N_KEYS = 8


def _cfgs(**kw):
    return (dataclasses.replace(JS.TrafficConfig(), **kw),
            dataclasses.replace(S.TrafficConfig(), **kw))


def _port(tr) -> TR.RequestTrace:
    return TR.RequestTrace(*(torch.from_numpy(np.array(c)) for c in tr))


def _streams(seed=7, m=32, **kw):
    jc, _ = _cfgs(requests_per_agent=m, **kw)
    jt = JT.generate(jc, N_AGENTS, N_KEYS, seed)
    return JD.from_trace(jt, N_AGENTS, m), D.from_trace(_port(jt),
                                                        N_AGENTS, m)


def _np(x):
    return np.asarray(x)


def test_bucket_index_is_jax():
    x = np.concatenate([
        np.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.99, 4.0, 2.0**21, 2.0**22,
                    2.0**23, 3e38], np.float32),
        np.float32(2.0) ** np.arange(24, dtype=np.float32),
        np.nextafter(np.float32(2.0) ** np.arange(1, 24, dtype=np.float32),
                     np.float32(0)),
        np.random.default_rng(0).random(4096, np.float32) * 2e6])
    got = M.bucket_index(torch.from_numpy(x)).numpy()
    want = np.asarray(JM.bucket_index(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert M.N_BUCKETS == JM.N_BUCKETS


def test_summaries_are_jax():
    for seed in range(3):
        h = np.random.default_rng(seed).integers(0, 9, M.N_BUCKETS)
        assert M.summarize(h) == JM.summarize(h)
        for q in (0.0, 0.5, 0.99, 1.0):
            assert M.percentile_bounds(h, q) == JM.percentile_bounds(h, q)
    assert M.summarize(np.zeros(M.N_BUCKETS)) \
        == JM.summarize(np.zeros(M.N_BUCKETS))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    jc, tc = _cfgs(requests_per_agent=16, zipf_s=1.3, burstiness=2.0)
    jt = JT.generate(jc, N_AGENTS, N_KEYS, 5)
    path = str(tmp_path / "trace.npz")
    if direction == "jax_to_port":
        JT.save(path, jt, cfg=jc, n_agents=N_AGENTS, n_keys=N_KEYS, seed=5)
        tr, meta = TR.load(path, "cpu")
        assert meta["config"] == tc
    else:
        TR.save(path, _port(jt), cfg=tc, n_agents=N_AGENTS, n_keys=N_KEYS,
                seed=5)
        tr, meta = JT.load(path)
        assert meta["config"] == jc
    assert (meta["n_agents"], meta["n_keys"], meta["seed"]) \
        == (N_AGENTS, N_KEYS, 5)
    for a, b in zip(tr, jt):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_save_set_round_trip(tmp_path):
    jc, tc = _cfgs(requests_per_agent=8)
    traces = {f"s{s}": {"tr": JT.generate(jc, N_AGENTS, N_KEYS, s),
                        "cfg": tc, "n_agents": N_AGENTS, "n_keys": N_KEYS,
                        "seed": s} for s in (0, 1)}
    path = str(tmp_path / "set.npz")
    TR.save_set(path, traces)
    back = TR.load_set(path, "cpu")
    assert sorted(back) == ["s0", "s1"]
    for name, (tr, meta) in back.items():
        assert meta["seed"] == traces[name]["seed"]
        for a, b in zip(tr, traces[name]["tr"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,m,seed,kw", [
    (4, 32, 7, {"remote_frac": 0.4}), (8, 24, 3, {}),
    (16, 24, 4, {}), (8, 64, 1, {"burstiness": 4.0, "zipf_s": 1.2})])
def test_generate_is_held_to_the_jax_trace(n, m, seed, kw):
    jc, tc = _cfgs(requests_per_agent=m, **kw)
    want = _port(JT.generate(jc, n, 2 * n, seed))
    got = TR.generate(tc, n, 2 * n, seed, device="cpu")
    res = TR.compare(got, want, n, m)
    print(res)
    assert res["held"], res
    assert all(c.shape == (n * m,) for c in got)
    assert [c.dtype for c in got] == [torch.float32] + [torch.int32] * 3


def test_generate_rejects_ragged_placement():
    with pytest.raises(ValueError):
        TR.generate(S.TrafficConfig(), n_agents=3, n_keys=8, seed=0,
                    device="cpu")


def test_from_trace_is_jax():
    jst, st = _streams(remote_frac=0.4)
    a, b = convert.leaves(st), list(jst)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), _np(y))


def test_lbnr_matches_reference_loop():
    _, st = _streams(remote_frac=0.4)
    rem = st.remote.numpy()
    n, m = rem.shape
    ref = np.zeros((n, m), np.int32)
    for i in range(n):
        run = 0
        for j in reversed(range(m)):
            run = 0 if rem[i, j] else run + 1
            ref[i, j] = run
    np.testing.assert_array_equal(st.lbnr.numpy(), ref)


def test_driver_predicates_partition_pending():
    jst, st = _streams(remote_frac=0.4)
    for c in (0, 5, 31, 32):
        cursor = torch.full((N_AGENTS,), c, dtype=torch.int32)
        loc = D.can_local(st, cursor).numpy()
        rem = D.can_remote(st, cursor).numpy()
        pend = D.pending(st, cursor).numpy()
        assert np.all(loc ^ rem == pend) and not np.any(loc & rem)
        jc = jnp.full(N_AGENTS, c, jnp.int32)
        np.testing.assert_array_equal(loc, _np(JD.can_local(jst, jc)))
        np.testing.assert_array_equal(rem, _np(JD.can_remote(jst, jc)))
        for x, y in zip(D.at_cursor(st, cursor), JD.at_cursor(jst, jc)):
            np.testing.assert_array_equal(x.numpy(), _np(y))


def test_remote_bound_fence_and_exhaustion():
    jst, st = _streams(remote_frac=0.4, m=8)
    cursor = torch.tensor([0, 2, 7, 8], dtype=torch.int32)
    bound = D.remote_bound(st, cursor, 20.0).numpy()
    np.testing.assert_array_equal(bound, _np(JD.remote_bound(
        jst, jnp.asarray(cursor.numpy()), 20.0)))
    np.testing.assert_allclose(bound[:3], st.lbnr.numpy()[[0, 1, 2],
                                                          [0, 2, 7]] * 20.0)
    assert bound[3] >= 1e38


def test_wait_cycles_clamp():
    jst, st = _streams(m=8)
    cursor = torch.zeros(N_AGENTS, dtype=torch.int32)
    arr = st.arrival[:, 0].numpy()
    early = D.wait_cycles(st, cursor, torch.zeros(N_AGENTS)).numpy()
    np.testing.assert_array_equal(early, arr)
    late = D.wait_cycles(st, cursor, torch.full((N_AGENTS,), 1e9)).numpy()
    np.testing.assert_array_equal(late, np.zeros(N_AGENTS))
    mid = torch.from_numpy(arr * 0.5)
    np.testing.assert_array_equal(
        D.wait_cycles(st, cursor, mid).numpy(),
        _np(JD.wait_cycles(jst, jnp.zeros(N_AGENTS, jnp.int32),
                           jnp.asarray(arr * 0.5))))


def test_retire_admit_touch_only_quota():
    _, st = _streams(m=8)
    cursor = torch.full((N_AGENTS,), 3, dtype=torch.int32)
    dead = torch.tensor([True, False, False, False])
    st2 = D.retire(st, cursor, dead)
    assert st2.quota.tolist() == [3, 8, 8, 8]
    assert torch.equal(st2.key, st.key)
    st3 = D.admit(st2, cursor, dead)
    assert st3.quota.tolist() == [4, 8, 8, 8]
    done = torch.full((N_AGENTS,), 8, dtype=torch.int32)
    assert D.admit(st2, done, dead).quota.tolist() == [8, 8, 8, 8]
    # all-False churn is the identity (the elastic zero-churn contract)
    st4 = D.retire(st, cursor, torch.zeros(N_AGENTS, dtype=torch.bool))
    assert torch.equal(st4.quota, st.quota)
