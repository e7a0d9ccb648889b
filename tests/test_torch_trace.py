"""The port's event trace (`repro_torch.obs.trace`, `export`, `report`)
against the JAX package's, live, at n <= 4.

* the ring sequences of tests/test_obs.py (overflow, masked lanes, an
  append with more lanes than `cap`), port == JAX column for column;
* the disabled log: every `record_*` returns its input (`is`), the
  summary is None/0, and a trace-off store has the reference's leaves;
* the tiny traced store of tests/test_obs.py (a remote acquire, its
  release and a crash instant): decoded columns, histograms, the Chrome
  document and the text report, all == the JAX package's;
* the op outcomes (promote / probe / nack / global, load and store
  hit / miss) on a mixed-scope bundle in both metadata layouts;
* `report.main` on a JSON the reference wrote prints the reference's
  text, and the report demo's document is the reference's;
* the append under `torch.func.vmap`, each replica its solo append.

Larger cells are held to `golden/trace.*` in test_torch_trace_golden.py
and test_torch_trace_engines.py.
"""
import json
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as JO  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.obs import export as JE  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core import ops as O  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.obs import export, report  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402

torch.use_deterministic_algorithms(True)

FULL = [True] * 3
# tests/test_obs.py's fixed ring sequences: (cap, masks)
RING_SEQUENCES = [
    (4, []),                                  # empty log decodes empty
    (4, [FULL]),                              # partial fill
    (4, [FULL, FULL]),                        # wraps by 2
    (1, [FULL, [False, True, False]]),        # cap 1 keeps only the newest
    (5, [[True, False, True]] * 4),           # masked lanes + wrap
    (1, [FULL]),                              # one append of 3 lanes, cap 1
    (2, [FULL, FULL, [True, True, False]]),   # every append past cap
]


def _same_log(port, ref, ctx=""):
    """Two logs, leaf for leaf, bit for bit."""
    for name, a, b in zip(T.TraceLog._fields, port, ref):
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {name}")


def _same_decode(port, ref, ctx=""):
    assert (port["count"], port["dropped"]) == (ref["count"],
                                                ref["dropped"]), ctx
    for k, v in ref["events"].items():
        np.testing.assert_array_equal(port["events"][k], v,
                                      err_msg=f"{ctx} {k}")
        assert port["events"][k].dtype == v.dtype, (ctx, k)


def _ring(mod, make, cap, steps, to):
    n = 3
    tl = make(cap, n)
    for i, mask in enumerate(steps):
        tl = mod._append(tl, to(np.asarray(mask)),
                         clock=to(np.full((n,), float(i), np.float32)),
                         agent=to(np.arange(n, dtype=np.int32)),
                         kind=mod.LOAD, scope=1,
                         addr=to(np.arange(n, dtype=np.int32) + 100 * i),
                         cycles=1.0, outcome=mod.OC_HIT)
    return tl


@pytest.mark.parametrize("cap,steps", RING_SEQUENCES,
                         ids=[f"cap{c}x{len(s)}" for c, s in RING_SEQUENCES])
def test_ring_sequences_match_the_reference(cap, steps):
    ref = _ring(JT, JT.make, cap, steps, jnp.asarray)
    got = _ring(T, lambda c, n: T.make(c, n, "cpu"), cap, steps,
                torch.as_tensor)
    _same_log(got, ref, (cap, steps))
    _same_decode(export.decode(got), JE.decode(ref))
    assert T.dropped(got) == JT.dropped(ref)
    # every slot an append wrote holds its own lane's event: the kept
    # events are the newest `cap`, oldest first
    want = [(float(i), a, a + 100 * i) for i, m in enumerate(steps)
            for a in range(3) if m[a]][-cap:]
    dec = export.decode(got)["events"]
    assert list(zip(dec["clock"].tolist(), dec["agent"].tolist(),
                    dec["addr"].tolist())) == (want if steps else [])


def test_make_has_the_reference_leaves():
    for cap, n in ((0, 4), (8, 4), (4096, 64)):
        _same_log(T.make(cap, n, "cpu"), JT.make(cap, n), (cap, n))
    assert T.default_cap() == (T.DEFAULT_CAP if T.TRACE else 0)
    assert T.KIND_NAMES == JT.KIND_NAMES
    assert T.OUTCOME_NAMES == JT.OUTCOME_NAMES
    assert T.CHURN_NAMES == JT.CHURN_NAMES
    assert export.SCOPE_NAMES == JE.SCOPE_NAMES
    assert export.SCHED_TID == JE.SCHED_TID


def _store(n=4, cap=0, device="cpu"):
    cfg = P.ProtoConfig(n_caches=n, n_words=256)
    return cfg, T.with_trace(P.make_store(cfg, device), cap)


def test_disabled_trace_is_python_identity():
    _, st = _store()
    assert not T.enabled(st.trace) and T.capacity(st.trace) == 0
    mask = torch.tensor([True, False, True, False])
    addrs = torch.zeros(4, dtype=torch.int32)
    assert T.record_op(st, mask, T.ACQUIRE, 1, addrs, st.counters.cycles,
                       T.OC_PROBE) is st
    assert T.record_event(st, mask, T.CHURN, 1) is st
    assert T.record_turn(st, st.counters.cycles) is st
    assert T.strip(st).trace.clock.shape == (0,)
    assert T.summary(st) == JT.summary(JT.strip(JP.make_store(
        JP.ProtoConfig(n_caches=4, n_words=256)))) == {
        "latency_p50": None, "latency_p95": None, "latency_p99": None,
        "latency_turns": 0, "trace_events": 0, "trace_dropped": 0}


def test_make_store_follows_repro_trace(monkeypatch):
    """`REPRO_TRACE` read at import: make_store allocates DEFAULT_CAP
    slots when it is set, none otherwise."""
    cfg = P.ProtoConfig(n_caches=4, n_words=256)
    monkeypatch.setattr(T, "TRACE", True)
    monkeypatch.setattr(T, "DEFAULT_CAP", 32)
    st = P.make_store(cfg, "cpu")
    assert T.capacity(st.trace) == 32 and st.trace.op_hist.shape[1] == 4
    monkeypatch.setattr(T, "TRACE", False)
    assert T.capacity(P.make_store(cfg, "cpu").trace) == 0


def test_repro_trace_environment_is_read_at_import():
    code = ("from repro_torch.obs import trace as T; "
            "print(T.TRACE, T.DEFAULT_CAP, T.default_cap())")
    env = dict(os.environ, REPRO_TRACE="1", REPRO_TRACE_CAP="77",
               PYTHONPATH=str(pathlib.Path(P.__file__).parents[2]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["True", "77", "77"]


def test_charged_since_is_the_reference():
    from repro.core import costmodel as JC
    c = costmodel.make_counters(4, "cpu")
    c = c._replace(cycles=torch.tensor([3.0, 0.0, 10.5, 7.0]))
    clock0 = torch.tensor([1.0, 0.0, 2.5, 7.0])
    jc = JC.make_counters(4)._replace(cycles=jnp.asarray(c.cycles.numpy()))
    got = costmodel.charged_since(c, clock0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JC.charged_since(jc, clock0.numpy())))


def _tiny(mod_o, mod_p, mod_t, make, arr):
    """tests/test_obs.py's `_tiny_traced_store` in either package."""
    cfg = mod_p.ProtoConfig(n_caches=4, n_words=256)
    st = mod_t.with_trace(make(cfg), 64)
    proto = mod_p.get_protocol("srsp")
    hot = arr(np.arange(4) == 1)
    st, _ = mod_o.acquire(proto, cfg, st, hot, arr(np.full(4, 16, np.int32)),
                          0, 1, scope=mod_o.REMOTE)
    st = mod_o.release(proto, cfg, st, hot, arr(np.full(4, 16, np.int32)),
                       7, scope=mod_o.REMOTE)
    return mod_t.record_event(st, hot, mod_t.CHURN, 1)


def _tiny_pair():
    ref = _tiny(JO, JP, JT, JP.make_store, jnp.asarray)
    got = _tiny(O, P, T, lambda cfg: P.make_store(cfg, "cpu"),
                torch.as_tensor)
    return got, ref


def test_tiny_traced_store_matches_the_reference(tmp_path):
    got, ref = _tiny_pair()
    assert int(got.trace.head) == 3
    _same_log(got.trace, ref.trace)
    _same_decode(export.decode(got.trace), JE.decode(ref.trace))
    strag = [{"cell": "c", "wall_s": 1.0}]
    doc = export.write_trace(str(tmp_path / "p.json"), got, label="unit",
                             stragglers=strag)
    want = JE.write_trace(str(tmp_path / "j.json"), ref, label="unit",
                          stragglers=strag)
    assert json.loads((tmp_path / "p.json").read_text()) \
        == json.loads((tmp_path / "j.json").read_text())
    assert export.text_report(doc) == JE.text_report(want)
    assert T.summary(got) == JT.summary(ref)


def test_report_reads_a_json_the_reference_wrote(tmp_path, capsys):
    from repro.obs import report as JR
    _, ref = _tiny_pair()
    path = tmp_path / "trace.json"
    JE.write_trace(str(path), ref, label="cli")
    assert JR.main([str(path)]) == 0
    want = capsys.readouterr().out
    assert report.main([str(path)]) == 0
    assert capsys.readouterr().out == want
    assert "sRSP trace report: cli" in want


def test_report_demo_document_is_the_references(tmp_path, capsys):
    """`--demo` on the CPU: the JSON it writes is the reference's
    document and it prints the reference's report."""
    from repro.obs import report as JR
    assert JR.main(["--demo", "--out", str(tmp_path / "j.json")]) == 0
    want = capsys.readouterr().out
    assert report.main(["--demo", "--device", "cpu", "--out",
                        str(tmp_path / "p.json")]) == 0
    got = capsys.readouterr().out
    assert json.loads((tmp_path / "p.json").read_text()) \
        == json.loads((tmp_path / "j.json").read_text())
    assert got.replace("p.json", "j.json") == want
    assert "events=27" in got and "check_ok=True recovered=1" in got


def _bundle(mod_o, mod_p, mod_t, make, arr, scope, packed):
    """A mixed-scope bundle after a warm-up that fills tables and L1s:
    every outcome class appears."""
    cfg = mod_p.ProtoConfig(n_caches=4, n_words=256)
    st = mod_t.with_trace(make(cfg), 64)
    proto = mod_p.get_protocol("srsp")
    one = arr(np.ones(4, bool))
    addrs = arr(np.asarray([16, 16, 32, 48], np.int32))
    st, _ = mod_o.store(cfg, st, one, arr(np.asarray([0, 5, 16, 33],
                                                     np.int32)), 9)
    st = mod_o.release(proto, cfg, st, one, addrs, 1, scope=mod_o.LOCAL)
    st, _ = mod_o.load(cfg, st, one, arr(np.asarray([0, 6, 16, 40],
                                                    np.int32)))
    st, _ = mod_o.acquire(proto, cfg, st, one, addrs, 1, 0,
                          scope=arr(np.asarray(scope, np.int32)))
    st = mod_o.release(proto, cfg, st, one, addrs, 1,
                       scope=arr(np.asarray(scope, np.int32)))
    # a remote release leaves PA-TBL entries: local acquires promote
    st, _ = mod_o.acquire(proto, cfg, st, one, addrs, 1, 0,
                          scope=mod_o.LOCAL)
    for val in (2, 3):   # the second store merges into dirty words
        st, _ = mod_o.store(cfg, st, one, arr(np.asarray([0, 7, 16, 33],
                                                         np.int32)), val)
    return st


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
@pytest.mark.parametrize("scope", [[1, 0, 2, 1], [0, 0, 0, 0], [1, 1, 2, 2]],
                         ids=["mixed", "local", "remote_global"])
def test_op_outcomes_match_the_reference(monkeypatch, scope, packed):
    monkeypatch.setattr(P, "PACKED", packed)
    monkeypatch.setattr(JP, "PACKED", packed)
    ref = _bundle(JO, JP, JT, JP.make_store, jnp.asarray, scope, packed)
    got = _bundle(O, P, T, lambda cfg: P.make_store(cfg, "cpu"),
                  torch.as_tensor, scope, packed)
    assert (got.wvalid.dtype == torch.bool) == (not packed)
    _same_log(got.trace, ref.trace, (scope, packed))
    ev = export.decode(got.trace)["events"]
    seen = set(zip(ev["kind"].tolist(), ev["outcome"].tolist()))
    assert {(T.LOAD, T.OC_HIT), (T.LOAD, T.OC_MISS),
            (T.STORE, T.OC_MISS)} <= seen
    if scope == [1, 0, 2, 1]:
        assert {(T.ACQUIRE, T.OC_PROMOTE), (T.ACQUIRE, T.OC_PROBE),
                (T.ACQUIRE, T.OC_NACK), (T.ACQUIRE, T.OC_GLOBAL),
                (T.RELEASE, T.OC_HIT), (T.RELEASE, T.OC_PROBE),
                (T.RELEASE, T.OC_GLOBAL), (T.STORE, T.OC_HIT)} <= seen


def test_append_under_vmap_is_each_replicas_solo_append():
    """Two replicas' logs stacked, one masked append under vmap: each
    lane equals that replica's solo append; no per-example fallback."""
    n, cap = 4, 3
    masks = torch.tensor([[True, True, False, True],
                          [False, True, True, True]])
    heads = [1, 5]
    solos = [T.make(cap, n, "cpu")._replace(
        head=torch.tensor(h, dtype=torch.int32)) for h in heads]
    stacked = T.TraceLog(*(torch.stack(x) for x in zip(*solos)))

    def app(tl, m, clock):
        return T._append(tl, m, clock=clock,
                         agent=torch.arange(n, dtype=torch.int32),
                         kind=T.STORE, scope=2, addr=7, cycles=clock,
                         outcome=T.OC_MISS)

    clocks = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        out = torch.func.vmap(app)(stacked, masks, clocks)
    for k in range(2):
        want = app(solos[k], masks[k], clocks[k])
        for a, b in zip(out, want):
            assert torch.equal(a[k], b)


def test_with_trace_on_every_state_kind():
    from repro_torch.workloads import harness, kv_directory
    bench = kv_directory.build("srsp", 4, seed=1, device="cpu")
    eb = harness.make_elastic(bench)
    for state, get in ((bench.state, lambda s: s.store),
                       (bench.state.store, lambda s: s),
                       (eb.state, lambda s: s.s.store)):
        tl = get(T.with_trace(state, 16)).trace
        assert T.capacity(tl) == 16 and tl.turn_hist.shape == (4, 24)
        assert T.capacity(get(T.strip(T.with_trace(state, 16))).trace) == 0
    stacked = harness.stack([bench.state, bench.state])
    tl = T.with_trace(stacked, 8).store.trace
    assert tl.clock.shape == (2, 8) and tl.op_hist.shape == (2, 3, 4, 24)
    assert T.capacity(tl) == 8 and T.enabled(tl)
    assert not T.enabled(stacked.store.trace)


def test_port_log_converts_to_the_references():
    """`convert` carries a traced store across the packages."""
    got, ref = _tiny_pair()
    back = convert.from_numpy(convert.to_numpy(got), "cpu")
    _same_log(back.trace, ref.trace)
