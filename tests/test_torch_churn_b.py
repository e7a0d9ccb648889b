"""The crash-recovery drain and the elastic state against the JAX package.

* `b_recover` on a seeded store (dirty words in and out of the sFIFO,
  LR and PA entries, leases held and released) against JAX's
  `b_recover`, in the packed and the bool metadata layouts, for an
  all-False mask, a leased lane, a lane without a lease and a mix;
* a JAX `make_elastic` state at n=8 with a crash fired carries over to
  the port (`convert.from_numpy`), and the next passes of the batched
  elastic loop (trips, then the lease's reclaim) give the same leaves
  in both packages.

Every comparison is bitwise, through numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import workloads as JW  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.workloads import faults as JF  # noqa: E402
from repro.workloads import harness as JH  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.core import ops as TO  # noqa: E402
from repro_torch.core import protocol as TP  # noqa: E402
from repro_torch.workloads import faults, harness  # noqa: E402

torch.use_deterministic_algorithms(True)

N = 8


def same_tree(port, ref, ctx=""):
    """Every leaf of the port's tree == the JAX tree's (packed planes
    through their uint32 bits)."""
    a, b = convert.leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b), ctx
    for k, (x, y) in enumerate(zip(a, b)):
        x, y = x.detach().cpu().numpy(), np.asarray(y)
        if x.dtype != y.dtype and x.itemsize == y.itemsize:
            x = x.view(y.dtype)
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k)
        np.testing.assert_array_equal(x, y, err_msg=str((ctx, k)))


def to_jax(port_tree, template):
    """The port's tree as the JAX tree shaped like `template`."""
    leaves = [jnp.asarray(x) for x in
              convert.leaves(convert.to_numpy(port_tree))]
    return jax.tree.unflatten(jax.tree.structure(template), leaves)


def _soup(cfg, seed):
    """A port store after a seeded op soup: every lane takes a lock at
    LOCAL scope (a lease) and stores to its block and to shared ones;
    lanes 0-3 release (LR entries), lanes 4-7 keep their lease; one
    remote acquire and release (PA entries); more stores, some evicting
    from the 4-entry sFIFO."""
    rng = np.random.default_rng(seed)
    st = TP.make_store(cfg, "cpu")
    lanes = np.arange(N)
    every = torch.ones(N, dtype=torch.bool)
    locks = torch.as_tensor(lanes * 16, dtype=torch.int32)
    st, _ = TO.acquire(TP.SRSP, cfg, st, every, locks, 0, 1)
    for _ in range(6):
        addrs = rng.integers(0, cfg.n_words, N).astype(np.int32)
        mine = rng.random(N) < 0.5
        addrs[mine] = lanes[mine] * 16 + 1 + rng.integers(0, 15, mine.sum())
        st, _ = TO.store(cfg, st, torch.as_tensor(rng.random(N) < 0.8),
                         torch.as_tensor(addrs),
                         torch.as_tensor(rng.integers(1, 99, N)
                                         .astype(np.int32)))
    st = TO.release(TP.SRSP, cfg, st, torch.as_tensor(lanes < 4), locks, 0)
    hot = torch.as_tensor(lanes == 3)
    st, _ = TO.acquire(TP.SRSP, cfg, st, hot, 16, 0, 1, scope=TO.REMOTE)
    st = TO.release(TP.SRSP, cfg, st, hot, 16, 0, scope=TO.REMOTE)
    for _ in range(3):
        st, _ = TO.store(cfg, st, every, torch.as_tensor(
            rng.integers(0, cfg.n_words, N).astype(np.int32)), 7)
    return st


MASKS = {"none": [], "leased": [6], "unleased": [2], "mixed": [1, 4, 7]}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("packed", [True, False])
def test_b_recover_matches_jax(packed, mask, monkeypatch):
    monkeypatch.setattr(TP, "PACKED", packed)
    monkeypatch.setattr(JP, "PACKED", packed)
    kw = dict(n_caches=N, n_words=256, fifo_cap=4)
    cfg, jcfg = TP.ProtoConfig(**kw), JP.ProtoConfig(**kw)
    st = _soup(cfg, 11)
    assert (st.wdirty.dtype == torch.int32) == packed
    leased = (st.lease.addr >= 0).tolist()
    assert leased == [False] * 4 + [True] * 4
    assert bool(TP.wdirty_bool(st).any())
    m = np.isin(np.arange(N), MASKS[mask])
    jst = to_jax(st, JP.make_store(jcfg))
    got = TP.b_recover(cfg, st, torch.as_tensor(m))
    want = JP.b_recover(jcfg, jst, jnp.asarray(m))
    same_tree(got, want, (packed, mask))
    assert float(got.counters.recoveries) == float(m.sum())
    assert (got.lease.addr[torch.as_tensor(m)] == -1).all()
    if mask != "none":
        assert not bool(TP.wdirty_bool(got)[torch.as_tensor(m)].any())


def _jax_pass(wl, sched, es, ops):
    """The body of the JAX `run_batched_elastic` loop, one pass."""
    can_l, can_r = JH._elastic_ready(wl, es, ops)
    clocks = jnp.where(can_l | can_r, es.s.store.counters.cycles, JH.BIG)
    mcc = jnp.min(clocks)
    ec = JH._event_horizon(sched, es)
    return jax.lax.cond(
        (ec <= mcc) & (ec < JH.BIG),
        lambda e: JH._fire_events(wl, sched, e, mcc, ops),
        lambda e: e._replace(s=JH._batched_trip(wl, e.s, can_l, can_r, ec,
                                                ops)),
        es)


def test_elastic_state_carries_over_and_continues_alike():
    """kv_directory n=8 seed 3, crash_dirty of agent 2 from clock 0 (its
    releases leave dirty words no LR entry covers), its CRASH at clock 40
    with a lease of 300: JAX runs until the crash has fired, the state
    carries over, and each next pass (trips fenced at the reclaim clock
    340, the reclaim, more trips) is the same in both packages."""
    events, lease = [(40.0, 2, "crash")], 300.0
    jproto = JF.crash_dirty(JP.get_protocol("srsp"), 2, 0.0)
    jb = JH.make_elastic(JW.get("kv_directory").build("srsp", N, seed=3,
                                                      proto=jproto),
                         events, lease)
    sched, ops = jb.ops[0], jb.ops[1:]
    step = jax.jit(_jax_pass, static_argnums=(0,))
    jes = jb.state
    for _ in range(20):
        jes = step(jb.wl, sched, jes, ops)
        if not bool(jes.alive[2]):
            break
    assert float(jes.recover_at[2]) == 340.0
    proto = faults.crash_dirty(TP.get_protocol("srsp"), 2, 0.0)
    tb = harness.make_elastic(workloads.get("kv_directory").build(
        "srsp", N, seed=3, proto=proto, device="cpu"), events, lease)
    same_tree(tb.ops[0], sched, "schedule")
    es = convert.from_numpy(jax.tree.map(np.asarray, jes), "cpu")
    assert isinstance(es, harness.ElasticState)
    same_tree(es, jes, "carried over")
    assert bool(TP.wdirty_bool(es.s.store)[2].any())
    reclaimed = False
    for k in range(12):
        go, es = harness._elastic_trip(tb.wl, tb.ops[0], es, (), True)
        jes = step(jb.wl, sched, jes, ops)
        assert go
        same_tree(es, jes, ("pass", k))
        reclaimed |= float(es.s.store.counters.recoveries) == 1.0
    assert reclaimed and bool(es.recover_at[2] == harness.BIG)
    assert not bool(TP.wdirty_bool(es.s.store)[2].any())
