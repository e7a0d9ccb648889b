"""The port's core modules against the JAX package's, on shared inputs.

Covers `core/bitmask`, `core/sfifo`, `core/tables`, `core/protocol` and
`core/ops`: every input is made from a numpy seed and fed to both
packages, and results are compared bitwise, leaf by leaf (packed planes
through `.view(np.uint32)`).  Protocol scenarios are the ones of
tests/test_protocol.py and tests/test_ops.py, each written once and run
through both packages; the port starts from the JAX package's store
carried over with `repro_torch.convert.from_numpy`.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitmask as jbm  # noqa: E402
from repro.core import ops as JO  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.core import sfifo as jfifo  # noqa: E402
from repro.core import tables as jtab  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bitmask as tbm  # noqa: E402
from repro_torch.core import ops as TO  # noqa: E402
from repro_torch.core import protocol as TP  # noqa: E402
from repro_torch.core import sfifo as tfifo  # noqa: E402
from repro_torch.core import tables as ttab  # noqa: E402

torch.use_deterministic_algorithms(True)

WIDTHS = (1, 7, 31, 32, 33, 64, 80)


def _same(got, want, ctx=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    if got.dtype != want.dtype and got.itemsize == want.itemsize:
        got = got.view(want.dtype)
    assert got.shape == want.shape, (ctx, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(ctx))


def _same_tree(port, ref, ctx=""):
    a, b = convert.leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b), ctx
    for k, (x, y) in enumerate(zip(a, b)):
        _same(x, y, (ctx, k))


def _rand_words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


# --------------------------------------------------------------------------
# bitmask (the properties of tests/test_bitmask.py, held against JAX)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
def test_bitmask_pack_unpack_match_jax(w):
    rng = np.random.default_rng(w)
    flags = rng.integers(0, 2, (3, w)).astype(bool)
    packed = tbm.pack(torch.from_numpy(flags))
    _same(packed, jbm.pack(jnp.asarray(flags)))
    _same(tbm.unpack(packed, w), flags)
    _same(tbm.popcount(packed), jbm.popcount(jbm.pack(jnp.asarray(flags))))
    _same(tbm.any_set(packed), flags.any(axis=-1))


def test_bitmask_sign_bit_words():
    """Words with bit 31 set: unpack, popcount and bit tests equal the
    uint32 results although int32 `>>` is arithmetic."""
    rng = np.random.default_rng(31)
    words = _rand_words(rng, (64, 3)) | np.uint32(1 << 31)
    t = torch.from_numpy(words.view(np.int32))
    _same(tbm.unpack(t, 96), jbm.unpack(jnp.asarray(words), 96))
    _same(tbm.popcount_word(t), jbm.popcount_word(jnp.asarray(words)))
    _same(tbm.popcount(t), jbm.popcount(jnp.asarray(words)))
    o = torch.arange(32, dtype=torch.int32)
    _same(tbm.word_bit(o), jbm.word_bit(jnp.arange(32)))
    assert int(tbm.word_bit(torch.tensor(31))) < 0
    row = t[0, :1].expand(32)
    _same(tbm.test_word(row, o), jbm.test_word(jnp.asarray(words[0, :1]),
                                               jnp.arange(32)))


@pytest.mark.parametrize("w", (33, 64, 80))
def test_bitmask_set_clear_get_match_jax(w):
    rng = np.random.default_rng(100 + w)
    vec = _rand_words(rng, (tbm.n_lanes(w),))
    vec &= np.asarray(jbm.pack(jnp.ones((w,), bool)))      # padding clear
    tv, jv = torch.from_numpy(vec.view(np.int32)), jnp.asarray(vec)
    for o in [0, 31, 32, w - 1] + list(rng.integers(0, w, 6)):
        o_t, o_j = torch.tensor(int(o)), jnp.int32(int(o))
        _same(tbm.get_bit(tv, o_t), jbm.get_bit(jv, o_j), o)
        on = bool(rng.random() < 0.7)
        tv, jv = tbm.set_bit(tv, o_t, on), jbm.set_bit(jv, o_j, on)
        _same(tv, jv, ("set", o))
        off = bool(rng.random() < 0.5)
        tv, jv = tbm.clear_bit(tv, o_t, off), jbm.clear_bit(jv, o_j, off)
        _same(tv, jv, ("clear", o))


# --------------------------------------------------------------------------
# sfifo and tables on shared random op sequences
# --------------------------------------------------------------------------

N_CACHES = 3
# the JAX ops vmapped over the cache axis, jitted once for the file
V = {f.__name__: jax.jit(jax.vmap(f)) for f in (
    jfifo.push, jfifo.drain_upto, jfifo.size, jtab.lr_insert, jtab.lr_remove,
    jtab.lr_lookup, jtab.pa_insert, jtab.pa_contains, jtab.lr_reset,
    jtab.pa_reset)}
V["lr_lookup_many"] = jax.jit(jax.vmap(jax.vmap(jtab.lr_lookup,
                                                in_axes=(None, 0))))


@pytest.mark.parametrize("seed", range(4))
def test_sfifo_random_ops_match_jax(seed):
    rng = np.random.default_rng(seed)
    cap = 4
    tf = tfifo.make(N_CACHES, cap)
    jf = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_CACHES,) + x.shape),
                      jfifo.make(cap))
    for step in range(40):
        if rng.random() < 0.7:
            addr = rng.integers(0, 7, N_CACHES).astype(np.int32)
            ft = rng.random(N_CACHES) < 0.3
            tf, t_ev, t_pos = tfifo.push(tf, torch.from_numpy(addr),
                                         torch.from_numpy(ft))
            jf, j_ev, j_pos = V["push"](jf, jnp.asarray(addr),
                                        jnp.asarray(ft))
            _same(t_ev, j_ev, (step, "evicted"))
            _same(t_pos, j_pos, (step, "pos"))
        else:
            pos = rng.integers(-1, 45, N_CACHES).astype(np.int32)
            tf, t_d, t_c = tfifo.drain_upto(tf, torch.from_numpy(pos))
            jf, j_d, j_c = V["drain_upto"](jf, jnp.asarray(pos))
            _same(t_d, j_d, (step, "drained"))
            _same(t_c, j_c, (step, "count"))
        _same_tree(tf, jf, step)
        _same(tfifo.size(tf), V["size"](jf), step)


@pytest.mark.parametrize("seed", range(4))
def test_tables_random_ops_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    lr_g, pa_g = ttab.TableGeometry(2, 2), ttab.TableGeometry(2, 3)
    tl = ttab.lr_make(N_CACHES, lr_g)
    tp = ttab.pa_make(N_CACHES, pa_g)
    stack = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.broadcast_to(x, (N_CACHES,) + x.shape), t)
    jl = stack(jtab.lr_make(jtab.TableGeometry(2, 2)))
    jp = stack(jtab.pa_make(jtab.TableGeometry(2, 3)))
    for step in range(50):
        # block-spaced addresses (sets differ by addr >> 4), some negative
        addr = (rng.integers(-1, 10, N_CACHES) * 16).astype(np.int32)
        ta, ja = torch.from_numpy(addr), jnp.asarray(addr)
        op = rng.integers(0, 6)
        if op == 0:
            ptr = rng.integers(0, 50, N_CACHES).astype(np.int32)
            tl, t_ea, t_ep = ttab.lr_insert(tl, ta, torch.from_numpy(ptr))
            jl, j_ea, j_ep = V["lr_insert"](jl, ja, jnp.asarray(ptr))
            _same(t_ea, j_ea, step)
            _same(t_ep, j_ep, step)
        elif op == 1:
            tl = ttab.lr_remove(tl, ta)
            jl = V["lr_remove"](jl, ja)
        elif op == 2:
            tp = ttab.pa_insert(tp, ta)
            jp = V["pa_insert"](jp, ja)
        elif op == 3:
            many = (rng.integers(0, 10, (N_CACHES, 5)) * 16).astype(np.int32)
            _same(ttab.lr_lookup(tl, torch.from_numpy(many)),
                  V["lr_lookup_many"](jl, jnp.asarray(many)), step)
        elif op == 4:
            _same(ttab.pa_contains(tp, ta),
                  V["pa_contains"](jp, ja), step)
        elif rng.random() < 0.3:
            tl, tp = ttab.lr_reset(tl), ttab.pa_reset(tp)
            jl, jp = V["lr_reset"](jl), V["pa_reset"](jp)
        _same(ttab.lr_lookup(tl, ta), V["lr_lookup"](jl, ja), step)
        _same_tree(tl, jl, ("lr", step))
        _same_tree(tp, jp, ("pa", step))


# --------------------------------------------------------------------------
# protocol and scoped-ISA scenarios, each run through both packages
# --------------------------------------------------------------------------

class _Jitted:
    """A JAX module whose op functions run jitted (configs, protocols
    and int scopes static), so each op compiles once for the whole file
    instead of dispatching primitive by primitive."""

    def __init__(self, mod, n_static):
        self._mod, self._n, self._cache = mod, n_static, {}

    def __getattr__(self, name):
        f = getattr(self._mod, name)
        if not callable(f) or isinstance(f, type) or name.startswith("get_"):
            return f

        def call(*args, scope=JO.LOCAL):
            key = (name, isinstance(scope, int))
            if key not in self._cache:
                self._cache[key] = jax.jit(
                    f, static_argnums=tuple(range(self._n)),
                    static_argnames=("scope",)
                    if key[1] and self._mod is JO else ())
            kw = {"scope": scope} if self._mod is JO else {}
            return self._cache[key](*args, **kw)
        return call


CFG_KW = dict(n_caches=4, n_words=256)
JAX = types.SimpleNamespace(P=_Jitted(JP, 1), O=None,
                            cfg=JP.ProtoConfig(**CFG_KW), arr=jnp.asarray)
JAX.O = types.SimpleNamespace(
    LOCAL=JO.LOCAL, REMOTE=JO.REMOTE, GLOBAL=JO.GLOBAL,
    acquire=getattr(_Jitted(JO, 2), "acquire"),
    release=getattr(_Jitted(JO, 2), "release"),
    load=getattr(_Jitted(JO, 1), "load"),
    store=getattr(_Jitted(JO, 1), "store"))
PORT = types.SimpleNamespace(P=TP, O=TO, cfg=TP.ProtoConfig(**CFG_KW),
                             arr=torch.as_tensor)
LOCK, DATA = 64, 5


def _hot(k, cid):
    return k.arr(np.arange(4) == cid)


def _fill(k, v):
    return k.arr(np.full(4, v, np.int32))


def _seeded(k, st):
    """tests/test_ops.py `_seed_store`: LR, PA and dirty data in play."""
    P, cfg = k.P, k.cfg
    st, _ = P.store_word(cfg, st, 0, 17, 41)
    st, _ = P.store_word(cfg, st, 1, 49, 43)
    st = P.local_release(cfg, st, 0, 16, 7)
    st = P.local_release(cfg, st, 1, 48, 9)
    st, _ = P.store_word(cfg, st, 2, 130, 45)
    st = P.srsp_remote_release(cfg, st, 3, 64, 5)
    return st, []


def _srsp_propagates(k, st):
    P, cfg = k.P, k.cfg
    st, _ = P.store_word(cfg, st, 0, DATA, 42)
    st = P.local_release(cfg, st, 0, LOCK, 0)
    st, old = P.srsp_remote_acquire(cfg, st, 1, LOCK, 0, 1)
    st, v = P.load(cfg, st, 1, DATA)
    return st, [old, v]


def _stale_without_promotion(k, st):
    P, cfg = k.P, k.cfg
    st, v0 = P.load(cfg, st, 1, DATA)
    st, _ = P.store_word(cfg, st, 0, DATA, 42)
    st = P.local_release(cfg, st, 0, LOCK, 0)
    st, _ = P.local_acquire(cfg, st, 1, LOCK, 0, 1)
    st, v = P.load(cfg, st, 1, DATA)
    return st, [v0, v]


def _pa_promotes(k, st):
    P, cfg = k.P, k.cfg
    st = P.local_release(cfg, st, 0, LOCK, 0)
    st, _ = P.srsp_remote_acquire(cfg, st, 1, LOCK, 0, 1)
    st = P.srsp_remote_release(cfg, st, 1, LOCK, 0)
    st, old = P.local_acquire(cfg, st, 0, LOCK, 0, 1)
    st, other = P.local_acquire(cfg, st, 2, 128, 0, 1)
    return st, [old, other]


def _rsp_round(k, st):
    P, cfg = k.P, k.cfg
    st, _ = P.store_word(cfg, st, 0, DATA, 7)
    st = P.local_release(cfg, st, 0, LOCK, 0)
    st, old = P.rsp_remote_acquire(cfg, st, 1, LOCK, 0, 1)
    st = P.rsp_remote_release(cfg, st, 1, LOCK, 0)
    return st, [old]


def _same_cu(k, st):
    P, cfg = k.P, k.cfg
    st, _ = P.store_word(cfg, st, 0, DATA, 9)
    st = P.local_release(cfg, st, 0, LOCK, 0)
    st, old = P.srsp_remote_acquire(cfg, st, 0, LOCK, 0, 1)
    return st, [old]


def _global_and_writeback(k, st):
    P, cfg = k.P, k.cfg
    st, _ = P.store_word(cfg, st, 2, 33, 5)
    st, did = P.writeback_block(cfg, st, 2, 2)
    st, _ = P.store_word(cfg, st, 3, 34, 6)
    st = P.global_release(cfg, st, 3, LOCK, 1)
    st, old = P.global_acquire(cfg, st, 1, LOCK, 1, 2)
    st = P.invalidate_cache(cfg, st, 0)
    return st, [did, old]


def _scoped_dispatch(pname):
    """tests/test_ops.py: one-hot ops.acquire/release at every scope."""
    def run(k, st):
        proto = k.P.get_protocol(pname)
        out = []
        for scope in (k.O.LOCAL, k.O.REMOTE, k.O.GLOBAL):
            st, old = k.O.acquire(proto, k.cfg, st, _hot(k, 2), _fill(k, 16),
                                  0, 1, scope=scope)
            st = k.O.release(proto, k.cfg, st, _hot(k, 2), _fill(k, 16), 0,
                             scope=scope)
            out.append(old)
        st, v = k.O.load(k.cfg, st, _hot(k, 1), _fill(k, 17))
        st, pos = k.O.store(k.cfg, st, _hot(k, 1), _fill(k, 17), _fill(k, 3))
        return st, out + [v, pos]
    return run


def _mixed_scope(k, st):
    proto = k.P.get_protocol("srsp")
    addrs = k.arr(np.array([16, 96, 48, 128], np.int32))
    scope = k.arr(np.array([0, 0, 1, 2], np.int32))
    st, old = k.O.acquire(proto, k.cfg, st, k.arr(np.ones(4, bool)), addrs,
                          0, 1, scope=scope)
    st = k.O.release(proto, k.cfg, st, k.arr(np.ones(4, bool)), addrs, 0,
                     scope=scope)
    return st, [old]


def _disjoint_remote_batch(pname):
    def run(k, st):
        proto = k.P.get_protocol(pname)
        acq, rel = proto.acquire_rem_b, proto.release_rem_b
        if k is JAX:
            acq, rel = (jax.jit(f, static_argnums=0) for f in (acq, rel))
        active = k.arr(np.array([False, False, True, True]))
        addrs = k.arr(np.array([0, 0, 16, 48], np.int32))
        st, old = acq(k.cfg, st, active, addrs, _fill(k, 0), _fill(k, 1))
        st = rel(k.cfg, st, active, addrs,
                 k.arr(np.array([0, 0, 11, 13], np.int32)))
        return st, [old]
    return run


SCENARIOS = {
    "srsp_propagates": _srsp_propagates,
    "stale_without_promotion": _stale_without_promotion,
    "pa_promotes": _pa_promotes,
    "rsp_round": _rsp_round,
    "same_cu": _same_cu,
    "global_and_writeback": _global_and_writeback,
    "mixed_scope": _mixed_scope,
    **{f"scoped_{p}": _scoped_dispatch(p)
       for p in ("srsp", "rsp", "global", "local")},
    **{f"remote_batch_{p}": _disjoint_remote_batch(p)
       for p in ("srsp", "global")},
}


def _both(scenario, seeded):
    """Run `scenario` through both packages from one carried-over store."""
    jst = JP.make_store(JAX.cfg)
    if seeded:
        jst, _ = _seeded(JAX, jst)
    tst = convert.from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    jst, jout = scenario(JAX, jst)
    tst, tout = scenario(PORT, tst)
    _same_tree(tst, jst, "store")
    for k, (a, b) in enumerate(zip(tout, jout)):
        _same(a, b, ("result", k))
    return tst, tout


def test_make_store_matches_jax():
    _same_tree(TP.make_store(PORT.cfg, "cpu"), JP.make_store(JAX.cfg))
    tst, _ = _seeded(PORT, TP.make_store(PORT.cfg, "cpu"))
    jst, _ = _seeded(JAX, JP.make_store(JAX.cfg))
    _same_tree(tst, jst)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("seeded", [False, True])
def test_protocol_scenario_matches_jax(name, seeded):
    _both(SCENARIOS[name], seeded)


@pytest.mark.parametrize("seed", range(3))
def test_random_op_soup_matches_jax(seed):
    """tests/test_protocol.py's op soup from a numpy seed; afterwards
    every dirty word's block is in its cache's sFIFO."""
    rng = np.random.default_rng(seed)
    script = [(int(c), int(op), int(a)) for c, op, a in
              zip(rng.integers(0, 4, 30), rng.integers(0, 5, 30),
                  rng.integers(0, 16, 30))]

    def soup(k, st):
        P, cfg = k.P, k.cfg
        for cid, op, a in script:
            addr = a * 16 + 3
            if op == 0:
                st, _ = P.store_word(cfg, st, cid, addr, a)
            elif op == 1:
                st, _ = P.load(cfg, st, cid, addr)
            elif op == 2:
                st = P.local_release(cfg, st, cid, addr, 1)
            elif op == 3:
                st, _ = P.local_acquire(cfg, st, cid, addr, 0, 1)
            else:
                st, _ = P.srsp_remote_acquire(cfg, st, cid, addr, 0, 1)
        return st, []

    tst, _ = _both(soup, False)
    dirty = TP.wdirty_bool(tst).numpy().any(axis=-1)
    for c in range(4):
        fifo = set(tst.fifo.addrs[c].tolist()) - {-1}
        assert set(np.nonzero(dirty[c])[0].tolist()) <= fifo


def test_quickstart():
    """examples/quickstart.py's protocol part, in the port: stolen value
    42 and exactly one promotion."""
    cfg = TP.ProtoConfig(n_caches=8, n_words=512)
    st = TP.make_store(cfg, "cpu")
    st, _ = TP.store_word(cfg, st, 0, DATA, 42)
    st = TP.local_release(cfg, st, 0, LOCK, 0)
    st, _ = TP.srsp_remote_acquire(cfg, st, 5, LOCK, 0, 1)
    st, val = TP.load(cfg, st, 5, DATA)
    assert int(val) == 42
    st = TP.srsp_remote_release(cfg, st, 5, LOCK, 0)
    st, _ = TP.local_acquire(cfg, st, 0, LOCK, 0, 1)
    assert float(st.counters.promotions) == 1.0


def test_unknown_names_raise_with_registered_list():
    from repro_torch.workloads import harness
    with pytest.raises(KeyError, match="registered.*srsp"):
        TP.get_protocol("nope")
    with pytest.raises(ValueError, match="registered.*batched"):
        harness.runner("nope")
    with pytest.raises(ValueError, match="unknown scope"):
        TO.acquire(TP.SRSP, PORT.cfg, TP.make_store(PORT.cfg, "cpu"),
                   _hot(PORT, 0), _fill(PORT, 0), 0, 1, scope=7)
    assert set(harness.engines()) == {"serial", "batched", "fused",
                                      "serial_elastic", "batched_elastic"}
    assert TP.SRSP.remote_batchable and not TP.RSP.remote_batchable


def test_entry_points_need_a_device_or_cpu():
    """Without a GPU an entry point raises unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.make_store(PORT.cfg)
