"""The bool metadata layout (`REPRO_NO_PACK=1`) in the port.

The port reads the layout once at import into `protocol.PACKED`, as the
JAX package does, and every layout-aware helper takes its branch from
the plane's dtype, so these tests build bool stores in-process by
setting `protocol.PACKED` to False.  At n=8:

* every registered workload under srsp, bool planes in the port
  against the JAX package's packed run (kv_serving replays the JAX
  trace; worksteal's enqueue scatter takes `plane_scatter_set`'s bool
  branch): every leaf but the
  planes bit for bit, the planes equal to JAX's `wvalid_bool` /
  `wdirty_bool` views, and the same counters, `events` and check;
* `drain_writeback` under a bool mask against the JAX package's
  `drain_writeback_pallas(..., interpret=True)`, which runs its
  `_writeback_kernel` body, on the on-card case shapes;
* `plane_commit` on bool planes against the JAX package's reference;
* slow: the JAX package itself under REPRO_NO_PACK=1 in a subprocess
  gives the port's bool planes.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import workloads as jworkloads  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.kernels.fused_turn.ref import plane_commit_ref  # noqa: E402
from repro.kernels.selective_flush.kernel import (  # noqa: E402
    drain_writeback_pallas)
from repro.traffic import trace as JT  # noqa: E402
from repro.workloads import harness as jharness  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.core import bitmask  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.fused_turn import ops as FT  # noqa: E402
from repro_torch.kernels.selective_flush import ops as SF  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import harness, kv_serving  # noqa: E402

torch.use_deterministic_algorithms(True)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, SEED = 8, 3
NAMES = ["kv_directory", "reader_lock", "producer_consumer",
         "producer_consumer_mc", "worksteal", "kv_serving"]


@pytest.fixture
def bool_layout(monkeypatch):
    monkeypatch.setattr(P, "PACKED", False)


def _bool_run(name, engine="fused", jb=None):
    b = workloads.get(name).build("srsp", N, seed=SEED, device="cpu")
    if name == "kv_serving":       # replay the JAX bench's trace
        cfg = jb.wl.cfg
        jt = JT.generate(cfg.traffic, N, cfg.n_pages, SEED)
        b = kv_serving.with_trace(b, TR.RequestTrace(
            *(torch.from_numpy(np.array(c)) for c in jt)))
    assert b.state.store.wvalid.dtype == torch.bool
    final = harness.runner(engine)(b.wl, b.state, *b.ops)
    return final, b.check(final)


def test_layout_follows_packed(bool_layout):
    cfg = P.ProtoConfig(n_caches=4, n_words=100)
    assert cfg.meta_lanes == cfg.block_words == 16
    st = P.make_store(cfg, "cpu")
    assert st.wvalid.shape == st.wdirty.shape == (4, 7, 16)
    assert st.wvalid.dtype == st.wdirty.dtype == torch.bool
    assert P.wvalid_bool(st) is st.wvalid


@pytest.mark.parametrize("name", NAMES)
def test_bool_layout_gives_the_packed_results(bool_layout, name):
    """Port bool planes == JAX packed planes seen as bool; every other
    leaf bit for bit.  producer_consumer_mc and kv_serving co-schedule
    remote turns, whose PA-TBL differs from the serial run's (DESIGN.md
    §9): their JAX run is the fused engine, as the port's."""
    jengine = ("fused" if name in ("producer_consumer_mc", "kv_serving")
               else "serial")
    jb = jworkloads.get(name).build("srsp", N, seed=SEED)
    assert jb.state.store.wvalid.dtype == jnp.uint32
    jfinal = jharness.runner(jengine)(jb.wl, jb.state, *jb.ops)
    jcheck = jb.check(jfinal)
    tfinal, tcheck = _bool_run(name, jb=jb)
    assert tcheck == jcheck and tcheck["ok"]
    assert harness.counters_dict(tfinal.store) \
        == jharness.counters_dict(jfinal.store)
    st, jst = tfinal.store, jfinal.store
    assert st.wvalid.dtype == st.wdirty.dtype == torch.bool
    np.testing.assert_array_equal(st.wvalid.numpy(),
                                  np.asarray(JP.wvalid_bool(jst)))
    np.testing.assert_array_equal(st.wdirty.numpy(),
                                  np.asarray(JP.wdirty_bool(jst)))
    planes = (st.wvalid, st.wdirty)
    a = [x for x in convert.leaves(tfinal)
         if not any(x is p for p in planes)]
    b = [y for y in jax.tree.leaves(jfinal)
         if not any(y is p for p in (jst.wvalid, jst.wdirty))]
    assert len(a) == len(b) == len(jax.tree.leaves(jfinal)) - 2
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=str((name, k)))
    jax.clear_caches()


def test_bool_layout_engines_agree(bool_layout):
    """kv_directory in the bool layout: serial, batched and fused end in
    the same state, as in the packed one."""
    fused, _ = _bool_run("kv_directory")
    for engine in ("serial", "batched"):
        other, check = _bool_run("kv_directory", engine)
        assert check["ok"]
        for x, y in zip(convert.leaves(other), convert.leaves(fused)):
            assert torch.equal(x, y), engine


# the on-card case list, with bool masks; the seed is the case's index
@pytest.mark.parametrize("k", range(len(C.DRAIN_CASES)),
                         ids=[c[0] for c in C.DRAIN_CASES])
def test_drain_writeback_bool_matches_pallas(k):
    l2, rows, dirty, idx = C.dw_inputs(k, **C.DRAIN_CASES[k][1],
                                       bool_mask=True)
    assert dirty.dtype == bool and dirty.shape == rows.shape
    want = drain_writeback_pallas(jnp.asarray(l2), jnp.asarray(rows),
                                  jnp.asarray(dirty), jnp.asarray(idx),
                                  interpret=True)
    before = SF.drain_writeback_bool.launches
    got = SF.drain_writeback(*(C.to_torch(x) for x in (l2, rows, dirty,
                                                       idx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert SF.drain_writeback_bool.launches == before   # CPU: plain version


@pytest.mark.parametrize("k", [0, 3, 4])
def test_bool_and_packed_masks_merge_alike(k):
    """The same mask as bool flags and as packed lanes: the same bank."""
    packed = [C.to_torch(x) for x in C.dw_inputs(k, **C.DRAIN_CASES[k][1])]
    flags = [C.to_torch(x) for x in C.dw_inputs(k, **C.DRAIN_CASES[k][1],
                                                bool_mask=True)]
    assert torch.equal(flags[2], bitmask.unpack(packed[2],
                                                flags[0].shape[1]))
    assert torch.equal(SF.drain_writeback_ref(*packed),
                       SF.drain_writeback_ref(*flags))


def test_drain_writeback_bool_takes_bool_masks_only():
    l2, rows, dirty, idx = (C.to_torch(x) for x in C.dw_inputs(
        0, 8, 16, 4))
    with pytest.raises(ValueError, match="bool mask"):
        SF.drain_writeback_bool(l2, rows, dirty, idx)


@pytest.mark.parametrize("set_dirty", [True, False])
def test_plane_commit_bool_matches_jax(set_dirty):
    wv, wd, b, o, sv, sd = C.pc_inputs(5, n=16, nb=8, w=16)
    wv, wd = C.unpack_bits(wv, 16), C.unpack_bits(wd, 16)
    want = plane_commit_ref(jnp.asarray(wv), jnp.asarray(wd),
                            jnp.asarray(b), jnp.asarray(o), jnp.asarray(sv),
                            jnp.asarray(sd) if set_dirty else None)
    got = FT.plane_commit(*(torch.from_numpy(x) for x in (wv, wd, b, o, sv)),
                          torch.from_numpy(sd) if set_dirty else None)
    for x, y in zip(got, want):
        assert x.dtype == torch.bool
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert FT.plane_commit.launches == 0


_JAX_NO_PACK = """
import json, numpy as np
from repro import workloads
from repro.core import protocol as P
from repro.workloads import harness
assert not P.PACKED
b = workloads.get("kv_directory").build("srsp", 8, seed=3)
f = harness.run_fused(b.wl, b.state)
print(json.dumps({"counters": harness.counters_dict(f.store),
                  "check": b.check(f),
                  "dtype": str(f.store.wvalid.dtype),
                  "wvalid": np.asarray(f.store.wvalid).tolist(),
                  "wdirty": np.asarray(f.store.wdirty).tolist()}))
"""


@pytest.mark.slow
def test_jax_reference_under_no_pack_gives_the_port_bool_planes(bool_layout):
    env = dict(os.environ, REPRO_NO_PACK="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_NO_PACK], env=env,
                         capture_output=True, text=True, check=True)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["dtype"] == "bool"
    final, check = _bool_run("kv_directory")
    assert harness.counters_dict(final.store) == ref["counters"]
    assert check == ref["check"]
    assert final.store.wvalid.tolist() == ref["wvalid"]
    assert final.store.wdirty.tolist() == ref["wdirty"]
