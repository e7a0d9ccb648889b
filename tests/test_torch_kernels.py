"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version (dispatch is
by the tensor's device), and the JAX side runs the Pallas kernel in
interpret mode, as tests/test_kernels.py does.  Inputs are made from a
numpy seed and fed to both.  Comparisons are bitwise; planes are compared
through `.view(np.uint32)`.
Inputs come from the generators of `repro_torch.kernels.cases`, which
also make the on-card cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_turn.kernel import (  # noqa: E402
    plane_commit_pallas, trip_plan_pallas)
from repro.kernels.fused_turn.ref import BIG, plane_commit_ref  # noqa: E402
from repro.kernels.selective_flush.kernel import (  # noqa: E402
    drain_writeback_pallas)
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.cases import (dw_inputs, pc_inputs,  # noqa: E402
                                       plan_inputs)
from repro_torch.kernels.cases import to_torch as _t  # noqa: E402
from repro_torch.kernels.fused_turn import ops as FT  # noqa: E402
from repro_torch.kernels.selective_flush import ops as SF  # noqa: E402

torch.use_deterministic_algorithms(True)


# --------------------------------------------------------------------------
# drain_writeback
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nb,w,m,dup,pad,oor", [
    (128, 16, 64, False, True, False),    # b_writeback shape at n=64
    (128, 16, 1024, True, True, False),   # b_drain shape at n=64
    (32, 64, 48, True, True, True),       # two lanes, dirty bit 31
    (16, 40, 40, True, False, True),      # ragged second lane
    (8, 16, 1, False, False, False),      # one entry
])
def test_drain_writeback_matches_pallas(nb, w, m, dup, pad, oor):
    l2, rows, dirty, idx = dw_inputs(nb * 7 + m, nb, w, m, dup=dup,
                                     pad=pad, oor=oor)
    want = drain_writeback_pallas(jnp.asarray(l2), jnp.asarray(rows),
                                  jnp.asarray(dirty), jnp.asarray(idx),
                                  interpret=True)
    got = SF.drain_writeback(_t(l2), _t(rows), _t(dirty), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert SF.drain_writeback.launches == 0   # CPU tensors: plain version


# the on-card cases whose bank spans many of the kernel's row tiles; the
# seed is the case's index in DRAIN_CASES, as on the card
TILE_CASES = [k for k, (_, kw) in enumerate(C.DRAIN_CASES) if "hot" in kw]


@pytest.mark.parametrize("k", TILE_CASES,
                         ids=[C.DRAIN_CASES[k][0] for k in TILE_CASES])
def test_drain_writeback_past_one_tile_matches_pallas(k):
    """Duplicates on both sides of each tile edge, pads and out-of-range
    rows: the last entry with the word dirty wins across the whole bank."""
    l2, rows, dirty, idx = dw_inputs(k, **C.DRAIN_CASES[k][1])
    assert {766, 767, 768, 769} <= set(idx.tolist())
    want = drain_writeback_pallas(jnp.asarray(l2), jnp.asarray(rows),
                                  jnp.asarray(dirty), jnp.asarray(idx),
                                  interpret=True)
    got = SF.drain_writeback(_t(l2), _t(rows), _t(dirty), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the crash-recovery drain's shape (one cache's sFIFO rows real, every
# other cache's out of range); the seed is the case's index, as on the card
RECOVERY_CASES = [k for k, (_, kw) in enumerate(C.DRAIN_CASES)
                  if "recovery" in kw]


@pytest.mark.parametrize("k", RECOVERY_CASES,
                         ids=[C.DRAIN_CASES[k][0] for k in RECOVERY_CASES])
def test_drain_writeback_recovery_drain_matches_pallas(k):
    l2, rows, dirty, idx = dw_inputs(k, **C.DRAIN_CASES[k][1])
    nb = C.DRAIN_CASES[k][1]["nb"]
    assert 0 < int((idx < nb).sum()) <= 16 and int((idx == nb).sum()) > 1000
    want = drain_writeback_pallas(jnp.asarray(l2), jnp.asarray(rows),
                                  jnp.asarray(dirty), jnp.asarray(idx),
                                  interpret=True)
    got = SF.drain_writeback(_t(l2), _t(rows), _t(dirty), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), l2)


def test_drain_writeback_bit31_last_writer_wins():
    """Word 31 dirty in both entries for one block: the later entry wins;
    word 63 dirty only in the earlier one."""
    nb, w = 4, 64
    l2 = np.zeros((nb, w), np.int32)
    rows = np.stack([np.full(w, 7, np.int32), np.full(w, 9, np.int32)])
    dirty = np.array([[1 << 31, 1 << 31], [1 << 31, 0]], np.uint32)
    idx = np.array([2, 2], np.int32)
    want = np.asarray(drain_writeback_pallas(
        jnp.asarray(l2), jnp.asarray(rows), jnp.asarray(dirty),
        jnp.asarray(idx), interpret=True))
    got = SF.drain_writeback(_t(l2), _t(rows), _t(dirty), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 31] == 9 and got[2, 63] == 7 and got[2, 0] == 0


# --------------------------------------------------------------------------
# plane_commit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,w,oor", [
    (64, 128, 16, False), (8, 4, 40, False), (6, 8, 64, False),
    (16, 4, 40, True),                    # blocks clamped, offsets off the row
])
def test_plane_commit_matches_pallas(n, nb, w, oor):
    wv, wd, b, o, sv, sd = pc_inputs(n + nb + w, n, nb, w, oor=oor)
    want = plane_commit_pallas(*(jnp.asarray(x) for x in (wv, wd, b, o,
                                                          sv, sd)),
                               interpret=True)
    got = FT.plane_commit(*(_t(x) for x in (wv, wd, b, o, sv, sd)))
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if x.dtype == np.uint32
            else g.numpy(), x)
    assert FT.plane_commit.launches == 0


# the on-card case list; the seed is the case's index, as on the card
@pytest.mark.parametrize("k", range(len(C.COMMIT_CASES)),
                         ids=[c[0] for c in C.COMMIT_CASES])
def test_plane_commit_cases_match_pallas(k):
    xs = pc_inputs(k, **C.COMMIT_CASES[k][1])
    want = plane_commit_pallas(*(jnp.asarray(x) for x in xs), interpret=True)
    got = FT.plane_commit(*(_t(x) for x in xs))
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if x.dtype == np.uint32
            else g.numpy(), x)


def test_plane_commit_load_shape_matches_reference():
    """set_dirty=None (the b_load shape): wdirty untouched, both pre-op
    bits reported, against the JAX reference it shares."""
    wv, wd, b, o, sv, _ = pc_inputs(3, 8, 4, 64)
    want = plane_commit_ref(*(jnp.asarray(x) for x in (wv, wd, b, o, sv)),
                            None)
    got = FT.plane_commit(*(_t(x) for x in (wv, wd, b, o, sv)), None)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), wd)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


# --------------------------------------------------------------------------
# trip_plan
# --------------------------------------------------------------------------

def _plan_pair(clocks, can_l, can_r, bound, raddr, horizon, remote_cap):
    want = trip_plan_pallas(*(jnp.asarray(x) for x in (clocks, can_l, can_r,
                                                       bound, raddr)),
                            BIG if horizon is None else jnp.float32(horizon),
                            remote_cap=remote_cap, interpret=True)
    hor = None if horizon is None else torch.tensor(horizon,
                                                    dtype=torch.float32)
    got = FT.trip_plan(*(_t(x) for x in (clocks, can_l, can_r, bound,
                                         raddr)),
                       hor, remote_cap=remote_cap)
    return got, want


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("remote_cap", [True, False])
@pytest.mark.parametrize("fenced", [True, False])
def test_trip_plan_matches_pallas(n, remote_cap, fenced):
    clocks, can_l, can_r, bound, raddr = plan_inputs(n, n)
    horizon = float(np.median(clocks)) if fenced else None
    got, want = _plan_pair(clocks, can_l, can_r, bound, raddr, horizon,
                           remote_cap)
    np.testing.assert_array_equal(got.lmask.numpy(), np.asarray(want.lmask))
    np.testing.assert_array_equal(got.rmask.numpy(), np.asarray(want.rmask))
    assert int(got.wg) == int(want.wg)
    assert FT.trip_plan.launches == 0


@pytest.mark.parametrize("which", ["none", "local_only", "remote_only"])
def test_trip_plan_empty_masks(which):
    """Empty candidate sets: wg falls to 0 and the masks follow the
    Pallas kernel's empty-mask convention."""
    n = 16
    clocks, _, _, bound, raddr = plan_inputs(5, n)
    on = np.ones(n, bool)
    off = np.zeros(n, bool)
    can_l, can_r = {"none": (off, off), "local_only": (on, off),
                    "remote_only": (off, on)}[which]
    got, want = _plan_pair(clocks, can_l, can_r, bound, raddr, None, True)
    np.testing.assert_array_equal(got.lmask.numpy(), np.asarray(want.lmask))
    np.testing.assert_array_equal(got.rmask.numpy(), np.asarray(want.rmask))
    assert int(got.wg) == int(want.wg)


def test_trip_plan_serial_fallback_is_one_hot():
    """Batch emptied by the horizon; the first-argmin lane has a local
    turn, so lmask is exactly its one-hot."""
    clocks = np.array([5.0, 2.0, 7.0, 2.0], np.float32)
    can_l = np.ones(4, bool)
    can_r = np.array([False, False, True, False])
    got, want = _plan_pair(clocks, can_l, can_r, np.ones(4, np.float32),
                           np.zeros(4, np.int32), 0.0, False)
    np.testing.assert_array_equal(got.lmask.numpy(), np.asarray(want.lmask))
    assert int(got.wg) == int(want.wg) == 1
    assert got.lmask.numpy().tolist() == [False, True, False, False]


# the on-card cases with clocks tied at the minimum (+0.0 and -0.0, or all
# equal) at one warp and just past it; the seed is the index in PLAN_CASES
TIE_CASES = [k for k, c in enumerate(C.PLAN_CASES) if "ties" in c[1]]


@pytest.mark.parametrize("k", TIE_CASES,
                         ids=[C.PLAN_CASES[k][0] for k in TIE_CASES])
def test_trip_plan_ties_match_pallas(k):
    """-0.0 == +0.0 as floats: the first index holding the minimum wins
    whatever its sign, as in the Pallas kernel's float compares."""
    _, kw, remote_cap, fenced = C.PLAN_CASES[k]
    clocks, can_l, can_r, bound, raddr = plan_inputs(k, **kw)
    if kw["ties"] == "signed_zero":
        assert np.signbit(clocks[clocks == 0]).any()
    got, want = _plan_pair(clocks, can_l, can_r, bound, raddr,
                           C.horizon(clocks, fenced), remote_cap)
    np.testing.assert_array_equal(got.lmask.numpy(), np.asarray(want.lmask))
    np.testing.assert_array_equal(got.rmask.numpy(), np.asarray(want.rmask))
    assert int(got.wg) == int(want.wg)
