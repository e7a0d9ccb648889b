"""The port's hand-written CUDA kernels against their plain versions.

These tests need a CUDA device and skip without one; they import no JAX,
so they also run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports JAX).  The cases are
the lists of `repro_torch.kernels.cases`, which `chip_smoke.py` runs too.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.distributed import delta_sync as DS  # noqa: E402
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_decode import ops as FD  # noqa: E402
from repro_torch.kernels.fused_turn import ops as FT  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as RN  # noqa: E402
from repro_torch.kernels.selective_flush import ops as SF  # noqa: E402
from repro_torch.kernels import timing  # noqa: E402
from repro_torch.kernels.topk_router import ops as TR  # noqa: E402
from repro_torch.workloads import sweep  # noqa: E402

GOLDEN = pathlib.Path(P.__file__).resolve().parents[1] / "golden"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ids(cases):
    return [c[0] for c in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.DRAIN_CASES)),
                         ids=_ids(C.DRAIN_CASES))
def test_drain_writeback_kernel_on_card(cuda, k):
    args = [C.to_torch(x) for x in C.dw_inputs(k, **C.DRAIN_CASES[k][1])]
    before = SF.drain_writeback.launches
    got = SF.drain_writeback(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert SF.drain_writeback.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  SF.drain_writeback_ref(*args).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.DRAIN_CASES)),
                         ids=_ids(C.DRAIN_CASES))
def test_drain_writeback_bool_kernel_on_card(cuda, k):
    """The REPRO_NO_PACK=1 instance: the same cases under bool masks."""
    args = [C.to_torch(x) for x in C.dw_inputs(k, **C.DRAIN_CASES[k][1],
                                               bool_mask=True)]
    before = (SF.drain_writeback.launches, SF.drain_writeback_bool.launches)
    got = SF.drain_writeback(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert (SF.drain_writeback.launches,
            SF.drain_writeback_bool.launches) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  SF.drain_writeback_ref(*args).numpy())


@pytest.mark.cuda
def test_bool_layout_kv_directory_cell_on_card(cuda, monkeypatch):
    """kv_directory srsp n=64 seed 4 in the bool layout equals the packed
    golden cell, through the bool drain kernel."""
    monkeypatch.setattr(P, "PACKED", False)
    golden = json.loads((GOLDEN / "kv_directory.json").read_text())
    want = next(c for c in golden["cells"] if (
        c["scenario"], c["n_agents"], c["seed"]) == ("srsp", 64, 4))
    before = SF.drain_writeback_bool.launches
    row = sweep.run_cell("kv_directory", "srsp", 64, 4, "fused",
                         device=cuda)
    assert SF.drain_writeback_bool.launches > before
    assert row["counters"] == want["counters"]
    assert (row["events"], row["check_ok"], row["check_fails"]) \
        == (want["events"], want["check_ok"], want["check_fails"])


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.COMMIT_CASES)),
                         ids=_ids(C.COMMIT_CASES))
def test_plane_commit_kernel_on_card(cuda, k):
    args = [C.to_torch(x) for x in C.pc_inputs(k, **C.COMMIT_CASES[k][1])]
    before = FT.plane_commit.launches
    got = FT.plane_commit(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert FT.plane_commit.launches == before + 1
    for g, x in zip(got, FT.plane_commit_ref(*args)):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


def _commit_returns_fresh_planes(device):
    """plane_commit on the n=64 case: no output shares storage with an
    input, and the inputs are left as they were."""
    xs = C.pc_inputs(0, **C.COMMIT_CASES[0][1])
    args = [C.to_torch(x).to(device) for x in xs]
    got = FT.plane_commit(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    inputs = {a.untyped_storage().data_ptr() for a in args}
    assert not {g.untyped_storage().data_ptr() for g in got} & inputs
    for a, x in zip(args, xs):
        np.testing.assert_array_equal(a.cpu().numpy(), C.to_torch(x).numpy())
    for g, x in zip(got, FT.plane_commit_ref(*(C.to_torch(x) for x in xs))):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


@pytest.mark.cuda
def test_plane_commit_returns_fresh_planes_on_card(cuda):
    before = FT.plane_commit.launches
    _commit_returns_fresh_planes(cuda)
    assert FT.plane_commit.launches == before + 1


def test_plane_commit_returns_fresh_planes_on_cpu():
    """The CPU twin: the plain version, no launch."""
    before = FT.plane_commit.launches
    _commit_returns_fresh_planes(torch.device("cpu"))
    assert FT.plane_commit.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.PLAN_CASES)),
                         ids=_ids(C.PLAN_CASES))
def test_trip_plan_kernel_on_card(cuda, k):
    _, kw, remote_cap, fenced = C.PLAN_CASES[k]
    args = [C.to_torch(x) for x in C.plan_inputs(k, **kw)]
    hor = C.horizon(args[0].numpy(), fenced)
    before = FT.trip_plan.launches
    got = FT.trip_plan(*(a.to(cuda) for a in args), hor,
                       remote_cap=remote_cap)
    torch.cuda.synchronize()
    assert FT.trip_plan.launches == before + 1
    want = FT.trip_plan(*args, None if hor is None else torch.tensor(hor),
                        remote_cap=remote_cap)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


@pytest.mark.cuda
def test_trip_plan_kernel_refuses_more_than_1024_lanes(cuda):
    args = [C.to_torch(x).to(cuda) for x in C.plan_inputs(1, 1025)]
    with pytest.raises(ValueError, match="1..1024"):
        FT.trip_plan(*args, None, remote_cap=False)


# the simulator's kernels at n agents, the serving ones at their shapes
ONE_OP_CALLS = [(name, n) for name in sorted(timing.ONE_OP)
                for n in (timing.SERVE_SHAPES if name in timing.SERVE_KERNELS
                          else (16, 64, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", ONE_OP_CALLS,
                         ids=[f"{name}-{n}" for name, n in ONE_OP_CALLS])
def test_one_call_is_one_device_operation(cuda, name, n):
    """Under torch.profiler one wrapper call at the kv_directory shapes of
    n agents, or at a serving kernel's decode or prefill shape, is one
    kernel record: no memset, no fill, no copy."""
    calls = (timing.serve_calls(C, RN, TR, cuda) if isinstance(n, str)
             else timing.sim_calls(C, SF, FT, n, cuda))
    call = next(c for c in calls if c["name"] == name
                and (not isinstance(n, str) or f"({n})" in c["shape"]))
    call["fn"]()                          # build and load outside the trace
    ops = timing.device_ops(call["fn"])
    assert sum(ops.values()) == 1, ops
    assert timing.ONE_OP[name] in next(iter(ops)), ops


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 33, 64, 256])
def test_trip_plan_without_remote_cap_never_reads_raddr(cuda, n):
    """With remote_cap=False the kernel gets a null raddr: a read would
    fault.  The plan equals its plain version's."""
    args = [C.to_torch(x) for x in C.plan_inputs(n, n)]
    got = FT.trip_plan(*(a.to(cuda) for a in args[:4]), None, None,
                       remote_cap=False)
    torch.cuda.synchronize()
    want = FT.trip_plan_ref(*args[:4], None, None)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 33, 256])
def test_simulator_kernel_outputs_keep_dtypes_and_shapes(cuda, n):
    """TripPlan is [n] bool, [n] bool and a 0-d int32 (views of one
    buffer); drain_writeback returns a fresh [nb, W] int32 bank."""
    args = [C.to_torch(x).to(cuda) for x in C.plan_inputs(n, n)]
    plan = FT.trip_plan(*args, None, remote_cap=True)
    for mask in (plan.lmask, plan.rmask):
        assert mask.dtype == torch.bool and mask.shape == (n,)
    assert plan.wg.dtype == torch.int32 and plan.wg.shape == ()
    nb, w, m = 2 * n, 16, 16 * n
    l2, rows, dirty, idx = (C.to_torch(x).to(cuda)
                            for x in C.dw_inputs(n, nb, w, m))
    out = SF.drain_writeback(l2, rows, dirty, idx)
    assert out.dtype == torch.int32 and out.shape == (nb, w)
    assert out.data_ptr() != l2.data_ptr()


@pytest.mark.cuda
def test_simulator_kernels_are_bitwise_repeatable(cuda):
    """The same inputs give the same bits call after call, whatever order
    the owner map's atomics land in."""
    k = next(i for i, (_, kw) in enumerate(C.DRAIN_CASES) if "hot" in kw)
    dw = [C.to_torch(x).to(cuda)
          for x in C.dw_inputs(k, **C.DRAIN_CASES[k][1])]
    first = SF.drain_writeback(*dw).cpu().numpy()
    j = next(i for i, c in enumerate(C.PLAN_CASES) if "ties" in c[1])
    tp = [C.to_torch(x).to(cuda)
          for x in C.plan_inputs(j, **C.PLAN_CASES[j][1])]
    plan0 = [t.cpu().numpy() for t in FT.trip_plan(*tp, None,
                                                   remote_cap=True)]
    for _ in range(5):
        np.testing.assert_array_equal(SF.drain_writeback(*dw).cpu().numpy(),
                                      first)
        for g, x in zip(FT.trip_plan(*tp, None, remote_cap=True), plan0):
            np.testing.assert_array_equal(g.cpu().numpy(), x)


@pytest.mark.cuda
def test_drain_writeback_refuses_rows_wider_than_its_tile(cuda):
    w = SF.MAX_WRITEBACK_WORDS + 1
    args = [C.to_torch(x).to(cuda) for x in C.dw_inputs(0, 2, w, 3)]
    with pytest.raises(ValueError, match="W <="):
        SF.drain_writeback(*args)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.element_size() == 2
            else t.view(torch.int32)).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.FLUSH_CASES)),
                         ids=_ids(C.FLUSH_CASES))
def test_selective_flush_kernel_on_card(cuda, k):
    """Bitwise its plain version, on the card and on the CPU: the sync's
    flattened banks, all pads, indices at or above nb, bfloat16, widths
    and base pointers off 16 bytes."""
    bank, idx = C.flush_args(k, cuda)
    before = SF.selective_flush.launches
    got = SF.selective_flush(bank, idx)
    torch.cuda.synchronize()
    assert SF.selective_flush.launches == before + 1
    assert got.dtype == bank.dtype and got.shape == (idx.shape[0],
                                                     bank.shape[1])
    for want in (SF.selective_flush_ref(bank, idx),
                 SF.selective_flush_ref(bank.cpu(), idx.cpu())):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_stacked_sync_on_card_launches_the_flush(cuda):
    """The stacked 4-pod sync on the card, held to the golden file; the
    float32 selective mode launches the kernel once (one launch per sync,
    not per pod), int8 and full none."""
    bank = DS.small_bank()
    before = SF.selective_flush.launches
    DS.check_bank(bank, DS.load_golden()["banks"][0], cuda)
    assert SF.selective_flush.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.RMS_CASES)), ids=_ids(C.RMS_CASES))
def test_rmsnorm_kernel_on_card(cuda, k):
    """Within `C.TOL` of the output's type (cases.py states why)."""
    C.check_float(RN.rmsnorm, RN.rmsnorm_ref, *C.float_args("rmsnorm", k),
                  cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.RMS_VIEW_CASES)),
                         ids=_ids(C.RMS_VIEW_CASES))
def test_rmsnorm_kernel_on_views_off_16_bytes(cuda, k):
    """x or w a contiguous view whose base is off 16 bytes: the kernel's
    scalar instance, within `C.TOL` of the plain version."""
    C.check_float(RN.rmsnorm, RN.rmsnorm_ref, *C.rms_view_args(k, cuda),
                  cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.ATTN_CASES)),
                         ids=_ids(C.ATTN_CASES))
def test_flash_attention_kernel_on_card(cuda, k):
    C.check_float(FA.flash_attention, FA.flash_attention_ref,
                  *C.float_args("flash_attention", k), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.DECODE_CASES)),
                         ids=_ids(C.DECODE_CASES))
def test_flash_decode_kernel_on_card(cuda, k):
    C.check_float(FD.flash_decode, FD.flash_decode_ref,
                  *C.float_args("flash_decode", k), cuda)


# bf16 at granite's width (the wgmma kernel) at the edges of its 64-row
# tiles and at a long prompt, B=2; and bf16 at the SMOKE width D=16 (the
# CUDA-core kernel)
ATTN_SHAPES = ([dict(b=2, hq=16, hkv=8, s=s, d=64)
                for s in (1, 15, 16, 63, 64, 65, 256, 1024)]
               + [dict(b=2, hq=4, hkv=2, s=33, d=16)])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", ATTN_SHAPES,
                         ids=[f"S={kw['s']} D={kw['d']}" for kw in ATTN_SHAPES])
def test_flash_attention_bf16_kernel_on_card(cuda, kw):
    """Within `C.TOL["bfloat16"]` of its plain version (the kernel rounds
    p to bf16 before P.V; the source note bounds what that adds)."""
    xs = C.attn_inputs(100 + kw["s"], **kw)
    C.check_float(FA.flash_attention, FA.flash_attention_ref,
                  [C.to_dtype(x, "bfloat16") for x in xs], "bfloat16", cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 272])
def test_flash_decode_row_is_independent_of_the_batch(cuda, dt, n):
    """Every row of a B=4 batch (row 2 at kv_len n, the others at random
    lengths) is bitwise the same row run alone (B=1): the output depends
    on nothing but the row's own (q, k, v, kv_len)."""
    q, k, v, lens = C.decode_inputs(40 + n, 4, 16, 8, 512, 64)
    lens[2] = n
    args = [C.to_dtype(x, dt).to(cuda) for x in (q, k, v)]
    kv_len = torch.from_numpy(lens).to(cuda)
    got = FD.flash_decode(*args, kv_len)
    for i in range(4):
        alone = FD.flash_decode(*(a[i:i + 1] for a in args),
                                kv_len[i:i + 1])
        np.testing.assert_array_equal(_bits(got[i:i + 1]), _bits(alone))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_kernels_are_bitwise_deterministic(cuda, dt):
    """The same inputs give the same bits from run to run: both kernels
    sum in a fixed order and use no float atomics."""
    xs = [C.to_dtype(x, dt).to(cuda)
          for x in C.attn_inputs(5, 2, 16, 8, 256, 64)]
    first = FA.flash_attention(*xs)
    for _ in range(3):
        np.testing.assert_array_equal(_bits(first),
                                      _bits(FA.flash_attention(*xs)))
    q, k, v, lens = C.decode_inputs(6, 4, 16, 8, 512, 64)
    args = ([C.to_dtype(x, dt).to(cuda) for x in (q, k, v)]
            + [torch.from_numpy(lens).to(cuda)])
    first = FD.flash_decode(*args)
    for _ in range(3):
        np.testing.assert_array_equal(_bits(first),
                                      _bits(FD.flash_decode(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 20001])
def test_flash_decode_long_cache_on_card(cuda, n):
    """A 32,768-position cache, past the 29,000 or so that a whole score
    row in one CTA's shared memory allowed, against its plain version."""
    q, k, v, lens = C.decode_inputs(9, 1, 16, 8, 32768, 64, lens=(n,))
    C.check_float(FD.flash_decode, FD.flash_decode_ref,
                  [C.to_dtype(x, "bfloat16") for x in (q, k, v)]
                  + [torch.from_numpy(lens)], "bfloat16", cuda)


def test_flash_decode_shared_memory_fits_long_caches():
    """One CTA holds only its eighth of the scores: granite's group of 2
    and the widest group, 8, fit a 32,768-position cache; a cache whose
    share of scores does not fit is refused before launch."""
    for group in (2, FD.MAX_GROUP):
        assert FD.smem_bytes(group, 32768, 64) <= FD.SMEM_BYTES
    assert FD.smem_bytes(FD.MAX_GROUP, 65536, 64) > FD.SMEM_BYTES


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.ROUTER_CASES)),
                         ids=_ids(C.ROUTER_CASES))
def test_topk_router_kernel_on_card(cuda, k):
    """Weights within ROUTER_W_TOL; indices bitwise on every row whose
    order is decided (exact ties or gaps above ROUTER_MARGIN)."""
    C.check_router(TR.topk_router, TR.topk_router_ref, k, cuda)


@pytest.mark.cuda
def test_serving_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="E <= 256"):
        TR.topk_router(torch.zeros((2, 257), device=cuda), 8)
    with pytest.raises(ValueError, match=r"k <= min\(E, 32\)"):
        TR.topk_router(torch.zeros((2, 64), device=cuda), 33)
    q = torch.zeros((1, 2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        RN.rmsnorm(torch.zeros((2, 8), dtype=torch.float16, device=cuda),
                   torch.ones(8, device=cuda))
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    cache = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="group <= 8"):
        FD.flash_decode(torch.zeros((1, 18, 64), device=cuda), cache, cache,
                        lens)
    with pytest.raises(ValueError, match="power-of-two"):
        FD.flash_decode(torch.zeros((1, 4, 24), device=cuda),
                        cache[..., :24].contiguous(),
                        cache[..., :24].contiguous(), lens)
    cache = torch.zeros((1, 1, 65536, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="ceil"):
        FD.flash_decode(torch.zeros((1, 8, 64), dtype=torch.bfloat16,
                                    device=cuda), cache, cache, lens)


def test_dispatch_is_by_device():
    """CPU tensors take the plain version and launch nothing; a mix of
    devices is refused."""
    args = [C.to_torch(x) for x in C.plan_inputs(1, 8)]
    before = FT.trip_plan.launches
    FT.trip_plan(*args, None, remote_cap=True)
    assert FT.trip_plan.launches == before
    from repro_torch.kernels import common
    assert common.on_cuda(*args) is False
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="span devices"):
        common.on_cuda(args[0], meta)
