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
from repro_torch.workloads import sweep, sweep_doc  # noqa: E402

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


def _stacked(gen, case, k, **kw):
    """Case k of a replica case list as CPU tensors (`cases.stacked`)."""
    _, gkw, reps, idle = case[:4]
    return [C.to_torch(x) for x in C.stacked(gen, reps, k, idle, **gkw,
                                             **kw)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
@pytest.mark.parametrize("k", range(len(C.DRAIN_MANY_CASES)),
                         ids=_ids(C.DRAIN_MANY_CASES))
def test_drain_writeback_many_kernel_on_card(cuda, k, packed):
    """The replica instances, packed and bool: one launch merges every
    replica's bank, bitwise the plain version's."""
    args = _stacked(C.dw_inputs, C.DRAIN_MANY_CASES[k], k,
                    bool_mask=not packed)
    fn = SF.drain_writeback_many if packed else SF.drain_writeback_bool_many
    before = fn.launches
    got = SF.drain_writeback_many(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  SF.drain_writeback_ref(*args).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.COMMIT_MANY_CASES)),
                         ids=_ids(C.COMMIT_MANY_CASES))
def test_plane_commit_many_kernel_on_card(cuda, k):
    args = _stacked(C.pc_inputs, C.COMMIT_MANY_CASES[k], k)
    before = FT.plane_commit_many.launches
    got = FT.plane_commit_many(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert FT.plane_commit_many.launches == before + 1
    for g, x in zip(got, FT.plane_commit_ref(*args)):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.PLAN_MANY_CASES)),
                         ids=_ids(C.PLAN_MANY_CASES))
def test_trip_plan_many_kernel_on_card(cuda, k):
    case = C.PLAN_MANY_CASES[k]
    remote_cap, fenced = case[4:]
    args = _stacked(C.plan_inputs, case, k)
    hor = C.horizons(args[0].numpy(), fenced)
    hor = None if hor is None else torch.from_numpy(hor)
    before = FT.trip_plan_many.launches
    got = FT.trip_plan_many(*(a.to(cuda) for a in args),
                            None if hor is None else hor.to(cuda),
                            remote_cap=remote_cap)
    torch.cuda.synchronize()
    assert FT.trip_plan_many.launches == before + 1
    for g, x in zip(got, FT.trip_plan_many(*args, hor,
                                           remote_cap=remote_cap)):
        np.testing.assert_array_equal(g.cpu().numpy(), x.numpy())


REPLICA_OPS = [(name, r) for name in sorted(timing.ONE_OP)
               if name.endswith("_many") for r in timing.REPS]


@pytest.mark.cuda
@pytest.mark.parametrize("name,reps", REPLICA_OPS,
                         ids=[f"{name}-R={r}" for name, r in REPLICA_OPS])
def test_replica_call_is_one_device_operation(cuda, name, reps):
    """A replica instance's call at the n=64 shapes is one kernel record
    at every R."""
    call = next(c for c in timing.sim_calls(C, SF, FT, 64, cuda)
                if c["name"] == name and c.get("reps") == reps)
    call["fn"]()                          # build and load outside the trace
    ops = timing.device_ops(call["fn"])
    assert sum(ops.values()) == 1, ops
    assert timing.ONE_OP[name] in next(iter(ops)), ops


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


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_plane_scatter_set_on_card_matches_cpu(cuda, packed):
    """The enqueue scatter on the card: the CPU result bit for bit, in
    both layouts, out-of-range blocks dropped."""
    rng = np.random.default_rng(7)
    n, nb, w = 64, 40, 16
    flat = rng.choice(n * nb * w, size=2048, replace=False)
    lane, rest = np.divmod(flat, nb * w)
    b, o = np.divmod(rest, w)
    b[rng.random(b.size) < 0.1] = nb
    args = [torch.from_numpy(x.astype(np.int32)) for x in (lane, b, o)]
    flags = torch.from_numpy(rng.random((n, nb, w)) < 0.3)
    plane = P.bitmask.pack(flags) if packed else flags
    want = P.plane_scatter_set(plane, *args)
    got = P.plane_scatter_set(plane.to(cuda), *(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), want)


def _golden_cell(workload, scenario, n, seed, engine, traffic=None):
    golden = json.loads((GOLDEN / f"{workload}.json").read_text())
    return next(c for c in golden["cells"] if (
        c["scenario"], c["n_agents"], c["seed"], c["engine"],
        c.get("traffic")) == (scenario, n, seed, engine, traffic))


def _same_as_golden(row, want):
    assert row["counters"] == want["counters"]
    assert (row["events"], row["check_ok"], row["check_fails"]) \
        == (want["events"], want["check_ok"], want["check_fails"])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_recovery_drain_is_one_device_operation(cuda, packed):
    """The crash-recovery drain's `drain_writeback` call (n=64: one
    cache's 16 sFIFO rows real, the other 1008 out of range) is one
    kernel record, and equals its plain version."""
    k = next(i for i, (_, kw) in enumerate(C.DRAIN_CASES)
             if "recovery" in kw)
    args = [C.to_torch(x).to(cuda) for x in C.dw_inputs(
        k, **C.DRAIN_CASES[k][1], bool_mask=not packed)]
    got = SF.drain_writeback(*args)                 # build and load first
    torch.cuda.synchronize()
    assert torch.equal(got, SF.drain_writeback_ref(*args))
    ops = timing.device_ops(lambda: SF.drain_writeback(*args))
    assert sum(ops.values()) == 1, ops
    assert timing.ONE_OP["drain_writeback"] in next(iter(ops)), ops


CHURN64 = [c for c in json.loads((GOLDEN / "churn.json").read_text())
           ["cells"] if c["n_agents"] == 64]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(CHURN64)),
                         ids=[c["name"] for c in CHURN64])
def test_churn_golden_cell_on_card(cuda, k):
    """Each n=64 cell of `golden/churn.json` on the card, held with `==`,
    through the drain kernel."""
    from test_torch_churn import assert_held, run_churn_cell
    cell = CHURN64[k]
    before = SF.drain_writeback.launches
    assert_held(run_churn_cell(cell, cuda), cell)
    assert SF.drain_writeback.launches > before


@pytest.mark.cuda
def test_worksteal_cell_on_card(cuda):
    want = _golden_cell("worksteal", "srsp", 64, 2, "fused")
    before = FT.trip_plan.launches
    _same_as_golden(sweep.run_cell("worksteal", "srsp", 64, 2, "fused",
                                   device=cuda), want)
    assert FT.trip_plan.launches > before


@pytest.mark.cuda
def test_kv_serving_cell_on_card_replays_the_jax_trace(cuda):
    from repro_torch.traffic import trace as TT
    want = _golden_cell("kv_serving", "rsp", 16, 4, "fused", "default")
    tr, _ = TT.load_set(str(GOLDEN / "kv_serving_traces.npz"),
                        cuda)[want["trace"]]
    row = sweep.run_cell("kv_serving", "rsp", 16, 4, "fused", device=cuda,
                         trace=tr)
    _same_as_golden(row, want)


TRACED_ON_CARD = ["kv_directory n=16 seed=4 fused",
                  "producer_consumer_mc n=16 seed=4 fused",
                  "kv_serving n=16 seed=4 fused",
                  "kv_directory n=16 seed=4 batched_elastic leave_join"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRACED_ON_CARD)
def test_traced_cell_on_card_is_the_cpu_port(cuda, name):
    """A traced n=16 golden cell on the card: every leaf, trace included,
    `==` the CPU port's run, the trace the reference's, and each kernel
    launched as often as in the untraced run on the card."""
    from test_torch_trace_golden import (TRACE_CAP, TRACE_CELLS,
                                         held_to_golden, run_port,
                                         trace_cell_name)
    cell = next(c for c in TRACE_CELLS if trace_cell_name(c) == name)
    counters = (SF.drain_writeback, FT.plane_commit, FT.trip_plan)

    def counted(cap):
        before = [f.launches for f in counters]
        final, store, _ = run_port(cell, cap, cuda)
        torch.cuda.synchronize()
        return final, store, [f.launches - b
                              for f, b in zip(counters, before)]

    _, _, off = counted(0)
    final, store, on = counted(TRACE_CAP)
    assert on == off and on[0] > 0
    held_to_golden(store, name)
    cpu, _, _ = run_port(cell)
    from repro_torch import convert
    for a, b in zip(convert.leaves(final), convert.leaves(cpu)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


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


def _in_child(body: str, *args) -> None:
    """This file's function `body(cuda, *args)` in a child process, whose
    failure fails the test.  The replica path runs there: after a replica
    run, torch.profiler traces in the same process have come back with no
    CUDA record (PERF.md §7), and this process traces."""
    import os
    import subprocess
    import sys
    here = pathlib.Path(__file__).resolve().parent
    path = [str(GOLDEN.parents[1]), str(here),
            os.environ.get("PYTHONPATH", "")]
    out = subprocess.run(
        [sys.executable, "-c",
         f"import torch, test_torch_cuda as t; "
         f"t.{body}(torch.device('cuda'), *{args!r})"],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]


@pytest.mark.cuda
def test_vmap_launches_each_replica_instance_once(cuda):
    """Under torch.func.vmap each kernel wrapper on replica-batched CUDA
    tensors makes one replica-instance launch for all R, and each
    replica's result is its solo call's."""
    _in_child("_vmap_launches_each_replica_instance_once")


def _vmap_launches_each_replica_instance_once(cuda):
    vmap = torch.func.vmap
    dw = [a.to(cuda) for a in _stacked(C.dw_inputs, C.DRAIN_MANY_CASES[0],
                                       0)]
    pc = [a.to(cuda) for a in _stacked(C.pc_inputs, C.COMMIT_MANY_CASES[1],
                                       1)]
    tp = [a.to(cuda) for a in _stacked(C.plan_inputs, C.PLAN_MANY_CASES[7],
                                       7)]
    counts = [f.launches for f in (SF.drain_writeback_many,
                                   FT.plane_commit_many,
                                   FT.trip_plan_many)]
    got_dw = vmap(SF.drain_writeback)(*dw)
    got_pc = vmap(lambda *a: tuple(FT.plane_commit(*a)))(*pc)
    got_tp = vmap(lambda *a: tuple(FT.trip_plan(*a, None,
                                                remote_cap=True)))(*tp)
    torch.cuda.synchronize()
    assert [f.launches for f in (SF.drain_writeback_many,
                                 FT.plane_commit_many,
                                 FT.trip_plan_many)] \
        == [c + 1 for c in counts]
    for r in range(dw[0].shape[0]):
        assert torch.equal(got_dw[r], SF.drain_writeback(
            *(a[r] for a in dw)))
    for r in range(pc[0].shape[0]):
        for g, x in zip(got_pc, FT.plane_commit(*(a[r] for a in pc))):
            assert torch.equal(g[r], x)
    for r in range(tp[0].shape[0]):
        for g, x in zip(got_tp, FT.trip_plan(*(a[r] for a in tp), None,
                                             remote_cap=True)):
            assert torch.equal(g[r], x)


MANY_GOLDEN = json.loads((GOLDEN / "many.json").read_text())["cells"]
MANY_ON_CARD = [k for k, c in enumerate(MANY_GOLDEN)
                if c["workload"] == "kv_directory"
                and c["scenario"] == "srsp"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", MANY_ON_CARD,
                         ids=[f"{MANY_GOLDEN[k]['workload']}-"
                              f"{MANY_GOLDEN[k]['engine']}"
                              for k in MANY_ON_CARD])
def test_many_golden_cell_on_card(cuda, k):
    """kv_directory n=64 over seeds 4 and 5 in one replica run on the
    card, every lane held to `golden/many.json` with `==`; the fused
    engine launches `trip_plan_many` once a trip for both replicas."""
    _in_child("_many_golden_cell", k)


def _many_golden_cell(cuda, k):
    cell = MANY_GOLDEN[k]
    before = FT.trip_plan_many.launches
    row = sweep.run_vmapped_cell(cell["workload"], cell["scenario"],
                                 cell["n_agents"], cell["seeds"],
                                 cell["engine"], device=cuda, warmup=False)
    assert row["lanes"] == cell["lanes"]
    assert (FT.trip_plan_many.launches > before) \
        == (cell["engine"] == "fused")


@pytest.mark.cuda
def test_traced_replica_run_on_card(cuda):
    """kv_directory n=16 over seeds 4 and 5, traced, in one replica run on
    the card: each lane `==` the CPU port's traced solo run of its seed,
    lane 0's trace the golden one."""
    _in_child("_traced_replica_run")


def _traced_replica_run(cuda):
    from repro_torch import convert, workloads
    from repro_torch.obs import trace as TL
    from repro_torch.workloads import harness
    from test_torch_trace_golden import held_to_golden
    mod = workloads.get("kv_directory")
    seeds = (4, 5)

    def states(device):
        b = mod.build("srsp", 16, seed=4, device=device)
        return b, harness.stack([TL.with_trace(
            mod.init_state(b.wl, s, device), 4096) for s in seeds])

    b, st = states(cuda)
    fin = harness.run_fused_many(b.wl, st, *b.ops)
    held_to_golden(harness.lane(fin, 0).store,
                   "kv_directory n=16 seed=4 fused")
    bc, stc = states("cpu")
    cpu = harness.run_fused_many(bc.wl, stc, *bc.ops)
    for a, c in zip(convert.leaves(fin), convert.leaves(cpu)):
        assert a.dtype == c.dtype and torch.equal(a.cpu(), c)


@pytest.mark.cuda
def test_sweep_golden_on_card(cuda, tmp_path):
    """`python3 -m repro_torch.workloads.sweep`'s `main` at
    `golden/sweep.json`'s argv on the card, traced, on the reference's
    kv_serving traces, in a child process: its `check_doc` passes and
    every modeled column equals the reference's document's."""
    _in_child("_sweep_golden", str(tmp_path))


def _sweep_golden(cuda, tmp):
    from repro_torch.obs import trace as TL
    TL.TRACE, TL.DEFAULT_CAP = True, 4096
    golden = json.loads((GOLDEN / "sweep.json").read_text())
    argv = golden.pop("provenance")["argv"]
    out = pathlib.Path(tmp) / "sweep.json"
    traces = sweep.reference_traces(str(GOLDEN / "sweep_traces.npz"), cuda)
    assert sweep.main(argv + ["--out", str(out), "--trace-out",
                              str(pathlib.Path(tmp) / "trace.json")],
                      traces) == 0
    doc = json.loads(out.read_text())
    assert doc["kernel_mode"] == "cuda" and doc["backend"] == "cuda"
    assert sweep_doc.diff_modeled(doc, golden) == []


# ---------------------------------------------------------------- training


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.TRAIN_ATTN_CASES)),
                         ids=_ids(C.TRAIN_ATTN_CASES))
def test_flash_attention_training_kernels_on_card(cuda, k):
    """The training instance (output and lse) and the backward kernel
    against their plain versions (`cases.check_attn_train`)."""
    C.check_attn_train(FA, k, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.RMS_BWD_CASES)),
                         ids=_ids(C.RMS_BWD_CASES))
def test_rmsnorm_bwd_kernel_on_card(cuda, k):
    C.check_rms_bwd(RN, k, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(C.ROUTER_BWD_CASES)),
                         ids=_ids(C.ROUTER_BWD_CASES))
def test_topk_router_bwd_kernel_on_card(cuda, k):
    C.check_router_bwd(TR, k, cuda)


@pytest.mark.cuda
def test_backward_kernels_are_bitwise_deterministic(cuda):
    """No float atomics: two calls give the same bits (attention at a
    ragged S and at the training shape B=4 S=256; rmsnorm at the training
    width and at 12288, its CTA-a-row instance)."""
    for s in (300, 256):
        q, k, v = (C.to_dtype(x, "bfloat16").to(cuda)
                   for x in C.attn_inputs(1, 4, 16, 8, s, 64))
        o, lse = FA.flash_attention_lse(q, k, v)
        do = torch.randn_like(q)
        a, b = (FA.flash_attention_bwd(q, k, v, o, do, lse)
                for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), s
    for shape in ((1024, 1024), (64, 12288)):
        x, w = (C.to_dtype(t, dt).to(cuda) for t, dt in zip(
            C.rms_inputs(2, shape), ("bfloat16", "float32")))
        dy = torch.randn_like(x)
        a, b = (RN.rmsnorm_bwd(x, w, dy) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), shape


@pytest.mark.cuda
def test_flash_attention_bwd_raises_on_a_misaligned_tensor(cuda):
    """The bf16 D=64 backward has one kernel, the `wgmma` one, which
    needs every tensor 16-byte aligned: a q that starts 2 bytes into
    its storage raises, and a later aligned call gives the same bits as
    before it."""
    q, k, v = (C.to_dtype(x, "bfloat16").to(cuda)
               for x in C.attn_inputs(1, 1, 4, 2, 64, 64))
    o, lse = FA.flash_attention_lse(q, k, v)
    do = torch.randn_like(q)
    want = FA.flash_attention_bwd(q, k, v, o, do, lse)
    off = torch.empty(q.numel() + 1, dtype=q.dtype,
                      device=cuda)[1:].view(q.shape)
    off.copy_(q)
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        FA.flash_attention_bwd(off, k, v, o, do, lse)
    got = FA.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_training_graph_reaches_every_leaf_on_card(cuda):
    """One lm_loss step of granite's SMOKE config on the card: every
    parameter leaf gets a finite, nonzero gradient (a kernel output
    outside the autograd graph would leave some without one), within
    1e-4 of the same step on the CPU (plain versions)."""
    from repro_torch import convert
    from repro_torch.configs import granite_moe_1b
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train.golden import leaf_norms
    from repro_torch.train.train_step import value_and_grad
    cfg = granite_moe_1b.SMOKE
    weights = convert.numpy_lm_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        batch = {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(dev),
                 "labels": torch.from_numpy(tokens[:, 1:].copy()).to(dev)}
        params = convert.lm_params_to_torch(weights, dev)
        before = FA.flash_attention_bwd.launches
        (loss, _), grads = value_and_grad(
            lambda p, b: T.lm_loss(p, cfg, b), params, batch)
        diff = {} if dev.type == "cuda" else leaf_norms(tree_map(
            lambda g, c: g - c.cpu(), grads, out["cuda"][1]))
        out[dev.type] = (float(loss), grads,
                         FA.flash_attention_bwd.launches - before, diff)
    assert out["cuda"][2] == 2 and out["cpu"][2] == 0   # 2 layers
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * out["cpu"][0]
    norms = leaf_norms(out["cpu"][1])
    for path, n in leaf_norms(out["cuda"][1]).items():
        assert np.isfinite(n) and n > 0, path
        assert out["cpu"][3][path] <= 1e-4 * norms[path], path
