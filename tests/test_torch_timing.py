"""The A/B tool `repro_torch.kernels.timing` on the CPU: two checkouts
load side by side in one process, and each tree's runs reduce to their
medians.  The timings themselves need the card (tests/test_torch_cuda.py
and `chip_smoke.py`)."""
import pathlib
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels import timing  # noqa: E402

SRC = pathlib.Path(timing.__file__).resolve().parents[2]


def test_load_tree_keeps_two_checkouts_apart(tmp_path):
    """Each tree's wrappers keep their own modules and build directory,
    and both give the plain version's planes on the CPU."""
    shutil.copytree(SRC / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "golden"))
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] == "repro_torch"}
    try:
        other = timing.load_tree(str(tmp_path / "src"))
        this = timing.load_tree(str(SRC))
    finally:
        for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
            del sys.modules[k]
        sys.modules.update(saved)
    assert pathlib.Path(other[2].__file__).is_relative_to(tmp_path)
    assert pathlib.Path(this[2].__file__).is_relative_to(SRC)
    assert other[2].common is not this[2].common
    assert other[2].common.BUILD == tmp_path / "build"
    xs = C.pc_inputs(0, n=8, nb=4, w=40)
    got = [mods[2].plane_commit(*(C.to_torch(x) for x in xs))
           for mods in (other, this)]
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_tree_medians_take_each_trees_own_runs():
    def rec(tree, ms, eager):
        return {"tree": tree, "name": "k", "shape": "n=64", "ms": ms,
                "eager_ms": eager}
    recs = [rec("parent", 3.0, 30.0), rec(".", 2.0, 20.0),
            rec(".", 2.2, 60.0), rec("parent", 1.0, 40.0),
            rec("parent", 2.0, 50.0)]
    got = {m["tree"]: m for m in timing.tree_medians(recs)}
    assert (got["parent"]["runs"], got["parent"]["ms"],
            got["parent"]["eager_ms"]) == (3, 2.0, 40.0)
    # an even count takes the upper median
    assert (got["."]["runs"], got["."]["ms"], got["."]["eager_ms"]) \
        == (2, 2.2, 60.0)


def test_pair_wins_count_each_rounds_two_pairs():
    """parent, change, change, parent: two pairs a round; a tie counts
    for neither side, and the base's interquartile range is its own."""
    def rec(tree, ms, eager):
        return {"tree": tree, "name": "k", "shape": "n=64", "ms": ms,
                "eager_ms": eager}
    recs = [rec("parent", 2.0, 40.0), rec(".", 1.5, 41.0),
            rec(".", 1.6, 30.0), rec("parent", 2.1, 35.0),
            rec("parent", 1.9, 50.0), rec(".", 1.9, 20.0),
            rec(".", 1.4, 30.0), rec("parent", 2.4, 30.0)]
    (got,) = timing.pair_wins(recs)
    assert (got["base"], got["tree"], got["pairs"]) == ("parent", ".", 4)
    assert (got["ms_wins"], got["eager_wins"]) == (3, 2)
    # parent's runs 1.9, 2.0, 2.1, 2.4: quartiles 2.0 and 2.4
    assert got["base_ms_iqr"] == pytest.approx(0.4)
    assert timing.pair_wins(recs[:2] + [rec("third", 1.0, 1.0)]) == []


def test_serve_calls_give_both_serving_kernels_at_both_shapes():
    """rmsnorm and topk_router at the decode and the prefill shapes; on
    the CPU each call takes the plain version (no launch) and gives its
    result; each serving kernel is held to one device operation."""
    from repro_torch.kernels.rmsnorm import ops as RN
    from repro_torch.kernels.topk_router import ops as TR
    calls = timing.serve_calls(C, RN, TR, torch.device("cpu"))
    assert sorted((c["name"], c["shape"].split("(")[-1]) for c in calls) \
        == sorted((n, f"{w})") for n in timing.SERVE_KERNELS
                  for w in timing.SERVE_SHAPES)
    before = (RN.rmsnorm.launches, TR.topk_router.launches)
    for c in calls:
        got, want = c["fn"](), c["plain"]()
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert torch.equal(g, w)
        assert c["bytes"] > 0 and c["ops"] > 0
    assert (RN.rmsnorm.launches, TR.topk_router.launches) == before
    assert set(timing.SERVE_KERNELS) <= set(timing.ONE_OP)


def test_decode_calls_give_granites_serving_decode_shape():
    """flash_decode at granite's decode shape, each slot's kv_len its
    phase-7 prompt's length plus 16; on the CPU the call takes the plain
    version (no launch); the bytes are the valid prefix's K and V, q and
    the output."""
    from repro_torch.kernels.flash_decode import ops as FD
    (call,) = timing.decode_calls(C, FD, torch.device("cpu"))
    assert call["shape"] == ("q [4,16,64] cache [4,8,512,64] bf16 kv_len "
                             "[272, 32, 54, 83] (granite decode)")
    before = FD.flash_decode.launches
    assert torch.equal(call["fn"](), call["plain"]())
    assert FD.flash_decode.launches == before
    assert call["bytes"] == 2 * 2 * 64 * 8 * 441 + 2 * 2 * 4 * 16 * 64 + 16
    assert call["ops"] == 4 * 16 * 64 * 441


def test_decode_calls_take_the_long_cache_shape():
    """The A/B's long-cache decode at granite's heads: four full
    4,096-position caches, each rank's share eight 64-row chunks; on the
    CPU the plain version, with the bytes of the four valid prefixes."""
    from repro_torch.kernels.flash_decode import ops as FD
    (call,) = timing.decode_calls(C, FD, torch.device("cpu"),
                                  timing.GRANITE_LONG_LENS,
                                  timing.GRANITE_LONG_S, "long")
    assert call["shape"] == ("q [4,16,64] cache [4,8,4096,64] bf16 kv_len "
                             "[4096, 4096, 4096, 4096] (long)")
    assert 4096 // FD.CLUSTER == 8 * FD.MMA_ROWS
    before = FD.flash_decode.launches
    assert torch.equal(call["fn"](), call["plain"]())
    assert FD.flash_decode.launches == before
    assert call["bytes"] == 2 * 2 * 64 * 8 * 4 * 4096 + 2 * 2 * 4 * 16 * 64 \
        + 16


def test_train_calls_give_both_backward_kernels_at_the_training_shape():
    """flash_attention_bwd and rmsnorm_bwd at chip_smoke.py phase 5's
    training microbatch; on the CPU each call takes the plain version (no
    launch) and gives its result."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rmsnorm import ops as RN
    calls = timing.train_calls(C, FA, RN, torch.device("cpu"))
    assert [(c["name"], c["shape"]) for c in calls] == [
        ("flash_attention_bwd", "q [4,16,256,64] k/v [4,8,256,64] bf16"),
        ("rmsnorm_bwd", "x/dy [1024,1024] bf16")]
    before = (FA.flash_attention_bwd.launches, RN.rmsnorm_bwd.launches)
    for c in calls:
        for g, w in zip(c["fn"](), c["plain"]()):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert c["bytes"] > 0 and c["ops"] > 0
    assert (FA.flash_attention_bwd.launches, RN.rmsnorm_bwd.launches) \
        == before
