"""The port's cross-pod delta sync and its compression against the JAX
package.

* `compress`: bitwise against `repro.distributed.compress` on seeded
  inputs, the reference's duplicate-pad residual write included.
* `hier_sync`, stacked: the JAX function runs in this process as
  `jax.vmap(partial(selective_global_sync, axis_name="pod", ...),
  axis_name="pod")` over the stacked pods; the port runs `make_pod_sync`
  on the same [n_pods, nb, bs] inputs on the CPU.  Bank and `ref` are held
  to 2e-6 absolute (the pod sums may round in another order: one or two
  float32 ulps at these magnitudes); every other leaf with `==`.
* `hier_sync`, process group: four gloo CPU processes, one pod each, give
  the stacked run's result bit for bit.
* `src/repro_torch/golden/hier_sync.json`, the JAX reference's results on
  the test bank, the cross-pod example's bank and the delta-sync bench's
  three banks, which `chip_smoke.py` phase 8 holds the card to.  Rewrite
  it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hier_sync.py --write
"""
import functools
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

from repro.distributed import compress as JC  # noqa: E402
from repro.distributed import hier_sync as JH  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import compress as TC  # noqa: E402
from repro_torch.distributed import delta_sync as DS  # noqa: E402
from repro_torch.distributed import hier_sync as TH  # noqa: E402

torch.use_deterministic_algorithms(True)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANK_TOL = DS.BANK_TOL
N_PODS, NB, BS, MAXD = 4, 64, 32, 16      # tests/test_distributed.py:82
MODES = DS.MODES


# --------------------------------------------------------------------------
# the two packages on the same stacked inputs
# --------------------------------------------------------------------------

def _jax_fn(mode, max_dirty):
    if mode == "full":
        f = functools.partial(JH.full_global_sync, axis_name="pod")
    else:
        f = functools.partial(JH.selective_global_sync, axis_name="pod",
                              max_dirty=max_dirty,
                              use_int8=mode == "selective_int8")
    return jax.vmap(f, axis_name="pod")


def run_jax(base, steps, mode, max_dirty, dtype=jnp.float32):
    """Syncs of the stacked banks `steps` in a row from bank_init(base);
    returns ([new bank per step] as numpy, final state as numpy)."""
    n_pods = steps[0].shape[0]
    st = jax.vmap(JH.bank_init)(jnp.asarray(np.broadcast_to(
        base, (n_pods,) + base.shape).copy()).astype(dtype))
    fn = _jax_fn(mode, max_dirty)
    outs = []
    for banks in steps:
        nb, st = fn(jnp.asarray(banks).astype(dtype), st)
        outs.append(np.asarray(nb.astype(jnp.float32)))
    return outs, JH.BankSyncState(*(np.asarray(x) for x in st))


def run_port(base, steps, mode, max_dirty, dtype=torch.float32):
    n_pods, nb, bs = steps[0].shape
    st = TH.bank_init(torch.from_numpy(np.broadcast_to(
        base, (n_pods, nb, bs)).copy()).to(dtype))
    sync = TH.make_pod_sync(n_pods, nb, bs, max_dirty=max_dirty,
                            use_int8=mode == "selective_int8",
                            selective=mode != "full")
    outs = []
    for banks in steps:
        new, st = sync(torch.from_numpy(banks).to(dtype), st)
        assert new.dtype == dtype
        outs.append(new.float().numpy())
    return outs, convert.to_numpy(st)


def assert_sync_equal(got, want):
    """Bank and ref within BANK_TOL, every other leaf bitwise."""
    (g_out, g_st), (w_out, w_st) = got, want
    for g, w in zip(g_out, w_out):
        np.testing.assert_allclose(g, w, rtol=0, atol=BANK_TOL)
    for name, g, w in zip(w_st._fields, g_st, w_st):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "ref":
            np.testing.assert_allclose(g, w, rtol=0, atol=BANK_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _case(name):
    """(base, steps, mode, max_dirty, jax dtype, torch dtype)."""
    b = DS.small_bank()
    f32 = (jnp.float32, torch.float32)
    if name in MODES:
        return (b.base, [b.banks], name, MAXD) + f32
    if name.startswith("overflow"):        # every block dirty
        rng = np.random.default_rng(1)
        banks = b.banks + rng.normal(size=b.banks.shape).astype(np.float32)
        return (b.base, [banks], name.split(" ")[1], MAXD) + f32
    if name.startswith("max_dirty > nb"):
        return (b.base, [b.banks], name.split(" ")[-1], 1024) + f32
    if name == "bfloat16 bank":
        return (b.base, [b.banks], "selective_f32", MAXD, jnp.bfloat16,
                torch.bfloat16)
    # two syncs in a row: the second nudges 5 blocks of pod 1 and 2 of
    # pod 3 on top of the first sync's (JAX) result
    mode = name.split(" ")[-1]
    first, _ = run_jax(b.base, [b.banks], mode, MAXD)
    rng = np.random.default_rng(2)
    second = first[0].copy()
    second[1, rng.choice(NB, 5, replace=False)] += 0.5
    second[3, rng.choice(NB, 2, replace=False)] -= 0.25
    return (b.base, [b.banks, second], mode, MAXD) + f32


CASES = list(MODES) + [
    "overflow selective_f32", "overflow selective_int8",
    "max_dirty > nb selective_f32", "max_dirty > nb selective_int8",
    "bfloat16 bank", "two syncs selective_int8", "two syncs selective_f32"]


@pytest.mark.parametrize("name", CASES)
def test_stacked_sync_matches_jax(name):
    base, steps, mode, maxd, jt, tt = _case(name)
    want = run_jax(base, steps, mode, maxd, jt)
    got = run_port(base, steps, mode, maxd, tt)
    assert_sync_equal(got, want)
    st = got[1]
    assert (st.syncs == len(steps)).all()
    if name.startswith("overflow"):
        assert (st.bytes_selective == st.bytes_full).all()
    if name == "max_dirty > nb selective_f32":
        # the list has min(max_dirty, nb) = 64 entries: 64*32*4 + 64//8
        assert (st.bytes_selective == 8200).all()


def test_stacked_sync_numbers_of_the_jax_test():
    """tests/test_distributed.py's cell: the mean within 2.4e-7, 2056
    bytes per pod, 12 promoted blocks; int8 584 bytes."""
    b = DS.small_bank()
    (out,), st = run_port(b.base, [b.banks], "selective_f32", MAXD)
    assert np.abs(out - b.banks.mean(0)[None]).max() < 1e-5
    assert (st.bytes_selective == 2056).all()
    assert (st.promoted.sum(1) == 12).all()
    assert st.bytes_selective[0] < 0.35 * st.bytes_full[0]
    _, st8 = run_port(b.base, [b.banks], "selective_int8", MAXD)
    assert (st8.bytes_selective == 584).all()


def test_dirty_mask_and_list_match_jax():
    """dirty_mask per pod bitwise; the index list and overflow of the
    union, against the reference's lines (hier_sync.py:88-93)."""
    b = DS.small_bank()
    st_j = jax.vmap(JH.bank_init)(jnp.asarray(np.broadcast_to(
        b.base, b.banks.shape).copy()))
    mine_j = np.asarray(jax.vmap(JH.dirty_mask)(jnp.asarray(b.banks), st_j))
    st_t = convert.from_numpy(JH.BankSyncState(
        *(np.asarray(x) for x in st_j)), "cpu")
    mine_t = TH.dirty_mask(torch.from_numpy(b.banks), st_t).numpy()
    np.testing.assert_array_equal(mine_t, mine_j)
    union = mine_j.any(0)
    for maxd in (4, 12, 16, 64, 1024):
        idx, overflow = TH.dirty_list(torch.from_numpy(union), maxd)
        want_idx, want_of = jax_dirty_list(union, maxd)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert idx.dtype == torch.int32 and bool(overflow) == want_of


def jax_dirty_list(union: np.ndarray, max_dirty: int):
    """The reference's list, as hier_sync.py:88-93 computes it."""
    n_blocks = union.shape[0]
    u = jnp.asarray(union)
    order = jnp.argsort(~u, stable=True)
    idx = jnp.where(jnp.arange(n_blocks) < max_dirty, order, -1)[:max_dirty]
    idx = jnp.where(u[jnp.clip(idx, 0, n_blocks - 1)], idx, -1)
    return np.asarray(idx, np.int32), bool(jnp.sum(u) > max_dirty)


def test_sync_state_round_trips_through_convert():
    b = DS.small_bank()
    _, st = run_jax(b.base, [b.banks], "selective_int8", MAXD)
    port = convert.from_numpy(st, "cpu")
    assert type(port) is TH.BankSyncState
    for x, y in zip(convert.to_numpy(port), st):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    ef = convert.from_numpy(JC.EFState(st.ef), "cpu")
    assert type(ef) is TC.EFState
    np.testing.assert_array_equal(convert.to_numpy(ef).err, st.ef)


def test_make_pod_sync_refuses_a_wrong_layout():
    sync = TH.make_pod_sync(4, NB, BS, max_dirty=MAXD)
    bank = torch.zeros((2, NB, BS))
    with pytest.raises(ValueError, match="L \\* 1 ranks == 4 pods"):
        sync(bank, TH.bank_init(bank))


# --------------------------------------------------------------------------
# compress
# --------------------------------------------------------------------------

def _ef_inputs(seed, n=16, bs=48):
    rng = np.random.default_rng(seed)
    delta = (rng.normal(size=(n, bs)) * rng.uniform(0.01, 3, (n, 1))) \
        .astype(np.float32)
    err = (0.01 * rng.normal(size=(n, bs))).astype(np.float32)
    return delta, err


def test_quantize_int8_matches_jax():
    delta, _ = _ef_inputs(0)
    delta[3] = 0.0                        # a zero row: scale 1e-12
    delta[4, :5] = [0.5, -0.5, 1.5, 2.5, -127.0]   # halves: to even
    q_j, s_j = JC.quantize_int8(jnp.asarray(delta))
    q_t, s_t = TC.quantize_int8(torch.from_numpy(delta))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        TC.dequantize_int8(q_t, s_t).numpy(),
        np.asarray(JC.dequantize_int8(q_j, s_j)))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32


@pytest.mark.parametrize("idx", [
    [0, 2, -1, -1],            # block 0 dirty, pads after it
    [0, 2],                    # no pads
    [5, 0, 9, -1, 3, -1],      # pads between and after
    [-1, -1, -1],              # all pads
    [15, 7, 0],                # ascending not required
], ids=lambda i: str(i))
def test_compress_blocks_matches_jax(idx):
    delta, err = _ef_inputs(len(idx))
    idx = np.asarray(idx, np.int32)
    q_j, s_j, ef_j = JC.compress_blocks(jnp.asarray(delta),
                                        JC.EFState(jnp.asarray(err)),
                                        jnp.asarray(idx))
    q_t, s_t, ef_t = TC.compress_blocks(torch.from_numpy(delta),
                                        TC.EFState(torch.from_numpy(err)),
                                        torch.from_numpy(idx))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(ef_t.err.numpy(), np.asarray(ef_j.err))


def test_compress_pads_drop_block0_residual_as_the_reference_does():
    """The reference's `err.at[clip(idx)].set(...)` clamps pads to block 0
    and the later entry wins: with pads after block 0 its residual stays
    the old one (here 0), without pads it is set (ROADMAP Queue C)."""
    delta, _ = _ef_inputs(9, n=4, bs=32)
    zero = torch.zeros((4, 32))
    _, _, padded = TC.compress_blocks(torch.from_numpy(delta),
                                      TC.EFState(zero),
                                      torch.tensor([0, 2, -1, -1],
                                                   dtype=torch.int32))
    _, _, plain = TC.compress_blocks(torch.from_numpy(delta),
                                     TC.EFState(zero),
                                     torch.tensor([0, 2], dtype=torch.int32))
    assert not padded.err[0].any() and padded.err[2].any()
    assert plain.err[0].any()
    np.testing.assert_array_equal(padded.err[2].numpy(),
                                  plain.err[2].numpy())


def test_compress_blocks_stacked_equals_per_pod():
    """A leading pod axis with one shared list == each pod on its own."""
    rng = np.random.default_rng(4)
    delta = torch.from_numpy(rng.normal(size=(3, 10, 16)).astype(np.float32))
    err = torch.from_numpy(
        (0.1 * rng.normal(size=(3, 10, 16))).astype(np.float32))
    idx = torch.tensor([1, 0, 7, -1], dtype=torch.int32)
    q, s, ef = TC.compress_blocks(delta, TC.EFState(err), idx)
    for p in range(3):
        qp, sp, efp = TC.compress_blocks(delta[p], TC.EFState(err[p]), idx)
        np.testing.assert_array_equal(q[p].numpy(), qp.numpy())
        np.testing.assert_array_equal(s[p].numpy(), sp.numpy())
        np.testing.assert_array_equal(ef.err[p].numpy(), efp.err.numpy())


def test_int8_error_feedback_unbiased():
    """The twin of tests/test_distributed.py::test_int8_error_feedback_unbiased."""
    rng = np.random.default_rng(0)
    delta = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    idx = torch.arange(8, dtype=torch.int32)
    ef = TC.EFState(err=torch.zeros((8, 64)))
    acc = torch.zeros((8, 64))
    for _ in range(30):
        q, s, ef = TC.compress_blocks(delta, ef, idx)
        acc = acc + TC.dequantize_int8(q, s)
    np.testing.assert_allclose((acc / 30).numpy(), delta.numpy(),
                               rtol=0.05, atol=0.02)


def test_compressed_bytes_and_ef_init():
    assert TC.compressed_bytes(16, 32) == JC.compressed_bytes(16, 32) == 576
    ef = TC.ef_init(4, 8, device="cpu")
    assert ef.err.shape == (4, 8) and ef.err.dtype == torch.float32
    assert not ef.err.any()


# --------------------------------------------------------------------------
# the banks of the bench and the example
# --------------------------------------------------------------------------

def test_delta_sync_banks_follow_the_bench_rules():
    banks = DS.bench_banks()
    assert [(b.label, b.banks.shape, b.max_dirty) for b in banks] == [
        ("moe_expert_bank", (4, 256, 2048), 61),
        ("embedding_rows", (4, 1024, 1024), 163),
        ("dense_layer(worst)", (4, 256, 2048), 1024)]
    for b, (nb, _, frac, _) in zip(banks, DS.BENCH):
        assert b.base.dtype == b.banks.dtype == np.float32
        touched = (b.banks != b.base[None]).any(-1).sum(1)
        assert (touched == max(1, int(nb * frac))).all()
    ex = DS.example_bank()
    assert ex.banks.shape == (4, 32, 4096) and ex.max_dirty == 16
    assert ((ex.banks != ex.base[None]).any(-1).sum(1) == 3).all()
    # granite's embedding at its real size is drawn only on the card
    assert (DS.GRANITE_VOCAB, DS.GRANITE_D) == (49155, 1024)
    assert max(1, int(49155 * 0.02)) == 983
    assert DS.bench_max_dirty(49155, 0.02) == 7864


# --------------------------------------------------------------------------
# four gloo processes, one pod each
# --------------------------------------------------------------------------

_GLOO_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, path):
    from repro_torch import convert
    from repro_torch.distributed import hier_sync as TH
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    data = np.load(f"{path}/data.npz")
    out = {}
    for mode in ("selective_f32", "selective_int8", "full"):
        st = TH.bank_init(torch.from_numpy(data["base"][rank:rank + 1]))
        sync = TH.make_pod_sync(world, *data["base"].shape[1:],
                                max_dirty=int(data["max_dirty"]),
                                use_int8=mode == "selective_int8",
                                selective=mode != "full",
                                group=dist.group.WORLD)
        for step in ("first", "second"):
            new, st = sync(torch.from_numpy(data[step][rank:rank + 1]), st)
            out[f"{mode}/{step}/bank"] = new.numpy()
        for name, x in zip(st._fields, convert.to_numpy(st)):
            out[f"{mode}/{name}"] = x
    np.savez(f"{path}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[2]), sys.argv[1]),
             nprocs=int(sys.argv[2]))
'''


def test_process_group_equals_stacked_run(tmp_path):
    b = DS.small_bank()
    rng = np.random.default_rng(5)
    second = b.banks.copy()
    second[2, rng.choice(NB, 4, replace=False)] += 1.0
    base = np.broadcast_to(b.base, b.banks.shape).copy()
    np.savez(tmp_path / "data.npz", base=base, first=b.banks, second=second,
             max_dirty=MAXD)
    script = tmp_path / "gloo_sync.py"
    script.write_text(_GLOO_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(script), str(tmp_path),
                    str(N_PODS)], check=True, timeout=120, env=env,
                   cwd=tmp_path)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(N_PODS)]
    for mode in MODES:
        outs, st = run_port(b.base, [b.banks, second], mode, MAXD)
        for r, got in enumerate(ranks):
            for i, step in enumerate(("first", "second")):
                np.testing.assert_array_equal(
                    got[f"{mode}/{step}/bank"][0], outs[i][r], err_msg=mode)
            for name, want in zip(st._fields, st):
                np.testing.assert_array_equal(
                    got[f"{mode}/{name}"][0], want[r],
                    err_msg=f"{mode} {name}")


# --------------------------------------------------------------------------
# the golden file
# --------------------------------------------------------------------------

def golden_entry(b) -> dict:
    """The JAX reference's results on one bank, in every mode."""
    union = (b.banks != b.base[None]).any(-1).any(0)
    idx, overflow = jax_dirty_list(union, b.max_dirty)
    rec = {"bank": b.label, "n_pods": int(b.banks.shape[0]),
           "n_blocks": int(b.base.shape[0]),
           "block_size": int(b.base.shape[1]), "max_dirty": b.max_dirty,
           "idx": idx.tolist(), "overflow": overflow, "modes": {}}
    delta = b.banks - b.base[None]
    q, s, _ = jax.vmap(JC.compress_blocks, in_axes=(0, 0, None))(
        jnp.asarray(delta), JC.EFState(jnp.zeros_like(jnp.asarray(delta))),
        jnp.asarray(idx))
    for mode in MODES:
        (out,), st = run_jax(b.base, [b.banks], mode, b.max_dirty)
        for p in range(1, out.shape[0]):
            np.testing.assert_array_equal(out[p], out[0])
        m = {"promoted": np.flatnonzero(st.promoted[0]).tolist(),
             "syncs": int(st.syncs[0]),
             "bytes_selective": float(st.bytes_selective[0]),
             "bytes_full": float(st.bytes_full[0]),
             "block_sums": out[0].astype(np.float64).sum(-1).tolist()}
        if mode == "selective_int8":
            m["sha256"] = {"q": DS.digest(np.asarray(q)),
                           "scale": DS.digest(np.asarray(s)),
                           "ef": DS.digest(st.ef)}
        rec["modes"][mode] = m
    return rec


def _provenance() -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    return {"reference": "repro (JAX) distributed.hier_sync through "
                         "jax.vmap(axis_name='pod'), CPU backend",
            "jax_commit": commit,
            "generator": "tests/test_torch_hier_sync.py --write",
            "block_sums": "float64 sums over each block of pod 0's new "
                          "bank (every pod's is the same)",
            "sha256": "int8 q [pods, k, bs] and scale [pods, k] of "
                      "compress_blocks(bank - base, zero residual, idx), "
                      "and the state's ef after the sync"}


@pytest.mark.parametrize("k", range(len(DS.golden_banks())),
                         ids=[b.label for b in DS.golden_banks()])
def test_port_reproduces_the_golden_file(k):
    """The port on the CPU, held to the golden file by the check that
    chip_smoke.py phase 8 runs on the card (`delta_sync.check_bank`)."""
    doc = DS.load_golden()
    bank = DS.golden_banks()[k]
    assert doc["banks"][k]["bank"] == bank.label
    res = DS.check_bank(bank, doc["banks"][k], "cpu")
    assert res["selective_f32"]["mean_err"] < 1e-5


@pytest.mark.slow
def test_golden_regenerates_from_jax():
    assert [golden_entry(b) for b in DS.golden_banks()] \
        == DS.load_golden()["banks"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_hier_sync.py --write")
    doc = {"provenance": _provenance(),
           "banks": [golden_entry(b) for b in DS.golden_banks()]}
    DS.GOLDEN.write_text(json.dumps(doc) + "\n")
    print(f"wrote {DS.GOLDEN} ({DS.GOLDEN.stat().st_size} bytes)")
