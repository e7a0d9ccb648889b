"""The port's selective flush and apply against the JAX package.

On the CPU `selective_flush` takes its plain version (dispatch is by the
tensor's device); the JAX side runs the Pallas kernel in interpret mode
and its jnp reference, as tests/test_kernels.py does.  Inputs are made
from a numpy seed and fed to both; comparisons are bitwise (bfloat16
through its 16-bit patterns).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_flush import ops as JOPS  # noqa: E402
from repro.kernels.selective_flush.kernel import (  # noqa: E402
    selective_flush_pallas)
from repro.kernels.selective_flush.ref import (  # noqa: E402
    selective_apply_ref, selective_flush_ref)
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.selective_flush import ops as SF  # noqa: E402

torch.use_deterministic_algorithms(True)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits_jax(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


def _bits_torch(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy().view(np.uint32)


def _pair(bank_f32: np.ndarray, dtype: str):
    jt, tt = DTYPES[dtype]
    return (jnp.asarray(bank_f32).astype(jt),
            torch.from_numpy(bank_f32).to(tt))


# the grid of tests/test_kernels.py:22-31
@pytest.mark.parametrize("nb,bs,nd", [(16, 128, 4), (64, 256, 16),
                                      (128, 512, 32), (8, 128, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_flush_matches_pallas_and_ref(nb, bs, nd, dtype):
    rng = np.random.default_rng(nb * 31 + nd)
    bank_j, bank_t = _pair(rng.normal(size=(nb, bs)).astype(np.float32),
                           dtype)
    idx = rng.integers(-1, nb, size=nd).astype(np.int32)
    idx[-2:] = idx[0]                     # a duplicate in every case
    idx[1] = -1                           # and a pad
    got = SF.selective_flush(bank_t, torch.from_numpy(idx))
    assert got.dtype == bank_t.dtype and got.shape == (nd, bs)
    for want in (selective_flush_pallas(bank_j, jnp.asarray(idx),
                                        interpret=True),
                 selective_flush_ref(bank_j, jnp.asarray(idx))):
        np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want))
    assert SF.selective_flush.launches == 0   # CPU tensors: plain version


@pytest.mark.parametrize("case", ["all pads", "at or above nb",
                                  "one row", "negative zero"])
def test_selective_flush_edges_match_ref(case):
    """The reference's clip: an index >= nb reads row nb-1; a pad writes
    a zero row; -0.0 and other bits are copied, not recomputed."""
    rng = np.random.default_rng(3)
    nb, bs = 8, 40
    bank = rng.normal(size=(nb, bs)).astype(np.float32)
    idx = {"all pads": np.full(5, -1),
           "at or above nb": np.array([nb, nb + 7, 2, -1, nb - 1]),
           "one row": np.array([5]),
           "negative zero": np.array([0, 1])}[case].astype(np.int32)
    if case == "negative zero":
        bank[0] = -0.0
    got = SF.selective_flush(torch.from_numpy(bank), torch.from_numpy(idx))
    want = selective_flush_ref(jnp.asarray(bank), jnp.asarray(idx))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want))
    if case == "at or above nb":
        np.testing.assert_array_equal(got[0].numpy(), bank[nb - 1])
        assert not got[3].any()


@pytest.mark.parametrize("k", range(len(C.FLUSH_CASES)),
                         ids=[c[0] for c in C.FLUSH_CASES])
def test_card_cases_match_ref(k):
    """The on-card case list (`kernels.cases.FLUSH_CASES`, which
    chip_smoke.py and tests/test_torch_cuda.py run on the card) through
    the plain version here, against the JAX reference."""
    bank, idx = C.flush_args(k, "cpu")
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    bank_j = jnp.asarray(bank.float().numpy()).astype(dt[bank.dtype])
    got = SF.selective_flush(bank, idx)
    want = selective_flush_ref(bank_j, jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want))


def test_selective_apply_roundtrip():
    """The twin of tests/test_kernels.py::test_selective_apply_roundtrip."""
    rng = np.random.default_rng(0)
    bank = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    idx = torch.tensor([3, 7, -1, 30], dtype=torch.int32)
    flushed = SF.selective_flush(bank, idx)
    restored = SF.selective_apply(torch.zeros_like(bank), flushed, idx)
    for i in [3, 7, 30]:
        np.testing.assert_array_equal(restored[i].numpy(), bank[i].numpy())
    assert float(restored.abs().sum()) == pytest.approx(
        float(bank[[3, 7, 30]].abs().sum()), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_apply_matches_jax(dtype):
    """Distinct destinations with pads and indices >= nb (dropped)."""
    rng = np.random.default_rng(7)
    nb, bs, k = 24, 48, 12
    bank_j, bank_t = _pair(rng.normal(size=(nb, bs)).astype(np.float32),
                           dtype)
    upd_j, upd_t = _pair(rng.normal(size=(k, bs)).astype(np.float32),
                         dtype)
    idx = rng.permutation(nb)[:k].astype(np.int32)
    idx[[2, 5]] = -1
    idx[8] = nb + 3
    got = SF.selective_apply(bank_t, upd_t, torch.from_numpy(idx))
    for want in (JOPS.selective_apply(bank_j, upd_j, jnp.asarray(idx)),
                 selective_apply_ref(bank_j, upd_j, jnp.asarray(idx))):
        np.testing.assert_array_equal(_bits_torch(got), _bits_jax(want))


def test_selective_apply_last_entry_wins():
    bank = torch.zeros((4, 3))
    upd = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    out = SF.selective_apply(bank, upd, torch.tensor([1, 2, 1],
                                                     dtype=torch.int32))
    np.testing.assert_array_equal(out[1].numpy(), upd[2].numpy())
    np.testing.assert_array_equal(out[2].numpy(), upd[1].numpy())
    assert not out[0].any() and not out[3].any()
    assert not bank.any()                  # a fresh bank, input untouched


def test_flush_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks run before any launch (a meta tensor stands
    in for the card's: it is neither CPU nor CUDA, so dispatch refuses
    a mix)."""
    bank = torch.zeros((4, 8), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SF._flush_launch(bank, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="indices"):
        SF._flush_launch(torch.zeros((4, 8)), torch.zeros(2))
    with pytest.raises(ValueError, match="span devices"):
        SF.selective_flush(torch.zeros((4, 8)),
                           torch.zeros(2, dtype=torch.int32, device="meta"))
