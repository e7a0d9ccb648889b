"""The port's threefry (`repro_torch.core.prng`) against `jax.random`.

Keys (`PRNGKey`, a uint32 seed included, `split`, `fold_in`), raw
`bits`, `uniform` and `bernoulli` are held bit for bit to the installed
JAX in its default, partitionable layout, over several seeds and shapes,
batched keys included.  `exponential` goes through PyTorch's `log1p`,
which is not XLA's: its distance in ulps is reported and held to one
ulp, not asserted bitwise.  The samplers on top (`traffic.samplers`)
draw the reference's integer ranks wherever a draw is not on a CDF edge;
`zipf_cdf` itself is compared within float32 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.traffic import samplers as JS  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.traffic import samplers as S  # noqa: E402

torch.use_deterministic_algorithms(True)

SEEDS = [0, 1, 4, 12345, 2**31 - 1, -7]
SHAPES = [(1,), (7,), (3, 5), (1000,), (2, 3, 4)]


def _key(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def test_layout_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _key(jk))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _key(jax.random.split(jk, num)))
    for d in (0, 1, 7, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _key(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5, 2**32 - 1])
def test_uint32_seed_is_jax(seed):
    """The trace generator seeds with a uint32 (`traffic/trace.py`)."""
    jk = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), _key(jk))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError, match="range"):
        prng.PRNGKey(2**32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_are_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                  _bits(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(_bits(prng.uniform(tk, shape).numpy()),
                                  _bits(jax.random.uniform(jk, shape)))
    for p in (0.5, 0.125, 0.3):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_batched_keys_are_jax():
    """Keys [B, 2] draw as `jax.vmap` over the keys does."""
    jk = jax.random.PRNGKey(9)
    jks = jax.vmap(lambda a: jax.random.fold_in(jk, a))(jnp.arange(5))
    tks = prng.fold_in(prng.PRNGKey(9), torch.arange(5))
    np.testing.assert_array_equal(tks.numpy(), _key(jks))
    np.testing.assert_array_equal(
        prng.split(tks).numpy(), _key(jax.vmap(jax.random.split)(jks)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(tks, (6,)).numpy()),
        _bits(jax.vmap(lambda k: jax.random.uniform(k, (6,)))(jks)))


def test_exponential_within_one_ulp_of_jax():
    """PyTorch's log1p is not XLA's: report how many of 2**20 draws
    differ and by how many ulps (on the CPU: one ulp on ~7.3 %)."""
    jk, tk = jax.random.PRNGKey(42), prng.PRNGKey(42)
    want = _bits(jax.random.exponential(jk, (1 << 20,))).astype(np.int64)
    got = _bits(prng.exponential(tk, (1 << 20,)).numpy()).astype(np.int64)
    ulps = np.abs(got - want)
    print(f"exponential: {int((ulps > 0).sum())} of {ulps.size} draws "
          f"differ, at most {int(ulps.max())} ulp")
    assert ulps.max() <= 1


@pytest.mark.parametrize("n_keys,s", [(8, 1.1), (128, 1.1), (1024, 1.2)])
def test_zipf_cdf_and_ranks_track_jax(n_keys, s):
    """The CDF within float32 rounding of a sum of n_keys terms; ranks
    equal wherever the uniform draw is not within that rounding of a CDF
    edge."""
    got = S.zipf_cdf(n_keys, s).numpy()
    want = np.asarray(JS.zipf_cdf(n_keys, s))
    tol = 2 * n_keys * np.finfo(np.float32).eps
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    u = np.asarray(jax.random.uniform(jk, (4096,)))
    near = (np.abs(u[:, None] - want[None, :]) <= tol).any(axis=1)
    r_j = np.asarray(JS.zipf_ranks(jk, 4096, n_keys, s))
    r_t = S.zipf_ranks(tk, 4096, n_keys, s).numpy()
    np.testing.assert_array_equal(r_t[~near], r_j[~near])


@pytest.mark.parametrize("burstiness,burst_len", [(1.0, 8), (4.0, 8),
                                                  (4.0, 3)])
def test_arrival_clocks_track_jax(burstiness, burst_len):
    """Arrival clocks within the rounding of a float32 sum of m gaps
    (each at most an ulp off), whatever order either side sums in."""
    m = 256
    jc = JS.TrafficConfig(burstiness=burstiness, burst_len=burst_len,
                          gap_mean=8.0)
    tc = S.TrafficConfig(burstiness=burstiness, burst_len=burst_len,
                         gap_mean=8.0)
    want = np.asarray(JS.arrival_clocks(jax.random.PRNGKey(5), m, jc))
    got = S.arrival_clocks(prng.PRNGKey(5), m, tc).numpy()
    np.testing.assert_allclose(got, want,
                               rtol=2 * (m + 2) * 2.0**-24, atol=0)
    assert np.all(np.diff(got) >= 0) and got[0] >= 0
