"""worksteal end to end: the port against the JAX package at n=8, and the
pieces it adds to the core.

* `data.graphs`: the port's copy draws every graph bit for bit;
* `protocol.plane_scatter_set` in both metadata layouts, out-of-range
  blocks dropped, against the JAX function;
* every scenario (steal_only included) under the port's serial, batched
  and fused engines from the same initial state, leaf by leaf, bit for
  bit, against the JAX run (its engines are bitwise equal to each other
  for worksteal, which has no co-scheduled remote turns), with counters,
  `events` and the self-check verdict equal.

The app drivers are in test_torch_worksteal_apps.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import protocol as JP  # noqa: E402
from repro.data import graphs as JG  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.workloads import worksteal  # noqa: E402
from test_torch_workloads import check_every_engine  # noqa: E402

torch.use_deterministic_algorithms(True)

SCENARIOS = ("srsp", "rsp", "baseline", "scope_only", "steal_only")


@pytest.mark.parametrize("name,n,seed", [("collab_like", 384, 0),
                                         ("collab_like", 512, 3),
                                         ("router_like", 384, 1),
                                         ("road_like", 384, 2)])
def test_graphs_are_the_reference_bits(name, n, seed):
    got = getattr(G, name)(n, seed=seed)
    want = getattr(JG, name)(n, seed=seed)
    assert got.name == want.name
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _triples(rng, n, nb, w, k):
    """k distinct (lane, block, offset) triples, a few blocks past the
    end (dropped) among them."""
    flat = rng.choice(n * nb * w, size=k, replace=False)
    lane, rest = np.divmod(flat, nb * w)
    b, o = np.divmod(rest, w)
    b[rng.random(k) < 0.2] = nb + rng.integers(0, 3)
    return [x.astype(np.int32) for x in (lane, b, o)]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_scatter_set_matches_jax(packed, seed, monkeypatch):
    """Both layouts: the OR of the distinct triples' bits into a random
    plane; out-of-range blocks drop; offset 31 (the sign bit) included."""
    rng = np.random.default_rng(seed)
    n, nb, w = 4, 6, 48
    lane, b, o = _triples(rng, n, nb, w, 40)
    o[0] = 31
    flags = rng.random((n, nb, w)) < 0.3
    monkeypatch.setattr(JP, "PACKED", packed)
    if packed:
        from repro.core import bitmask as JB
        jplane = JB.pack(jnp.asarray(flags))
        tplane = torch.from_numpy(np.asarray(jplane).view(np.int32).copy())
    else:
        jplane = jnp.asarray(flags)
        tplane = torch.from_numpy(flags.copy())
    want = np.asarray(JP.plane_scatter_set(jplane, jnp.asarray(lane),
                                           jnp.asarray(b), jnp.asarray(o)))
    got = P.plane_scatter_set(tplane, *(torch.from_numpy(x)
                                        for x in (lane, b, o)))
    assert got.dtype == tplane.dtype and got.shape == tplane.shape
    np.testing.assert_array_equal(got.numpy().view(want.dtype), want)


def test_plane_scatter_set_drops_out_of_range_blocks():
    plane = torch.zeros((2, 3, 1), dtype=torch.int32)
    lane, b, o = (torch.tensor(x) for x in ([0, 1, 1], [3, 2, 7], [5, 31, 0]))
    got = P.plane_scatter_set(plane, lane, b, o)
    want = torch.zeros_like(plane)
    want[1, 2, 0] = torch.tensor(1 << 31, dtype=torch.int64).to(torch.int32)
    assert torch.equal(got, want)


def test_scenarios_are_the_reference_registry():
    from repro.workloads import worksteal as jws
    assert dict(worksteal.SCENARIOS) == dict(jws.SCENARIOS)
    with pytest.raises(KeyError, match="registered"):
        worksteal.SCENARIOS["nope"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_engine_matches_jax(scenario):
    # no scenario is red: without steals nothing is shared
    check_every_engine("worksteal", scenario, red=())
