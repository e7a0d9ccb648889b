"""producer_consumer_mc end to end: the port against the JAX package at
n=8 (two consumers), with the remote co-scheduling branch.

The helpers and the comparison rule are test_torch_workloads.py's.
Here also: the co-scheduling branch really batches two or more drains in
one remote turn, in both the batched and the fused engine.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.workloads import harness  # noqa: E402
from test_torch_workloads import (SCENARIOS, _port_bench,  # noqa: E402
                                  check_every_engine)

torch.use_deterministic_algorithms(True)

NAME = "producer_consumer_mc"


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_engine_matches_jax(scenario):
    check_every_engine(NAME, scenario)


def _counting(wl, sizes):
    """`wl` with its remote_turn_b recording each batch's size."""
    def turn_b(wl2, s, mask, *ops):
        sizes.append(int(mask.sum()))
        return wl.remote_turn_b(wl2, s, mask, *ops)
    return dataclasses.replace(wl, remote_turn_b=turn_b)


@pytest.mark.parametrize("engine", ["batched", "fused"])
def test_drains_share_trips(engine):
    """The co-scheduling branch really runs: some trips drain two or more
    partitions in one remote turn; rsp (no batched twins) never does."""
    for scenario, want_multi in (("srsp", True), ("rsp", False)):
        b = _port_bench(NAME, scenario)
        sizes = []
        wl = _counting(b.wl, sizes)
        assert wl.remote_cap == want_multi
        final = harness.runner(engine)(wl, b.state)
        assert b.check(final)["ok"]
        assert (max(sizes, default=0) >= 2) == want_multi, (scenario, sizes)
