"""producer_consumer end to end (one consumer): the port against the JAX
package at n=8, in every scenario and engine.  The helpers and the
comparison rule are test_torch_workloads.py's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_workloads import SCENARIOS, check_every_engine  # noqa: E402

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_engine_matches_jax(scenario):
    check_every_engine("producer_consumer", scenario)
