"""The replica axis against the JAX package, continued
(test_torch_many.py has the helpers and the comparison rule):
producer_consumer_mc under the protocols other than srsp."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_many import check_cell, no_vmap_fallback  # noqa: E402,F401

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("scenario,engine", [
    ("rsp", "fused"), ("baseline", "batched"), ("scope_only", "fused")])
def test_producer_consumer_mc_many_matches_jax(scenario, engine):
    check_cell("producer_consumer_mc", scenario, engine)
