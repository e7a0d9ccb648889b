"""kv_serving end to end under baseline and scope_only (the staleness
demo, whose check is red): the port against the JAX package at n=8,
replaying the JAX trace.  The helpers and the comparison rule are
test_torch_kv_serving.py's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_kv_serving import check_every_engine  # noqa: E402

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("scenario", ["baseline", "scope_only"])
def test_every_engine_matches_jax(scenario):
    check_every_engine(scenario)
