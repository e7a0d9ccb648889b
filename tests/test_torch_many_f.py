"""The replica axis against the JAX package, continued
(test_torch_many.py has the helpers and the comparison rule):
producer_consumer_mc under srsp, whose co-scheduled drains run as one
`remote_turn_b` form a trip, with and without `faults.serialize_remote`
(the B side of the sweep's `remote_batch_ab` pair: remote turns
serialized, the scalar remote ops' host branches run as per-replica
selects)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_many import check_cell, no_vmap_fallback  # noqa: E402,F401

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("engine,fault", [
    ("fused", None), ("batched", None), ("batched", "serialize_remote")])
def test_producer_consumer_mc_many_matches_jax(engine, fault):
    check_cell("producer_consumer_mc", "srsp", engine, fault)
