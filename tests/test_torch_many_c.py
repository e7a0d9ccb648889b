"""The replica axis against the JAX package, continued
(test_torch_many.py has the helpers and the comparison rule):
producer_consumer (one always-hot drainer) on both replica engines, and
reader_lock's batched engine."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_many import check_cell, no_vmap_fallback  # noqa: E402,F401

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("engine", ["fused", "batched"])
def test_producer_consumer_many_matches_jax(engine):
    check_cell("producer_consumer", "srsp", engine)


def test_reader_lock_batched_many_matches_jax():
    check_cell("reader_lock", "srsp", "batched")
