"""The replica axis against the JAX package, continued
(test_torch_many.py has the helpers and the comparison rule):
kv_directory's other protocols and reader_lock's fused engine."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_many import check_cell, no_vmap_fallback  # noqa: E402,F401

torch.use_deterministic_algorithms(True)


@pytest.mark.parametrize("scenario,engine", [
    ("baseline", "fused"), ("scope_only", "batched")])
def test_kv_directory_many_matches_jax(scenario, engine):
    check_cell("kv_directory", scenario, engine)


def test_reader_lock_many_matches_jax():
    check_cell("reader_lock", "srsp", "fused")
