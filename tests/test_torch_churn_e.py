"""The crash red/green pins of tests/test_churn.py, the port against the
live JAX run: producer_consumer (the pins and the checks are
test_torch_churn_d.py's; kv_directory's pair is in
test_torch_churn_f.py)."""
import pytest

pytest.importorskip("torch")

from test_torch_churn_d import check_pin  # noqa: E402


@pytest.mark.parametrize("green", [True, False], ids=["green", "red"])
def test_crash_pin_matches_jax(green):
    check_pin("producer_consumer", green)
