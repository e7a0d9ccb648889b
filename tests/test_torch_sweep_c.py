"""The sweep's producer_consumer and producer_consumer_mc rows and the
remote-batch A/B == `golden/sweep.json` (`test_torch_sweep.py`)."""
import pytest

pytest.importorskip("torch")

from test_torch_sweep import assert_part  # noqa: E402


def test_part_producer_consumer(monkeypatch, tmp_path):
    doc = assert_part("producer_consumer", monkeypatch, tmp_path)
    assert [r["remote_batch"] for r in doc["remote_batch_ab"]] \
        == [True, False]
