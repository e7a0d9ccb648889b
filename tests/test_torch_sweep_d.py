"""The sweep's reader_lock rows == `golden/sweep.json`
(`test_torch_sweep.py`)."""
import pytest

pytest.importorskip("torch")

from test_torch_sweep import assert_part  # noqa: E402


def test_part_reader_lock(monkeypatch, tmp_path):
    doc = assert_part("reader_lock", monkeypatch, tmp_path)
    assert len(doc["runs"]) == 10
