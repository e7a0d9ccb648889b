"""The sweep's kv_serving rows, both churned rows and the serving
comparison on the golden traces, == `golden/sweep.json`
(`test_torch_sweep.py`)."""
import pytest

pytest.importorskip("torch")

from test_torch_sweep import assert_part  # noqa: E402


def test_part_kv_serving(monkeypatch, tmp_path):
    doc = assert_part("kv_serving", monkeypatch, tmp_path)
    assert len(doc["serving"]) == 6 and all(
        r["latency_source"] == "requests" for r in doc["serving"])
