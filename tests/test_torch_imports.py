"""The port stands alone: no module of `src/repro_torch/`, and not
`chip_smoke.py`, imports JAX or anything of the JAX package `repro`."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or top.startswith("jax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"protocol.py", "harness.py", "kv_directory.py",
            "chip_smoke.py", "granite_moe_1b.py", "transformer.py",
            "moe.py", "attention.py", "engine.py", "golden.py",
            "hier_sync.py", "compress.py", "delta_sync.py", "reader_lock.py",
            "producer_consumer.py", "producer_consumer_mc.py",
            "faults.py", "prng.py", "graphs.py", "worksteal.py",
            "metrics.py", "samplers.py", "driver.py",
            "kv_serving.py", "sweep.py", "ops.py", "common.py", "cases.py",
            "timing.py", "trace.py", "export.py", "report.py",
            "checkpoint.py", "fault.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"src/repro_torch/{m}.py" for m in (
        "obs/trace", "obs/export", "obs/report", "runtime/checkpoint",
        "runtime/fault")} <= rel
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core")
