"""The kernel build's cache key (`repro_torch.kernels.common.lib_path`)
on the CPU: a library is named by its source, every header of `csrc/`
and the compiler flags, so an edited header (`hopper.cuh`, which both
attention sources include) never loads a stale library."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402


def test_lib_path_follows_the_source_and_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "common.cuh").write_text("// common\n")
    (tmp_path / "hopper.cuh").write_text("// hopper\n")
    first = common.lib_path("k")
    assert first == common.lib_path("k")
    assert first.parent == common.BUILD and first.name.startswith("libk-")
    seen = {first}
    for name, text in (("hopper.cuh", "// hopper, edited\n"),
                       ("common.cuh", "// common, edited\n"),
                       ("new.cuh", "// a new header\n"),
                       ("k.cu", '#include "common.cuh"\n')):
        (tmp_path / name).write_text(text)
        seen.add(common.lib_path("k"))
    assert len(seen) == 5
    with_new = common.lib_path("k")
    (tmp_path / "new.cuh").unlink()
    assert common.lib_path("k") != with_new
