"""The port's kernel build, on the CPU (no ``nvcc`` needed): a library is
keyed by its source, the shared headers and the flags, so an edited
header cannot reuse a stale build."""

import shutil

from distkeras_tpu_torch.ops import _build


def test_library_key_covers_sources_and_headers(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    headers = sorted(p.name for p in src.glob("*.cuh"))
    assert "flash_common.cuh" in headers
    assert set(_build.sources()) == {"flash_bwd", "flash_fwd"}
    before = {name: _build.library_path(name) for name in _build.sources()}
    assert before == {name: _build.library_path(name)
                      for name in _build.sources()}
    assert all(p.parent == tmp_path / "_build" for p in before.values())

    header = src / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert all(after[n] != before[n] for n in before)

    fwd = src / "flash_fwd.cu"
    fwd.write_text(fwd.read_text() + "\n// edited\n")
    again = {name: _build.library_path(name) for name in _build.sources()}
    assert again["flash_fwd"] != after["flash_fwd"]
    assert again["flash_bwd"] == after["flash_bwd"]
