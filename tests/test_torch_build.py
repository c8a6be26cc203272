"""ray_tpu_torch.ops._build on the CPU: the library's path names every byte
that goes into it, so an edited source, header or flag never loads a stale
build. Works on a copy of ``csrc`` (no nvcc needed)."""

import shutil

import pytest

from ray_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return copy


def test_path_is_stable_and_under_the_build_dir(csrc):
    path = _build.library_path("flash_attention")
    assert path == _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("flash_attention-")


def test_path_changes_when_a_header_changes(csrc):
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels include at least one header"
    before = _build.library_path("flash_attention")
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    assert _build.library_path("flash_attention") != before


def test_path_changes_when_a_header_is_added(csrc):
    before = _build.library_path("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_attention") != before


def test_path_changes_when_the_source_changes(csrc):
    before = _build.library_path("flash_attention")
    cu = csrc / "flash_attention.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    assert _build.library_path("flash_attention") != before


def test_path_changes_with_flags_and_defines(csrc, monkeypatch):
    before = _build.library_path("flash_attention")
    assert _build.library_path("flash_attention", ("RT_FWD_STAGES=2",)) != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("flash_attention") != before


def test_missing_source_raises(csrc):
    with pytest.raises(FileNotFoundError):
        _build.library_path("no_such_kernel")
