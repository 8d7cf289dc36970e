"""The port's kernel build cache (``repro_torch.kernels._build``): a
library is named by a hash of its source, of every shared header in
``csrc/`` and of the compiler flags, so an edit of any of them builds a
new library instead of loading a stale one. Needs no ``nvcc``."""

import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_kernel_has_its_source_and_a_stable_name():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build._lib_path(name) == _build._lib_path(name)
    assert len({_build._lib_path(n) for n in _build.KERNELS}) == len(
        _build.KERNELS)


@pytest.mark.parametrize("name", ["paged_decode", "mxfp4_matmul"])
def test_header_edit_renames_the_library(csrc_copy, name):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the kernels share a header in csrc/"
    before = _build._lib_path(name)
    with open(headers[0], "a") as f:
        f.write("\n// edited\n")
    assert _build._lib_path(name) != before


def test_source_and_flag_edits_rename_the_library(csrc_copy, monkeypatch):
    before = {n: _build._lib_path(n) for n in _build.KERNELS}
    with open(csrc_copy / "paged_decode.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.KERNELS}
    assert after["paged_decode"] != before["paged_decode"]
    assert all(after[n] == before[n] for n in _build.KERNELS
               if n != "paged_decode")
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    assert all(_build._lib_path(n) != after[n] for n in _build.KERNELS)
