"""The kernel builder's staleness rule (`_build._stale`): a library is
rebuilt when its source or any header beside it (csrc/hopper.cuh, which
several kernels include) is newer than it, so an edited header never leaves
a stale library behind."""

import os

import pytest

from quantizedattention_tpu_torch import _build


@pytest.fixture
def tree(tmp_path):
    src, hdr, lib = tmp_path / "k.cu", tmp_path / "shared.cuh", tmp_path / "libk.so"
    for f in (src, hdr, lib):
        f.write_text("")
    os.utime(src, (100, 100))
    os.utime(hdr, (100, 100))
    os.utime(lib, (200, 200))
    return src, hdr, lib


def test_library_newer_than_source_and_headers_is_fresh(tree):
    src, _, lib = tree
    assert not _build._stale(str(lib), str(src))


@pytest.mark.parametrize("which", ["source", "header"])
def test_newer_source_or_header_makes_the_library_stale(tree, which):
    src, hdr, lib = tree
    os.utime(src if which == "source" else hdr, (300, 300))
    assert _build._stale(str(lib), str(src))


def test_missing_library_is_stale(tree):
    src, _, lib = tree
    lib.unlink()
    assert _build._stale(str(lib), str(src))


def test_the_kernels_share_their_hopper_header():
    """The shared header sits beside the kernel sources, where the rule
    looks, and the three kernels built on it include it."""
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "hopper.cuh"))
    for name in ("int8_fwd", "int8_linear", "int4_linear"):
        with open(_build._kernel_paths(name)[0]) as f:
            assert '#include "hopper.cuh"' in f.read()
