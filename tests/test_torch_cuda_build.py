"""The port's kernel builder names each library by everything that goes
into it: the source, every shared ``csrc/*.cuh`` header and the flags.  A
header edited without its sources must not reuse a stale library.  No
``nvcc`` runs here: only the library paths are computed, over a temporary
``CSRC``."""

import os

import pytest

from brpc_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_bytes(b'#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_bytes(b"int b;\n")
    (tmp_path / "shared.cuh").write_bytes(b"#pragma once\nint x;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    return tmp_path


def test_path_is_stable_and_per_source(csrc):
    a = cuda_build._lib_path("a.cu")
    assert a == cuda_build._lib_path("a.cu")
    assert os.path.basename(a).startswith("liba-") and a.endswith(".so")
    assert os.path.dirname(a) == cuda_build.BUILD_DIR
    assert a != cuda_build._lib_path("b.cu")


def test_header_change_renames_every_library(csrc):
    before = {s: cuda_build._lib_path(s) for s in ("a.cu", "b.cu")}
    (csrc / "shared.cuh").write_bytes(b"#pragma once\nint x, y;\n")
    after = {s: cuda_build._lib_path(s) for s in ("a.cu", "b.cu")}
    assert all(before[s] != after[s] for s in before)


def test_new_header_and_source_change_rename(csrc):
    a = cuda_build._lib_path("a.cu")
    (csrc / "other.cuh").write_bytes(b"#pragma once\n")
    b = cuda_build._lib_path("a.cu")
    assert b != a
    (csrc / "a.cu").write_bytes(b'#include "shared.cuh"\nint a2;\n')
    assert cuda_build._lib_path("a.cu") != b


def test_flags_and_non_headers(csrc, monkeypatch):
    a = cuda_build._lib_path("a.cu")
    # files that are not headers are not hashed into other libraries
    (csrc / "notes.txt").write_bytes(b"anything")
    assert cuda_build._lib_path("a.cu") == a
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        [*cuda_build.NVCC_FLAGS, "-lineinfo"])
    assert cuda_build._lib_path("a.cu") != a


def test_repo_sources_include_the_shared_header():
    """Both flash sources include flash_mma.cuh, so it is hashed into
    their libraries."""
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(cuda_build.CSRC, src)) as f:
            assert '#include "flash_mma.cuh"' in f.read()
    assert os.path.isfile(os.path.join(cuda_build.CSRC, "flash_mma.cuh"))
