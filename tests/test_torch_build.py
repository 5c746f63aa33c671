"""PyTorch port, kernel build: the library's name is a digest of the
source, of every header it includes from ``csrc/`` and of nvcc's flags,
so an edited header rebuilds and an unrelated file does not.  Needs no
``nvcc``: ``library_path`` only reads the sources."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary csrc/ holding k.cu, which includes a.cuh, which
    includes b.cuh, beside an unrelated u.cuh."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    'int a;\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "u.cuh").write_text("int u;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_includes_from_csrc(csrc):
    assert [p.name for p in build._sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_library_path_changes_with_an_included_file(csrc, edited):
    before = build.library_path("k")
    path = csrc / edited
    path.write_text(path.read_text() + "int edited;\n")
    after = build.library_path("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("k-")


def test_library_path_ignores_an_unrelated_file(csrc):
    before = build.library_path("k")
    (csrc / "u.cuh").write_text("int u, v;\n")
    (csrc / "other.cu").write_text("int other;\n")
    assert build.library_path("k") == before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    assert build.library_path("k") != before


def test_the_flash_library_covers_its_header():
    """The wgmma header and, through it, the TMA header."""
    names = [p.name for p in build._sources("flash_attention")]
    assert names == ["flash_attention.cu", "flash_attention_wgmma.cuh",
                     "tma.cuh"]


def test_the_wkv6_library_covers_the_tma_header():
    names = [p.name for p in build._sources("wkv6")]
    assert names == ["wkv6.cu", "tma.cuh"]


def test_the_moe_gmm_library_covers_the_wgmma_and_tma_headers():
    """The grouped product builds on the forward's wgmma header
    (descriptors, fences) and the TMA header."""
    names = [p.name for p in build._sources("moe_gmm")]
    assert sorted(names) == ["flash_attention_wgmma.cuh", "moe_gmm.cu",
                             "tma.cuh"]
    assert names[0] == "moe_gmm.cu"


def test_the_flash_bwd_library_covers_the_wgmma_headers():
    """The backward's wgmma header, the forward's wgmma header it builds
    on (descriptors, products, tensor maps) and the TMA header."""
    names = [p.name for p in build._sources("flash_attention_bwd")]
    assert names == ["flash_attention_bwd.cu", "flash_attention_bwd_wgmma.cuh",
                     "flash_attention_wgmma.cuh", "tma.cuh"]
