"""The CUDA build's cache: a reused library brings its ptxas summary back."""

import pytest

from karpenter_tpu_torch.ops import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "BUILD_LOG", {})

    def no_nvcc():
        raise RuntimeError("nvcc called")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    return tmp_path


def test_cached_library_reads_back_its_log(tree):
    lib = _build._lib_path("k")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 40 registers\n")
    assert _build.build_all(["k"]) == {"k": lib}
    assert _build.BUILD_LOG["k"] == "ptxas info    : Used 40 registers\n"


def test_library_without_its_log_is_rebuilt(tree):
    lib = _build._lib_path("k")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc called"):
        _build.build_all(["k"])


def test_edited_source_gets_a_new_library(tree):
    before = _build._lib_path("k")
    (tree / "csrc" / "k.cu").write_text("// kernel, edited\n")
    assert _build._lib_path("k") != before
