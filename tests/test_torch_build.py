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


def test_edited_header_gets_a_new_library(tree):
    """A source includes the shared header (csrc/*.cuh): editing it
    rebuilds every source."""
    (tree / "csrc" / "common.cuh").write_text("// helpers\n")
    before = _build._lib_path("k")
    (tree / "csrc" / "common.cuh").write_text("// helpers, edited\n")
    assert _build._lib_path("k") != before


# ------------------------------------------------- many threads at first use
THREADS = 8


def _race(fn) -> list:
    """``fn`` from THREADS threads released at once (a short switch
    interval), their results or errors."""
    import sys
    import threading

    barrier = threading.Barrier(THREADS)
    out = []

    def run():
        barrier.wait(timeout=30)
        try:
            out.append(fn())
        except Exception as exc:  # pragma: no cover - the failure path
            out.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return out


def test_first_load_from_many_threads_builds_once(tree, monkeypatch):
    """The service's handler threads may all make the first call: one
    build, one library, every thread gets it."""
    import time

    builds = []

    def build_all(names):
        builds.append(tuple(names))
        time.sleep(0.05)  # an nvcc run: long enough for every thread to arrive
        return {n: tree / f"lib{n}.so" for n in names}

    class Lib:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    libs = _race(lambda: _build.load("k"))
    assert builds == [("k",)]
    assert len(libs) == THREADS and all(lib is libs[0] for lib in libs), libs


def test_library_signatures_declared_once(monkeypatch):
    """`fused_packer._lib` from many threads: one load, its C signatures
    declared before any thread gets the library."""
    import time
    import types

    from karpenter_tpu_torch.ops import fused_packer

    loads = []

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    def load(name):
        loads.append(name)
        time.sleep(0.05)
        return Lib()

    monkeypatch.setattr(fused_packer, "_LIB", None)
    monkeypatch.setattr(fused_packer, "_build", types.SimpleNamespace(load=load))
    libs = _race(lambda: (fused_packer._lib(), fused_packer._lib().ffd_scan.argtypes))
    assert loads == ["ffd_pack"]
    assert all(lib is libs[0][0] and argtypes for lib, argtypes in libs), libs


def test_launch_counts_from_many_threads(monkeypatch):
    """Every launch counted under the lock: no lost update."""
    from karpenter_tpu_torch.ops import fused_packer

    monkeypatch.setattr(fused_packer, "LAUNCHES", dict(fused_packer.LAUNCHES))
    fused_packer.reset_launches()

    def launches():
        for _ in range(2000):
            fused_packer._launched("ffd_scan_fleet", 0)

    _race(launches)
    assert fused_packer.LAUNCHES["ffd_scan_fleet"] == THREADS * 2000


def test_mesh_library_exports_and_declares_the_shard_scan(monkeypatch):
    """``csrc/ffd_pack.cu`` exports ``mesh_shard_scan`` (the cluster scan's
    shard mode) and ``csrc/mesh_pack.cu`` the pair's entries, and
    `fused_packer._lib()` declares the scan's C signature (an array of
    `ShardArgs`, D, G, the device, the stream) on first load."""
    import re
    import types

    from karpenter_tpu_torch.ops import fused_packer

    for source, entries in (("ffd_pack", ("mesh_shard_scan",)),
                            ("mesh_pack", ("mesh_assemble_feasibility", "mesh_shard_cap",
                                           "mesh_shard_apply"))):
        src = (_build.CSRC / f"{source}.cu").read_text()
        exported = src[src.index('extern "C" {'):]
        for entry in entries:
            assert re.search(rf"^int {entry}\(", exported, re.M), entry
    assert not re.search(r"^int mesh_shard_scan\(", (_build.CSRC / "mesh_pack.cu").read_text(),
                         re.M)

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(fused_packer, "_LIB", None)
    monkeypatch.setattr(fused_packer, "_build", types.SimpleNamespace(load=lambda name: Lib()))
    lib = fused_packer._lib()
    c = fused_packer.ctypes
    assert lib.mesh_shard_scan.argtypes == [c.POINTER(fused_packer.ShardArgs), c.c_int,
                                            c.c_int, c.c_int, c.c_void_p]
    assert lib.mesh_shard_scan.restype is c.c_int
    assert fused_packer._lib() is lib
