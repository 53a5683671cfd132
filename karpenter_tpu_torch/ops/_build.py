"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with `ctypes`.  Builds land
in ``karpenter_tpu_torch/_build/`` (ignored by git), keyed by a hash of the
source and the headers it may include (``csrc/*.cuh``), so an edited
kernel never loads a stale library.  `build_all`
starts one ``nvcc`` per source at once and waits for them together.

Flags: IEEE division and no ``--use_fast_math`` (the float rules the
kernels' bit-equality with the JAX reference rests on), and ``-Xptxas -v``
so each kernel's registers, shared memory and spills are kept in
`BUILD_LOG` for the caller to print.  The log is saved beside the library
and read back when a built library is reused, so `BUILD_LOG` holds every
source's summary either way.

`load` is safe from many threads at once (the solver service solves from
its handler threads): the first caller builds and loads under a lock, and
the others wait for its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from karpenter_tpu_torch.utils.locks import make_lock

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("ffd_pack", "latency_probe", "mesh_pack")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

BUILD_LOG: Dict[str, str] = {}  # source name -> nvcc/ptxas output
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = make_lock("_build._LOAD_LOCK")  # one build and load of a source at a time


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not yet built, all ``nvcc`` runs at once.
    Raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        lib = _lib_path(name)
        out[name] = lib
        if lib.exists() and lib.with_suffix(".log").exists():
            BUILD_LOG[name] = lib.with_suffix(".log").read_text()
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  The
    build and load time is the port's one compile: the device observatory
    records it once a process as ``karpenter_device_compile_seconds{fn}``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            from karpenter_tpu_torch.obs.device import OBSERVATORY

            t0 = time.perf_counter()
            path = build_all([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            OBSERVATORY.record_build(name, time.perf_counter() - t0)
    return lib
