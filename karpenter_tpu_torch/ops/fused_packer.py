"""Wrappers of the hand-written CUDA FFD pack (``csrc/ffd_pack.cu``).

Port of the TPU kernel ``karpenter_tpu/ops/pallas_packer.py:_pack_step``
(launched by ``_pallas_pack`` through ``pl.pallas_call``), which computes
the function of ``karpenter_tpu/ops/packer.py:_pack_core``.  On the card the
pack is two launches:

- `choose_config`: one block per class picks the config a new node of the
  class opens on (``_pack_core``'s hoisted new-node choice);
- `ffd_scan`: one block walks the classes in order (the sequential scan),
  with the slot state resident in shared memory; where that state does not
  fit one block (`scan_kernel`, by shape alone) the same scan runs as
  `ffd_scan_global`, with the state in device memory.

Each wrapper takes CPU tensors to its plain PyTorch version
(ops/packer.py) and CUDA tensors to its kernel; for a CUDA tensor it
launches the kernel or raises, never falls back.  `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that its solves went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from karpenter_tpu_torch.ops import _build
from karpenter_tpu_torch.ops.packer import (
    choose_config_reference,
    ffd_scan_reference,
)

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: Dict[str, int] = {"choose_config": 0, "ffd_scan": 0, "ffd_scan_global": 0}

# the resident scan's shared memory and axes (kRing, kTile, kXchgBytes and
# kMaxR in ffd_pack.cu)
SCAN_RING = 8  # feasibility rows in flight or resident
SCAN_TILE = 32  # classes per tile of class rows (two tiles resident)
SCAN_XCHG_BYTES = 2 * 32 * 4 + 32 * 4 + 2 * 32 * 4  # per-warp exchange words
SMEM_PER_BLOCK = 232_448  # the most a Hopper block may use (227 KB)
MAX_SLOTS_PER_THREAD = 2  # the largest template instance of ffd_scan_kernel
MAX_AXES = 31  # resource axes the resident scan's class flags cover

OBJECTIVES = {"nodes": 0, "cost": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, with its C signatures declared once."""
    lib = _build.load("ffd_pack")
    if lib.ffd_scan.argtypes is None:
        lib.ffd_choose_config.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 3 + [_P]
        lib.ffd_choose_config.restype = _I
        lib.ffd_scan.argtypes = [_P] * 13 + [_I] * 9 + [_P] * 5 + [_P]
        lib.ffd_scan.restype = _I
        lib.ffd_scan_global.argtypes = [_P] * 13 + [_I] * 6 + [_P] * 6 + [_P]
        lib.ffd_scan_global.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launched(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")
    LAUNCHES[fn] += 1


def choose_config(
    req: torch.Tensor,  # [G, R] float32
    maxper: torch.Tensor,  # [G] int32
    feas: torch.Tensor,  # [G, C] bool
    alloc: torch.Tensor,  # [C, R] float32
    price: torch.Tensor,  # [C] float32
    openable: torch.Tensor,  # [C] bool
    objective: str = "nodes",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class new-node choice: int32 ``(c_star, new_ok, per)``."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    dev = req.device
    if dev.type == "cpu":
        return choose_config_reference(
            req, maxper, feas, alloc, price, openable, objective
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    G, R = req.shape
    C = alloc.shape[0]
    for name, t, dt, shp in (
        ("req", req, torch.float32, (G, R)),
        ("maxper", maxper, torch.int32, (G,)),
        ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, torch.float32, (C, R)),
        ("price", price, torch.float32, (C,)),
        ("openable", openable, torch.bool, (C,)),
    ):
        _check(name, t, dt, shp, dev)
    c_star, new_ok, per = (
        torch.empty(G, dtype=torch.int32, device=dev) for _ in range(3)
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_choose_config(
            req.data_ptr(), maxper.data_ptr(), feas.data_ptr(),
            alloc.data_ptr(), price.data_ptr(), openable.data_ptr(),
            G, C, R, OBJECTIVES[objective],
            c_star.data_ptr(), new_ok.data_ptr(), per.data_ptr(), stream,
        )
    _launched("choose_config", err)
    return c_star, new_ok, per


def scan_threads(K: int) -> int:
    """Threads of the one scan block, either kernel (``scan_threads`` in
    ffd_pack.cu)."""
    return min(max((K + 31) // 32 * 32, 32), 1024)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def resident_layout(K: int, R: int, S: int, C: int) -> Tuple[int, int]:
    """``(slots per thread, dynamic shared-memory bytes)`` of the resident
    scan: a ring of `SCAN_RING` feasibility rows (each 16-byte aligned),
    two tiles of `SCAN_TILE` class rows (req, alloc[c_star], six int32
    scalars and a word of flags), the exchange words, and per slot cfg,
    npods, used [R], cached alloc [R] and the signature counters [S].
    Slots per thread is the power of two that covers K with
    `scan_threads` threads."""
    threads = scan_threads(K)
    per_thread = 1
    while per_thread * threads < K:
        per_thread *= 2
    tiles = 2 * SCAN_TILE * 4 * (2 * R + 7)
    state = 4 * per_thread * threads * (2 * R + 2 + S)
    return per_thread, SCAN_RING * _up16(C) + tiles + SCAN_XCHG_BYTES + state


def feas_copy_bytes(C: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides the feasibility
    row length (``feas`` itself is 16-byte aligned, `_scan_shapes`); 0 if
    none does."""
    return next((b for b in (16, 8, 4) if C % b == 0), 0)


def scan_kernel(K: int, R: int, S: int, C: int) -> str:
    """Which scan kernel runs at these shapes, decided by shape alone:
    ``"ffd_scan"`` (resident) where its slot state fits the shared memory
    of one block with at most `MAX_SLOTS_PER_THREAD` slots a thread, the
    problem has at most `MAX_AXES` resource axes and its feasibility rows
    copy in 4-byte pieces or wider, else ``"ffd_scan_global"``."""
    per_thread, smem = resident_layout(K, R, S, C)
    fits = (per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK
            and R <= MAX_AXES)
    return "ffd_scan" if fits and feas_copy_bytes(C) else "ffd_scan_global"


def _scan_shapes(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0, sig0,
) -> Tuple[int, int, int, int, int]:
    """Checks a scan's card inputs; returns ``(G, C, K, R, S)``."""
    dev = req.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    G, R = req.shape
    C = alloc.shape[0]
    K = used0.shape[0]
    S = sig0.shape[0]
    i32, f32 = torch.int32, torch.float32
    for name, t, dt, shp in (
        ("req", req, f32, (G, R)),
        ("cnt", cnt, i32, (G,)),
        ("maxper", maxper, i32, (G,)),
        ("slot", slot, i32, (G,)),
        ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, f32, (C, R)),
        ("c_star", c_star, i32, (G,)),
        ("new_ok", new_ok, i32, (G,)),
        ("per", per, i32, (G,)),
        ("used0", used0, f32, (K, R)),
        ("cfg0", cfg0, i32, (K,)),
        ("npods0", npods0, i32, (K,)),
        ("sig0", sig0, i32, (S, K)),
    ):
        _check(name, t, dt, shp, dev)
    if feas.data_ptr() % 16:
        raise ValueError("feas must start on a 16-byte boundary")
    if not 0 <= int(next0) <= K:
        raise ValueError(f"next0={next0} outside [0, {K}]")
    return G, C, K, R, S


def _scan_outputs(G: int, K: int, R: int, dev) -> Tuple[torch.Tensor, ...]:
    """``take, leftover, node_cfg, node_pods, node_used`` on ``dev``."""
    i32 = torch.int32
    return (
        torch.empty((G, K), dtype=i32, device=dev),
        torch.empty(G, dtype=i32, device=dev),
        torch.empty(K, dtype=i32, device=dev),
        torch.empty(K, dtype=i32, device=dev),
        torch.empty((K, R), dtype=torch.float32, device=dev),
    )


def _ptrs(*ts) -> list:
    return [t.data_ptr() for t in ts]


def ffd_scan(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0,
) -> Tuple[torch.Tensor, ...]:
    """The sequential class scan: ``(take [G, K], leftover [G],
    node_cfg [K], node_pods [K], node_used [K, R])``.  On the card it runs
    the kernel `scan_kernel` picks for the shapes: the resident one, or the
    global one where the resident state does not fit."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    G, C, K, R, S = _scan_shapes(*args)
    if scan_kernel(K, R, S, C) == "ffd_scan_global":
        return _launch_global(args, (G, C, K, R, S))
    per_thread, smem = resident_layout(K, R, S, C)
    outs = _scan_outputs(G, K, R, req.device)
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), per_thread, smem,
            feas_copy_bytes(C), *_ptrs(*outs), stream,
        )
    _launched("ffd_scan", err)
    return outs


def ffd_scan_global(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0,
) -> Tuple[torch.Tensor, ...]:
    """`ffd_scan` through the global kernel at any shape (`ffd_scan` takes
    it only where the resident state does not fit)."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    return _launch_global(args, _scan_shapes(*args))


def _launch_global(args, shapes) -> Tuple[torch.Tensor, ...]:
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    outs = _scan_outputs(G, K, R, req.device)
    sigcnt = torch.empty((S, K), dtype=torch.int32, device=req.device)  # scratch
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_global(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), *_ptrs(*outs, sigcnt), stream,
        )
    _launched("ffd_scan_global", err)
    return outs


def ffd_pack(
    req, cnt, maxper, slot, feas, alloc, price, openable,
    used0, cfg0, npods0, next0: int, sig0, *, objective: str = "nodes",
) -> Tuple[torch.Tensor, ...]:
    """The whole pack: `choose_config` then `ffd_scan`, on the device the
    tensors lie on."""
    c_star, new_ok, per = choose_config(
        req, maxper, feas, alloc, price, openable, objective
    )
    return ffd_scan(
        req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
        used0, cfg0, npods0, next0, sig0,
    )
