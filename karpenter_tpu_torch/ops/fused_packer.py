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
  `ffd_scan_cluster`, with the state split over the shared memory of a
  thread-block cluster of 2, 4 or 8 CTAs (`cluster_layout`), and where it
  does not fit a cluster either, as `ffd_scan_global`, with the state in
  device memory.

Each wrapper takes CPU tensors to its plain PyTorch version
(ops/packer.py) and CUDA tensors to its kernel; for a CUDA tensor it
launches the kernel or raises, never falls back.  `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that its solves went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from karpenter_tpu_torch.ops import _build
from karpenter_tpu_torch.ops.packer import (
    choose_config_reference,
    ffd_scan_reference,
)

# kernel name -> launches since the last reset (plain integers)
LAUNCHES: Dict[str, int] = {
    "choose_config": 0, "ffd_scan": 0, "ffd_scan_cluster": 0, "ffd_scan_global": 0,
}

# the resident scan's shared memory and axes (kRing, kTile, kXchgBytes and
# kMaxR in ffd_pack.cu)
SCAN_RING = 8  # feasibility rows in flight or resident
SCAN_TILE = 32  # classes per tile of class rows (two tiles resident)
SCAN_XCHG_BYTES = 2 * 32 * 4 + 32 * 4 + 2 * 32 * 4  # per-warp exchange words
SMEM_PER_BLOCK = 232_448  # the most a Hopper block may use (227 KB)
MAX_SLOTS_PER_THREAD = 2  # the largest template instance of ffd_scan_kernel
MAX_AXES = 31  # resource axes the resident scan's class flags cover
# the cluster scan: portable cluster sizes, and its exchange words per CTA
# of the cluster (kClusterXchgBytes in ffd_pack.cu: xtot [2][32] uint2,
# xsum [32], xleft [2][32])
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_XCHG_BYTES = 2 * 32 * 8 + 32 * 4 + 2 * 32 * 4

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
        lib.ffd_scan_cluster.argtypes = [_P] * 13 + [_I] * 11 + [_P] * 5 + [_P]
        lib.ffd_scan_cluster.restype = _I
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
    if err == -2:
        raise RuntimeError(f"{fn}: no thread-block cluster of this shape fits the card")
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
    """Per-class new-node choice: int32 ``(c_star, new_ok, per)``; on the
    card three contiguous rows of one tensor."""
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
    out = torch.empty((3, G), dtype=torch.int32, device=dev)
    base = out.data_ptr()  # rows c_star, new_ok, per
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_choose_config(
            *_ptrs(req, maxper, feas, alloc, price, openable),
            G, C, R, OBJECTIVES[objective], base, base + 4 * G, base + 8 * G, stream,
        )
    _launched("choose_config", err)
    return out.unbind(0)


def scan_threads(K: int) -> int:
    """Threads of the one scan block, either kernel (``scan_threads`` in
    ffd_pack.cu)."""
    return min(max((K + 31) // 32 * 32, 32), 1024)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def _block_layout(K: int, R: int, S: int, C: int, xchg: int) -> Tuple[int, int]:
    """``(slots per thread, dynamic shared-memory bytes)`` of one block that
    holds K slots: a ring of `SCAN_RING` feasibility rows (each 16-byte
    aligned), two tiles of `SCAN_TILE` class rows (req, alloc[c_star], six
    int32 scalars and a word of flags), ``xchg`` exchange bytes, and per
    slot cfg, npods, used [R], cached alloc [R] and the signature counters
    [S].  Slots per thread is the power of two that covers K with
    `scan_threads` threads."""
    threads = scan_threads(K)
    per_thread = 1
    while per_thread * threads < K:
        per_thread *= 2
    tiles = 2 * SCAN_TILE * 4 * (2 * R + 7)
    state = 4 * per_thread * threads * (2 * R + 2 + S)
    return per_thread, SCAN_RING * _up16(C) + tiles + xchg + state


def resident_layout(K: int, R: int, S: int, C: int) -> Tuple[int, int]:
    """``(slots per thread, dynamic shared-memory bytes)`` of the resident
    scan (`_block_layout` with its `SCAN_XCHG_BYTES`)."""
    return _block_layout(K, R, S, C, SCAN_XCHG_BYTES)


def cluster_layout(
    K: int, R: int, S: int, C: int, ctas: Optional[int] = None,
) -> Optional[Tuple[int, int, int]]:
    """``(ctas, slots per thread, dynamic shared-memory bytes per CTA)`` of
    the cluster scan: the largest cluster size N in `CLUSTER_SIZES` (or
    the given ``ctas``) whose CTA holds ceil(K / N) slots with at most
    `MAX_SLOTS_PER_THREAD` slots a thread at `scan_threads` threads and
    fits `SMEM_PER_BLOCK`: the ring, the tiles, N x `CLUSTER_XCHG_BYTES`
    exchange words and the state of its slots.  None where no size fits.
    The largest, because a CTA with fewer slots has a shorter chain a step
    while the cluster barrier costs about the same at every size (on an
    H100, 8 CTAs of 512 threads scan 4096 slots faster than 4 or 2 CTAs of
    1024: PERF.md)."""
    for n in sorted(CLUSTER_SIZES, reverse=True) if ctas is None else (ctas,):
        per_thread, smem = _block_layout(-(-K // n), R, S, C, n * CLUSTER_XCHG_BYTES)
        if per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK:
            return n, per_thread, smem
    return None


def wrap_guard(K: int) -> int:
    """The cap T below which no sum of K caps can pass int32: the largest
    power of two (at most 2^30, the class cap) with K * (T - 1) < 2^31.
    Where every cap is below T the scan takes sum(take1) in closed form;
    where one is not it takes the wrapped sum, as ``_pack_core`` wraps."""
    t = 1
    while t < 2**30 and K * (2 * t - 1) < 2**31:
        t *= 2
    return t


def feas_copy_bytes(C: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides the feasibility
    row length (``feas`` itself is 16-byte aligned, `_scan_shapes`); 0 if
    none does."""
    return next((b for b in (16, 8, 4) if C % b == 0), 0)


def scan_kernel(K: int, R: int, S: int, C: int) -> str:
    """Which scan kernel runs at these shapes, decided by shape alone.
    Where the problem has at most `MAX_AXES` resource axes and its
    feasibility rows copy in 4-byte pieces or wider: ``"ffd_scan"``
    (resident) where its slot state fits the shared memory of one block
    with at most `MAX_SLOTS_PER_THREAD` slots a thread, else
    ``"ffd_scan_cluster"`` where it fits a cluster (`cluster_layout`).
    Otherwise ``"ffd_scan_global"``."""
    if R > MAX_AXES or not feas_copy_bytes(C):
        return "ffd_scan_global"
    per_thread, smem = resident_layout(K, R, S, C)
    if per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK:
        return "ffd_scan"
    if cluster_layout(K, R, S, C) is not None:
        return "ffd_scan_cluster"
    return "ffd_scan_global"


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
    the kernel `scan_kernel` picks for the shapes: the resident one, the
    cluster one where the resident state does not fit a block, or the
    global one where it does not fit a cluster either."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    G, C, K, R, S = _scan_shapes(*args)
    kernel = scan_kernel(K, R, S, C)
    if kernel == "ffd_scan_global":
        return _launch_global(args, (G, C, K, R, S))
    if kernel == "ffd_scan_cluster":
        return _launch_cluster(args, (G, C, K, R, S), cluster_layout(K, R, S, C))
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


def ffd_scan_cluster(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0, *, ctas: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """`ffd_scan` through the cluster kernel, on a cluster of ``ctas`` CTAs
    (default: the size `cluster_layout` picks).  Raises where that cluster
    does not hold the shapes (`ffd_scan` takes this kernel only where
    `scan_kernel` says so)."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    G, C, K, R, S = shapes = _scan_shapes(*args)
    layout = cluster_layout(K, R, S, C, ctas)
    if layout is None or R > MAX_AXES or not feas_copy_bytes(C):
        raise ValueError(f"no cluster{'' if ctas is None else f' of {ctas} CTAs'} "
                         f"holds K={K}, R={R}, S={S}, C={C}")
    return _launch_cluster(args, shapes, layout)


def _launch_cluster(args, shapes, layout) -> Tuple[torch.Tensor, ...]:
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    ctas, per_thread, smem = layout
    outs = _scan_outputs(G, K, R, req.device)
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_cluster(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), ctas, per_thread, smem,
            feas_copy_bytes(C), wrap_guard(K), *_ptrs(*outs), stream,
        )
    _launched("ffd_scan_cluster", err)
    return outs


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
