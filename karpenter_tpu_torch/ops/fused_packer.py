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
  thread-block cluster of 2, 4 or 8 CTAs (`cluster_layout`); where it does
  not fit a cluster either, as `ffd_scan_grid`, with the state split over
  a grid of co-resident clusters that exchange each class's totals through
  device memory (`grid_layout`); and past the grid, or past `MAX_AXES`
  resource axes, as `ffd_scan_global`, with the state in device memory.

The consolidation verdicts (the JAX package's ``removal_verdict_kernel``
and ``population_verdict_kernel``, jitted XLA functions) run B what-if
problems over one base, `ffd_scan_batch`: first the frontier-window scan
(``ffd_scan_window``, one CTA an element over the first `window_layout`
slots, where each element's frontier lies), then, for the elements that
leave that window, the scan `scan_kernel` picks with a batch axis, one
block, one cluster or one group of the grid's clusters per element
(`window_plan` says which of the two launches the shapes need).  `verdict_rows` finishes them (each
element's six-value verdict, three launches: a record per element, a pass
over the configs shared by groups of elements, the rows), and
`population_prologue` (one launch) derives each removal mask's counts,
removed slots and class order.

The admission fast path (the JAX package's ``admit_kernel``, a jitted XLA
function) scores one class against the live nodes of a resident state:
`admit`, one launch of one block (`admit_threads`).

The multi-tenant solver service's fleet pack (the JAX package's
``fleet_pack_kernel``, a jitted vmap of ``_pack_core``) solves B problems of
one shape, each with arrays of its own: `fleet_pack`, `choose_config` with a
grid y of B and the scan `scan_kernel` picks in its fleet mode, one block,
one cluster or one group of the grid's clusters an element.

The sharded pack over a device mesh (parallel/mesh.py, replacing the JAX
package's mesh, jitted XLA partitioned by GSPMD) is the second library,
``csrc/mesh_pack.cu``: `assemble_feasibility` (the dense feasibility mask
from the factorized admission; `assemble_tiles` writes every tile of a
device in place in one launch), and the scan over the
classes (`mesh_pack`): `ffd_shard_scan`, one thread-block cluster launch
for the data shards of one device (the shard mode of ``ffd_pack.cu``'s
cluster scan), or, where the rows lie on several devices, per class
`ffd_shard_cap` and `ffd_shard_apply` a data shard, with the exchanges
between them (`shard_scan_kernel` picks); the choice,
`choose_config_shard` (a (data, model) tile of the new-node choice), is
the shard mode of ``ffd_pack.cu``'s ``choose_config_kernel``.

Each wrapper takes CPU tensors to its plain PyTorch version
(ops/packer.py) and CUDA tensors to its kernel; for a CUDA tensor it
launches the kernel or raises, never falls back.  `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that its solves went
through the kernels.  The service solves from many threads at once: the
library's first load and the counts are taken under a lock, and each
launch goes to the calling thread's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.ops import _build
from karpenter_tpu_torch.ops.packer import (
    MESH_REC,
    REC_NONE,
    RV_WIDTH,
    MeshPlan,
    MeshShard,
    assemble_feasibility_reference,
    assemble_tiles_reference,
    choose_config_reference,
    choose_config_shard_reference,
    ffd_shard_apply_reference,
    ffd_shard_cap_reference,
    ffd_shard_scan_reference,
    mesh_assemble_copies,
    mesh_assemble_masks,
    mesh_assemble_plan,
    mesh_assemble_reference,
    mesh_outputs,
    mesh_pack_reference,
    mesh_scan,
    mesh_shards,
    ffd_scan_batch_reference,
    ffd_scan_reference,
    fleet_pack_reference,
    population_prologue_reference,
    verdict_rows_reference,
)
from karpenter_tpu_torch.utils.locks import make_lock

# kernel name -> launches since the last reset (plain integers, updated
# under `_LOCK`).  A scan launched with a what-if batch axis
# (`ffd_scan_batch`) counts under its kernel's name with "_batched", and a
# fleet launch (`fleet_pack`, choose_config too) with "_fleet": the solve's
# counts stay the solve's.
LAUNCHES: Dict[str, int] = {
    "choose_config": 0, "ffd_scan": 0, "ffd_scan_cluster": 0, "ffd_scan_global": 0,
    "ffd_scan_batched": 0, "ffd_scan_cluster_batched": 0, "ffd_scan_global_batched": 0,
    "ffd_scan_window_batched": 0,
    "verdict_summary": 0, "verdict_configs": 0, "verdict_write": 0, "population_pairs": 0,
    "admit_kernel": 0,
    "choose_config_fleet": 0, "ffd_scan_fleet": 0, "ffd_scan_cluster_fleet": 0,
    "ffd_scan_global_fleet": 0,
    "ffd_scan_grid": 0, "ffd_scan_grid_batched": 0, "ffd_scan_grid_fleet": 0,
    "assemble_feasibility": 0, "choose_config_shard": 0, "ffd_shard_scan": 0,
    "ffd_shard_cap": 0, "ffd_shard_apply": 0,
}
OBSERVATORY.kernel_launches = LAUNCHES  # /debug/device's "launches"
# the launches of the sharded pack (csrc/mesh_pack.cu and the shard modes of
# csrc/ffd_pack.cu), in their order: the scan is either ffd_shard_scan or
# the pair after it (`shard_scan_kernel`)
MESH_KERNELS = ("assemble_feasibility", "choose_config_shard", "ffd_shard_scan",
                "ffd_shard_cap", "ffd_shard_apply")
# the library's first load (its build and its C signatures) and LAUNCHES
_LOCK = make_lock("fused_packer._LOCK")
# the launches of `verdict_rows`, in order
VERDICT_ROWS_LAUNCHES = ("verdict_summary", "verdict_configs", "verdict_write")

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
# the cluster scan's shard mode: its most data shards, a portable cluster
# (kMaxShards in csrc/common.cuh)
MAX_SHARDS = 8
# the grid scan: CTAs a cluster (the largest portable), its exchange words
# per CTA of the cluster (kGridXchgBytes: xtot [2][32] uint2, xsum [32]), its
# most clusters (kMaxGridClusters: a warp's lanes read their entries), the
# clusters of GRID_CTAS one-SM CTAs an H100 80GB HBM3 holds at once (its
# cudaOccupancyMaxActiveClusters, measured: PERF.md), which `scan_kernel`
# plans with where no card is present, and the clock cycles a wait on
# another cluster may take before the kernel traps (about 2 s at the H100's
# clock)
GRID_CTAS = 8
GRID_XCHG_BYTES = 2 * 32 * 8 + 32 * 4
MAX_GRID_CLUSTERS = 32
GRID_CLUSTERS = 15
GRID_SPIN_CYCLES = 1 << 32

# the frontier-window scan (kWinThreads, kWinXchgBytes in ffd_pack.cu): its
# threads, its window sizes (1, 2 or 4 rounds of its threads), largest
# first, and the shared memory a SM holds for two of its CTAs (228 KB, 1 KB
# of it reserved a CTA)
WINDOW_THREADS = 256
WINDOW_SLOTS = (1024, 512, 256)
WINDOW_XCHG_BYTES = SCAN_XCHG_BYTES + 2 * 32 * 4
WINDOW_TWO_A_SM = 233_472 // 2 - 1024

OBJECTIVES = {"nodes": 0, "cost": 1}
MAX_BATCH = 65_535  # elements of one batched scan launch (its grid's y extent)
# Where set to a list, `ffd_scan_batch` appends one record a launch group
# (its shapes, W, the plan, the window's `done` mask and the node_cfg
# output), for a caller that reads them after a synchronize; None: off.
WINDOW_RECORDS: Optional[list] = None

_P, _I = ctypes.c_void_p, ctypes.c_int


class ShardArgs(ctypes.Structure):
    """One data shard's buffers as the mesh kernels take them (struct
    ShardArgs in csrc/common.cuh), built once a solve."""

    _fields_ = [(name, _P) for name in (
        "req", "cnt", "maxper", "slot", "feas", "alloc", "rec", "xchg", "used", "cfg",
        "npods", "sig", "take", "leftover", "cap", "nxt")] + [
        (name, _I) for name in ("G", "C", "R", "S", "M", "D", "d", "k0", "Kd", "K")]


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None  # csrc/ffd_pack.cu
_LIBS: Dict[str, ctypes.CDLL] = {}  # the other sources (csrc/mesh_pack.cu)


def _loaded(source: str) -> Optional[ctypes.CDLL]:
    return _LIB if source == "ffd_pack" else _LIBS.get(source)


def _lib(source: str = "ffd_pack") -> ctypes.CDLL:
    """The built library of ``csrc/<source>.cu``, with its C signatures
    declared once: the first caller builds and declares under `_LOCK`, the
    others wait for it."""
    lib = _loaded(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _loaded(source)
        return lib if lib is not None else _declare(source, _build.load(source))


def _declare(source: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    global _LIB
    if source == "mesh_pack":
        return _declare_mesh(lib)
    if lib.ffd_scan.argtypes is None:
        lib.ffd_choose_config.argtypes = [_P] * 6 + [_I] * 5 + [_P] * 3 + [_P]
        lib.ffd_choose_config.restype = _I
        lib.ffd_choose_config_shard.argtypes = [_P] * 6 + [_I] * 7 + [_P, _P]
        lib.ffd_choose_config_shard.restype = _I
        batch = [_I] + [_P] * 5  # B, perm_b, cnt_b, rm_b, done_b, next0_b
        lib.ffd_scan.argtypes = [_P] * 13 + [_I] * 9 + batch + [_P] * 5 + [_P]
        lib.ffd_scan.restype = _I
        lib.ffd_scan_global.argtypes = [_P] * 13 + [_I] * 6 + batch + [_P] * 6 + [_P]
        lib.ffd_scan_global.restype = _I
        lib.ffd_scan_cluster.argtypes = [_P] * 13 + [_I] * 11 + batch + [_P] * 5 + [_P]
        lib.ffd_scan_cluster.restype = _I
        lib.ffd_scan_grid.argtypes = ([_P] * 13 + [_I] * 12 + [ctypes.c_longlong]
                                      + [_I] + batch + [_P] * 6 + [_P])
        lib.ffd_scan_grid.restype = _I
        lib.ffd_scan_grid_clusters.argtypes = [_I] * 3
        lib.ffd_scan_grid_clusters.restype = _I
        lib.ffd_scan_window.argtypes = [_P] * 12 + [_I] * 10 + [_P] * 3 + [_P] * 6 + [_P]
        lib.ffd_scan_window.restype = _I
        lib.ffd_scan_concurrency.argtypes = [_I] * 5
        lib.ffd_scan_concurrency.restype = _I
        lib.ffd_verdict_scratch_bytes.argtypes = [_I] * 3
        lib.ffd_verdict_scratch_bytes.restype = ctypes.c_longlong
        lib.ffd_verdict_config_tile.argtypes = []
        lib.ffd_verdict_config_tile.restype = _I
        lib.ffd_verdict_max_group.argtypes = []
        lib.ffd_verdict_max_group.restype = _I
        lib.ffd_verdict_max_axes.argtypes = [_I]
        lib.ffd_verdict_max_axes.restype = _I
        lib.ffd_verdict_rows.argtypes = [_P] * 14 + [_I] * 8 + [_P] * 2 + [_P]
        lib.ffd_verdict_rows.restype = _I
        lib.ffd_population_prologue.argtypes = [_P] * 5 + [_I] * 5 + [_P] * 3 + [_P]
        lib.ffd_population_prologue.restype = _I
        lib.ffd_admit.argtypes = [_P] * 7 + [_I] * 6 + [_P] + [_P]
        lib.ffd_admit.restype = _I
        lib.mesh_shard_scan.argtypes = [ctypes.POINTER(ShardArgs), _I, _I, _I, _P]
        lib.mesh_shard_scan.restype = _I
    _LIB = lib
    return lib


def _declare_mesh(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.mesh_shard_cap.argtypes is None:
        lib.mesh_assemble_feasibility.argtypes = [_P] * 7 + [_I] * 3 + [_P, _P] + [_I] * 6 + [_P]
        lib.mesh_assemble_feasibility.restype = _I
        for entry in (lib.mesh_shard_cap, lib.mesh_shard_apply):
            entry.argtypes = [ctypes.POINTER(ShardArgs), _I, _I, _P]
            entry.restype = _I
    _LIBS["mesh_pack"] = lib
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
    with _LOCK:
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
            G, C, R, OBJECTIVES[objective], 1, base, base + 4 * G, base + 8 * G, stream,
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


class GridLayout(NamedTuple):
    """The grid scan's layout (`grid_layout`): each element (the solve's
    scan is one) on a group of ``clusters`` clusters of ``ctas`` CTAs,
    ``groups`` groups at once, each scanning every groups-th element."""

    clusters: int
    groups: int
    ctas: int
    per_thread: int
    smem: int


def grid_layout(K: int, R: int, S: int, max_clusters: int) -> Optional[GridLayout]:
    """The grid scan's layout on a card of ``max_clusters`` co-resident
    clusters: Q, the fewest clusters of `GRID_CTAS` CTAs, at most
    ``max_clusters`` (and `MAX_GRID_CLUSTERS`), whose CTA holds
    ceil(K / (Q x GRID_CTAS)) slots with at most `MAX_SLOTS_PER_THREAD`
    slots a thread at `scan_threads` threads within `SMEM_PER_BLOCK`: the
    class tiles, GRID_CTAS x `GRID_XCHG_BYTES` exchange words and the state
    of its slots; the groups of Q clusters the card holds at once (a batch
    axis's elements in flight), ``max_clusters // Q``; slots per thread and
    shared-memory bytes a CTA.  No feasibility ring (the grid gathers each
    slot's byte), so the row length does not enter.  None where no grid of
    co-resident clusters holds the slots.  The fewest, because each cluster
    more adds readers to every class's exchange."""
    xchg = GRID_CTAS * GRID_XCHG_BYTES
    tiles = 2 * SCAN_TILE * 4 * (2 * R + 7)
    for clusters in range(1, min(max_clusters, MAX_GRID_CLUSTERS) + 1):
        kc = -(-K // (clusters * GRID_CTAS))
        threads = scan_threads(kc)
        per_thread = 1
        while per_thread * threads < kc:
            per_thread *= 2
        smem = tiles + xchg + 4 * per_thread * threads * (2 * R + 2 + S)
        if per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK:
            return GridLayout(clusters, max_clusters // clusters, GRID_CTAS, per_thread, smem)
    return None


@functools.lru_cache(maxsize=None)
def grid_clusters(index: int) -> int:
    """The grid scan's co-resident clusters of `GRID_CTAS` CTAs on card
    ``index``, asked once: ``cudaOccupancyMaxActiveClusters`` at 1024
    threads and `SMEM_PER_BLOCK` a CTA, one CTA a SM, the most any of its
    layouts takes (a CTA with fewer threads or bytes only fits more)."""
    with torch.cuda.device(index):
        n = int(_lib().ffd_scan_grid_clusters(GRID_CTAS, 1024, SMEM_PER_BLOCK))
    if n < 1:
        raise RuntimeError(f"ffd_scan_grid: the cluster occupancy query gave {n}")
    return n


def scan_kernel(K: int, R: int, S: int, C: int, max_clusters: Optional[int] = None) -> str:
    """Which scan kernel runs at these shapes, decided by shape alone (and
    the card's count of co-resident clusters, ``max_clusters``; default:
    the current card's `grid_clusters`, or `GRID_CLUSTERS` with no card).
    Where the problem has at most `MAX_AXES` resource axes and its
    feasibility rows copy in 4-byte pieces or wider: ``"ffd_scan"``
    (resident) where its slot state fits the shared memory of one block
    with at most `MAX_SLOTS_PER_THREAD` slots a thread, else
    ``"ffd_scan_cluster"`` where it fits a cluster (`cluster_layout`), else
    ``"ffd_scan_grid"`` where it fits a grid of co-resident clusters
    (`grid_layout`; a batch on its groups).  Otherwise
    ``"ffd_scan_global"``.  The solve's scan, a what-if batch and a fleet
    pick alike: on an H100 the grid's batch and fleet modes beat the global
    scan at every B measured, 4 and 16 tenants, 128 and 512 what-ifs
    (PERF.md), so no batch size keeps the global scan."""
    if R > MAX_AXES or not feas_copy_bytes(C):
        return "ffd_scan_global"
    per_thread, smem = resident_layout(K, R, S, C)
    if per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK:
        return "ffd_scan"
    if cluster_layout(K, R, S, C) is not None:
        return "ffd_scan_cluster"
    if max_clusters is None:
        max_clusters = (grid_clusters(torch.cuda.current_device())
                        if torch.cuda.is_available() else GRID_CLUSTERS)
    if grid_layout(K, R, S, max_clusters) is not None:
        return "ffd_scan_grid"
    return "ffd_scan_global"


def window_smem(W: int, R: int, S: int, C: int) -> int:
    """Dynamic shared-memory bytes of the frontier-window scan on W slots:
    the resident scan's ring and tiles, `WINDOW_XCHG_BYTES` and the state
    of W slots (cfg, npods, used [R], cached alloc [R], signature counters
    [S])."""
    return (SCAN_RING * _up16(C) + 2 * SCAN_TILE * 4 * (2 * R + 7) + WINDOW_XCHG_BYTES
            + 4 * W * (2 * R + 2 + S))


def window_layout(K: int, R: int, S: int, C: int) -> Optional[Tuple[int, int]]:
    """``(W, dynamic shared-memory bytes)`` of the frontier-window scan at
    these shapes: the largest window of `WINDOW_SLOTS`, no larger than K
    rounded up to `WINDOW_THREADS`, whose CTA leaves room for two a SM
    (`WINDOW_TWO_A_SM`: B up to 264 in one wave on 132 SMs), else the
    largest that fits one a SM.  None where the scan cannot run: more than
    `MAX_AXES` axes, or feasibility rows no cp.async size divides (the
    resident scan's limits), or no window fits."""
    if R > MAX_AXES or not feas_copy_bytes(C):
        return None
    need = max(-(-K // WINDOW_THREADS) * WINDOW_THREADS, WINDOW_SLOTS[-1])
    for budget in (WINDOW_TWO_A_SM, SMEM_PER_BLOCK):
        for w in WINDOW_SLOTS:
            if w <= need and window_smem(w, R, S, C) <= budget:
                return w, window_smem(w, R, S, C)
    return None


def window_plan(next0: int, K: int, W: int) -> str:
    """Which launches a batched scan makes, from host ints alone: ``"pick"``
    (the scan `scan_kernel` picks, alone) where the live slots already
    reach the window (``next0 >= W``; W 0: no window); ``"window"`` (the
    frontier-window scan alone) where the window holds every slot (``K <=
    W``); else ``"both"``: the window scan, then the picked scan for the
    elements that leave the window."""
    if next0 >= W:
        return "pick"
    return "window" if K <= W else "both"


def batch_launches(next0: int, K: int, R: int, S: int, C: int) -> Tuple[str, ...]:
    """The `LAUNCHES` names of one launch group of `ffd_scan_batch` at these
    shapes (`MAX_BATCH` elements at most), in their order."""
    layout = window_layout(K, R, S, C)
    picked = f"{scan_kernel(K, R, S, C)}_batched"
    return {"pick": (picked,), "window": ("ffd_scan_window_batched",),
            "both": ("ffd_scan_window_batched", picked)}[
        window_plan(int(next0), K, layout[0] if layout else 0)]


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


def _scan_outputs(G: int, K: int, R: int, dev, batch=None) -> Tuple[torch.Tensor, ...]:
    """``take, leftover, node_cfg, node_pods, node_used`` on ``dev``, each
    with a leading batch axis of B elements where ``batch`` is given."""
    i32 = torch.int32
    b = () if batch is None else (batch[0],)
    return (
        torch.empty((*b, G, K), dtype=i32, device=dev),
        torch.empty((*b, G), dtype=i32, device=dev),
        torch.empty((*b, K), dtype=i32, device=dev),
        torch.empty((*b, K), dtype=i32, device=dev),
        torch.empty((*b, K, R), dtype=torch.float32, device=dev),
    )


# B = 1, no perm_b / cnt_b / rm_b / done_b / next0_b: the solve's scan
_NO_BATCH = (1, 0, 0, 0, 0, 0)


class Fleet(NamedTuple):
    """A fleet launch's batch: B problems of one shape, every input
    stacked [B, ...], ``next0_b`` [B] int32 each one's first free slot."""

    B: int
    next0_b: torch.Tensor


def _batch_ptrs(batch) -> tuple:
    """The C batch descriptor ``(B, perm_b, cnt_b, rm_b, done_b,
    next0_b)`` of ``batch``: None (the solve's scan), a `Fleet`, or a
    what-if batch ``(B, perm_b, cnt_b, rm_b[, done])``, ``done`` the window
    scan's mask (the elements it finished are skipped), absent or None
    where no window scan ran before."""
    if batch is None:
        return _NO_BATCH
    if isinstance(batch, Fleet):
        return (batch.B, 0, 0, 0, 0, batch.next0_b.data_ptr())
    B, perm_b, cnt_b, rm_b, *rest = batch
    done = rest[0] if rest else None
    return (B, perm_b.data_ptr(), cnt_b.data_ptr(), rm_b.data_ptr(),
            0 if done is None else done.data_ptr(), 0)


def _launch_name(kernel: str, batch) -> str:
    if batch is None:
        return kernel
    return f"{kernel}_fleet" if isinstance(batch, Fleet) else f"{kernel}_batched"


def _ptrs(*ts) -> list:
    return [t.data_ptr() for t in ts]


def ffd_scan(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0,
) -> Tuple[torch.Tensor, ...]:
    """The sequential class scan: ``(take [G, K], leftover [G],
    node_cfg [K], node_pods [K], node_used [K, R])``.  On the card it runs
    the kernel `scan_kernel` picks for the shapes: the resident one, the
    cluster one where the resident state does not fit a block, the grid
    one where it does not fit a cluster, or the global one past the grid."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    return _launch_picked(args, _scan_shapes(*args), None)


def _launch_picked(args, shapes, batch, outs=None) -> Tuple[torch.Tensor, ...]:
    """The scan `scan_kernel` picks for the shapes, with the batch axis
    where ``batch`` is given, writing ``outs`` where they are given."""
    G, C, K, R, S = shapes
    max_clusters = grid_clusters(_index(args[0].device))
    kernel = scan_kernel(K, R, S, C, max_clusters)
    if kernel == "ffd_scan_global":
        return _launch_global(args, shapes, batch, outs)
    if kernel == "ffd_scan_grid":
        return _launch_grid(args, shapes, grid_layout(K, R, S, max_clusters), batch, outs=outs)
    if kernel == "ffd_scan_cluster":
        return _launch_cluster(args, shapes, cluster_layout(K, R, S, C), batch, outs)
    return _launch_resident(args, shapes, batch, outs)


def _launch_resident(args, shapes, batch, outs=None) -> Tuple[torch.Tensor, ...]:
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    per_thread, smem = resident_layout(K, R, S, C)
    outs = outs or _scan_outputs(G, K, R, req.device, batch)
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), per_thread, smem,
            feas_copy_bytes(C), *_batch_ptrs(batch), *_ptrs(*outs), stream,
        )
    _launched(_launch_name("ffd_scan", batch), err)
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
    return _launch_global(args, _scan_shapes(*args), None)


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
    return _launch_cluster(args, shapes, layout, None)


def _launch_cluster(args, shapes, layout, batch, outs=None) -> Tuple[torch.Tensor, ...]:
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    ctas, per_thread, smem = layout
    outs = outs or _scan_outputs(G, K, R, req.device, batch)
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_cluster(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), ctas, per_thread, smem,
            feas_copy_bytes(C), wrap_guard(K), *_batch_ptrs(batch),
            *_ptrs(*outs), stream,
        )
    _launched(_launch_name("ffd_scan_cluster", batch), err)
    return outs


def ffd_scan_grid(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0, *, spin_budget: int = GRID_SPIN_CYCLES,
) -> Tuple[torch.Tensor, ...]:
    """`ffd_scan` through the grid kernel, on the clusters `grid_layout`
    picks for the card.  Raises where no grid of its co-resident clusters
    holds the shapes (`ffd_scan` takes this kernel only where `scan_kernel`
    says so).  ``spin_budget``: the clock cycles a wait on another cluster
    may take before the kernel traps."""
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    if req.device.type == "cpu":
        return ffd_scan_reference(*args)
    G, C, K, R, S = shapes = _scan_shapes(*args)
    max_clusters = grid_clusters(_index(req.device))
    layout = grid_layout(K, R, S, max_clusters)
    if layout is None or R > MAX_AXES:
        raise ValueError(f"no grid of {max_clusters} clusters holds K={K}, R={R}, S={S}")
    return _launch_grid(args, shapes, layout, None, spin_budget=spin_budget)


def _launch_grid(args, shapes, layout: GridLayout, batch, *, spin_budget: int = GRID_SPIN_CYCLES,
                 outs=None) -> Tuple[torch.Tensor, ...]:
    """The grid scan on ``layout`` (`grid_layout`), with the batch axis
    where ``batch`` is given: min(B, groups) groups of its clusters.  A
    grid of more clusters than the card holds at once (`grid_clusters`) is
    refused."""
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    B = 1 if batch is None else batch[0]
    groups = min(layout.groups, B)
    outs = outs or _scan_outputs(G, K, R, req.device, batch)
    # each group's cross-cluster entries [4][clusters] (64-bit): zeroed, so
    # no tag of an earlier launch matches
    xg = torch.zeros(groups * 4 * layout.clusters, dtype=torch.int64, device=req.device)
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_grid(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), layout.clusters, layout.ctas, layout.per_thread,
            layout.smem, wrap_guard(K),
            grid_clusters(_index(req.device)), int(spin_budget),
            groups, *_batch_ptrs(batch), xg.data_ptr(), *_ptrs(*outs), stream,
        )
    _launched(_launch_name("ffd_scan_grid", batch), err)
    return outs


def _launch_global(args, shapes, batch, outs=None) -> Tuple[torch.Tensor, ...]:
    (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    outs = outs or _scan_outputs(G, K, R, req.device, batch)
    B = 1 if batch is None else batch[0]
    sigcnt = torch.empty((B, S, K), dtype=torch.int32, device=req.device)  # scratch
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_global(
            *_ptrs(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), *_batch_ptrs(batch),
            *_ptrs(*outs, sigcnt), stream,
        )
    _launched(_launch_name("ffd_scan_global", batch), err)
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


# ---------------------------------------------------------------------------
# The fleet pack: B problems of one shape, each with arrays of its own
# ---------------------------------------------------------------------------

# the positions of the pack's arguments (service/server.py: PACK_ARG_ORDER)
FLEET_COLUMNS = (
    "req", "cnt", "maxper", "slot", "feas", "alloc", "price", "openable",
    "used0", "cfg0", "npods0", "next0", "sig0",
)
_NEXT0 = FLEET_COLUMNS.index("next0")


def _fleet_check(stacked: Sequence[torch.Tensor], B: int) -> Tuple[int, int, int, int, int]:
    """Checks the stacked card inputs of a fleet pack (``next0`` left out);
    returns ``(G, C, K, R, S)``."""
    req, cnt, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, sig0 = stacked
    dev = req.device
    _, G, R = req.shape
    C, K, S = alloc.shape[1], used0.shape[1], sig0.shape[1]
    i32, f32 = torch.int32, torch.float32
    for name, t, dt, shp in (
        ("req", req, f32, (G, R)),
        ("cnt", cnt, i32, (G,)),
        ("maxper", maxper, i32, (G,)),
        ("slot", slot, i32, (G,)),
        ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, f32, (C, R)),
        ("price", price, f32, (C,)),
        ("openable", openable, torch.bool, (C,)),
        ("used0", used0, f32, (K, R)),
        ("cfg0", cfg0, i32, (K,)),
        ("npods0", npods0, i32, (K,)),
        ("sig0", sig0, i32, (S, K)),
    ):
        _check(name, t, dt, (B, *shp), dev)
    if feas.data_ptr() % 16:
        raise ValueError("feas must start on a 16-byte boundary")
    return G, C, K, R, S


def fleet_pack(
    cols: Sequence[Sequence], *, k_slots: int, objective: str = "nodes",
    scan: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """B packs of one shape in one launch of each kernel (the JAX package's
    ``fleet_pack_kernel``): ``cols`` holds the 13 `FLEET_COLUMNS`, each a
    sequence of B per-problem values (tensors; ``next0`` host ints).
    Returns ``(take [B, G, K], leftover [B, G], node_cfg [B, K], node_pods
    [B, K], node_used [B, K, R])``; row b is `ffd_pack` of problem b, bit
    for bit.

    On the card each column is stacked with `torch.stack`, a copy on the
    card (as the reference's ``jnp.stack`` inside its jit), so a problem
    whose tensors are resident uploads nothing; the first free slots go up
    as one [B] int32 tensor (site ``fleet_pack_kernel``).  Then one launch
    of `choose_config` with a grid y of B and one of the scan `scan_kernel`
    picks at the shapes (``scan="ffd_scan_global"``: the global scan at any
    shape, as `ffd_scan_global` for one problem), in its fleet mode (one
    block, one cluster or one group of the grid's clusters an element).  The launch is at the true B: the
    reference pads B to a power of two only for XLA's compile cache, which
    the port does not have.  For CPU tensors it runs
    `fleet_pack_reference`."""
    if len(cols) != len(FLEET_COLUMNS):
        raise ValueError(f"fleet_pack takes {len(FLEET_COLUMNS)} columns, got {len(cols)}")
    B = len(cols[0])
    if B < 1 or any(len(col) != B for col in cols):
        raise ValueError("every column must hold the same B >= 1 problems")
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if scan not in (None, "ffd_scan_global"):
        raise ValueError(f"no fleet entry point for scan {scan!r}")
    dev = cols[0][0].device
    if dev.type == "cpu":
        return fleet_pack_reference(cols, k_slots=k_slots, objective=objective)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if B > MAX_BATCH:
        raise ValueError(f"B={B} is past the grid's y extent {MAX_BATCH}")
    stacked = [torch.stack(list(col)) for i, col in enumerate(cols) if i != _NEXT0]
    G, C, K, R, S = _fleet_check(stacked, B)
    if K != k_slots:
        raise ValueError(f"k_slots={k_slots} but the problems have {K} slots")
    next0 = np.array([int(n) for n in cols[_NEXT0]], dtype=np.int32)
    if ((next0 < 0) | (next0 > K)).any():
        raise ValueError(f"next0 outside [0, {K}]: {next0.tolist()}")
    next0_b = OBSERVATORY.put("fleet_pack_kernel", next0, dev)
    req, cnt, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, sig0 = stacked
    choice = torch.empty((3, B, G), dtype=torch.int32, device=dev)
    base = choice.data_ptr()  # rows c_star, new_ok, per, each [B, G]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_choose_config(
            *_ptrs(req, maxper, feas, alloc, price, openable), G, C, R,
            OBJECTIVES[objective], B, base, base + 4 * B * G, base + 8 * B * G, stream,
        )
    _launched("choose_config_fleet", err)
    c_star, new_ok, per = choice.unbind(0)
    args = (req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, 0, sig0)
    if scan == "ffd_scan_global":
        return _launch_global(args, (G, C, K, R, S), Fleet(B, next0_b))
    return _launch_picked(args, (G, C, K, R, S), Fleet(B, next0_b))


# ---------------------------------------------------------------------------
# The consolidation verdicts: B what-if scans in one launch, their verdict
# rows, and the population's per-member prologue
# ---------------------------------------------------------------------------


def _check_batch(cnt_b, rm_b, perm_b, G: int, K: int, dev) -> int:
    B = perm_b.shape[0] if perm_b.dim() == 2 else -1
    for name, t, dt, shp in (
        ("cnt_b", cnt_b, torch.int32, (B, G)),
        ("rm_b", rm_b, torch.bool, (B, K)),
        ("perm_b", perm_b, torch.int32, (B, G)),
    ):
        _check(name, t, dt, shp, dev)
    return B


def ffd_scan_batch(
    req, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0, cnt_b, rm_b, perm_b,
) -> Tuple[torch.Tensor, ...]:
    """B what-if scans over one base problem: element b scans the base rows
    ``perm_b[b]`` in that order with the counts ``cnt_b[b]`` (in permuted
    positions) and the slots ``rm_b[b]`` removed (their config -1);
    ``c_star, new_ok, per`` are the base's choice (`choose_config` on the
    base rows).  Returns ``(take [B, G, K], leftover [B, G], node_cfg [B,
    K], node_pods [B, K], node_used [B, K, R])``.  On the card it runs the
    scan `scan_kernel` picks at the base's shapes, with one block (or one
    cluster) per element, in one launch per `MAX_BATCH` elements, each
    writing its slice of the outputs; ``perm_b`` must hold base rows in
    [0, G).  Each launch group first runs the frontier-window scan where
    `window_plan` says so (``ffd_scan_window``), and the picked scan takes
    the elements that leave its window (its blocks skip the others)."""
    if req.device.type == "cpu":
        return ffd_scan_batch_reference(
            req, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0, cnt_b, rm_b, perm_b,
        )
    if req.device.type != "cuda":
        raise ValueError(f"no kernel for device {req.device}")
    G, K = req.shape[0], used0.shape[0]
    B = _check_batch(cnt_b, rm_b, perm_b, G, K, req.device)
    if B == 0:
        return _scan_outputs(G, K, req.shape[1], req.device, (0,))
    # cnt_b's first row stands in for the solve's count column (the kernels
    # read the element's own row of cnt_b)
    args = (req, cnt_b[0], maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0)
    shapes = _scan_shapes(*args)
    _, C, _, R, S = shapes
    outs = _scan_outputs(G, K, R, req.device, (B,))
    layout = window_layout(K, R, S, C)
    W = layout[0] if layout else 0
    plan = window_plan(int(next0), K, W)
    for lo in range(0, B, MAX_BATCH):
        part = slice(lo, min(lo + MAX_BATCH, B))
        batch = (part.stop - lo, perm_b[part], cnt_b[part], rm_b[part])
        sub = tuple(o[part] for o in outs)
        done = None
        if plan != "pick":
            done = torch.empty(batch[0], dtype=torch.int32, device=req.device)
            _launch_window(args, shapes, layout, batch, done, sub)
        if plan != "window":  # the elements the window left, or all of them
            _launch_picked(args, shapes, (*batch, done), sub)
        if WINDOW_RECORDS is not None:
            WINDOW_RECORDS.append(dict(B=batch[0], Gp=G, Kp=K, Cp=C, R=R, S=S,
                                       next0=int(next0), W=W, plan=plan, done=done,
                                       node_cfg=sub[2]))
    return outs


def _launch_window(args, shapes, layout, batch, done, outs) -> Tuple[torch.Tensor, ...]:
    """The frontier-window scan of ``batch`` (``(B, perm_b, cnt_b, rm_b)``)
    into ``outs``; ``done`` [B] int32 gets 1 for each element it finished,
    0 for each it left to the next launch."""
    (req, _cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
     used0, cfg0, npods0, next0, sig0) = args
    G, C, K, R, S = shapes
    W, smem = layout
    n, perm_b, cnt_b, rm_b = batch
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = _lib().ffd_scan_window(
            *_ptrs(req, maxper, slot, feas, alloc, c_star, new_ok, per,
                   used0, cfg0, npods0, sig0),
            G, C, K, R, S, int(next0), W, smem, feas_copy_bytes(C), n,
            *_ptrs(perm_b, cnt_b, rm_b, *outs, done), stream,
        )
    _launched("ffd_scan_window_batched", err)
    return outs


def scan_concurrency(K: int, R: int, S: int, C: int, kernel: Optional[str] = None) -> int:
    """How many elements of a batched scan at these shapes the card runs at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs for the
    one-block scans, ``cudaOccupancyMaxActiveClusters`` for the cluster
    scan, the groups of `grid_layout` for the grid scan): the scan
    `scan_kernel` picks, or ``kernel`` (``"ffd_scan_window"`` for the
    frontier-window scan).  Needs the card."""
    kernel = scan_kernel(K, R, S, C) if kernel is None else kernel
    if kernel == "ffd_scan_grid":
        return grid_layout(K, R, S, grid_clusters(torch.cuda.current_device())).groups
    if kernel == "ffd_scan_window":
        W, smem = window_layout(K, R, S, C)
        args = (3, W // WINDOW_THREADS, 1, WINDOW_THREADS, smem)
    elif kernel == "ffd_scan_cluster":
        ctas, per_thread, smem = cluster_layout(K, R, S, C)
        args = (1, per_thread, ctas, scan_threads(-(-K // ctas)), smem)
    elif kernel == "ffd_scan":
        per_thread, smem = resident_layout(K, R, S, C)
        args = (0, per_thread, 1, scan_threads(K), smem)
    else:
        args = (2, 1, 1, scan_threads(K), 4 * R)
    n = _lib().ffd_scan_concurrency(*args)
    if n < 1:
        raise RuntimeError(f"{kernel}: occupancy query failed ({n})")
    return n


def verdict_groups(max_group: int) -> Tuple[int, ...]:
    """The element groups `verdict_rows`' config pass may take, largest
    first: its largest, ``max_group``, halved down to one quad of elements
    (the pass reads its records four elements at a time)."""
    return tuple(max_group >> i for i in range(max_group.bit_length() - 2))


def verdict_group(B: int, C: int, sms: int, tile: int, max_group: int) -> int:
    """Elements a block of `verdict_rows`' config pass tests its configs
    against: the largest of `verdict_groups` whose grid (ceil(C / tile)
    config tiles x ceil(B / group) groups) gives each of the card's ``sms``
    SMs a block, else the smallest.  A larger group reads each config fewer
    times; a smaller one shortens each thread's chain of tests where the
    grid would leave SMs idle."""
    tiles = -(-C // tile)
    groups = verdict_groups(max_group)
    for group in groups:
        if tiles * -(-B // group) >= sms:
            return group
    return groups[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def verdict_shape() -> Tuple[int, int]:
    """The config pass's configs a block and its largest element group,
    from the built library."""
    lib = _lib()
    return int(lib.ffd_verdict_config_tile()), int(lib.ffd_verdict_max_group())


@functools.lru_cache(maxsize=None)
def _verdict_max_axes(index: int, G: int) -> int:
    with torch.cuda.device(index):
        n = int(_lib().ffd_verdict_max_axes(G))
    if n < 0:
        raise RuntimeError(f"verdict_rows: the shared memory query failed (CUDA error {-n})")
    return n


def verdict_rows_in_smem(index: int, G: int, R: int) -> bool:
    """Whether `verdict_rows`' config pass stages its tile's alloc rows and
    its group's rows in shared memory: up to `_verdict_max_axes` axes (about
    179 on an H100 at small G); past that it reads them from device
    memory."""
    return R <= _verdict_max_axes(index, G)


@functools.lru_cache(maxsize=64)
def _verdict_scratch_bytes(B: int, G: int, R: int) -> int:
    return int(_lib().ffd_verdict_scratch_bytes(B, G, R))


def verdict_rows(
    take, leftover, node_cfg, node_pods, node_used, perm_b,
    feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable,
    next0: int,
) -> torch.Tensor:
    """The verdict epilogue of each element of a batched scan: [B,
    RV_WIDTH] float32 rows (ops/packer.py: RV_*).  On the card three
    launches over one scratch allocation: `verdict_summary` (one block per
    element: its counts, c_star's key, k_star's usage, the new slots' load
    and the class flags), `verdict_configs` (each config tested once
    against a group of up to 32 elements, `verdict_group`; a first-index
    argmin by 64-bit atomicMin; its alloc and group rows in shared memory
    where `verdict_rows_in_smem`, else read from device memory) and
    `verdict_write` (the rows)."""
    dev = take.device
    args = (take, leftover, node_cfg, node_pods, node_used, perm_b,
            feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable)
    if dev.type == "cpu":
        return verdict_rows_reference(*args, next0)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B, G, K = take.shape
    R = node_used.shape[2]
    C = alloc.shape[0]
    i32 = torch.int32
    for name, t, dt, shp in (
        ("take", take, i32, (B, G, K)),
        ("leftover", leftover, i32, (B, G)),
        ("node_cfg", node_cfg, i32, (B, K)),
        ("node_pods", node_pods, i32, (B, K)),
        ("node_used", node_used, torch.float32, (B, K, R)),
        ("perm_b", perm_b, i32, (B, G)),
        ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, torch.float32, (C, R)),
        ("price", price, torch.float32, (C,)),
        ("openable", openable, torch.bool, (C,)),
        ("pool_id", pool_id, i32, (C,)),
        ("zone_id", zone_id, i32, (C,)),
        ("ct_id", ct_id, i32, (C,)),
        ("compactable", compactable, torch.bool, (G,)),
    ):
        _check(name, t, dt, shp, dev)
    if not 0 <= int(next0) <= K:
        raise ValueError(f"next0={next0} outside [0, {K}]")
    rows = torch.empty((B, RV_WIDTH), dtype=torch.float32, device=dev)
    if B == 0:
        return rows
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    group = verdict_group(B, C, _sm_count(index), *verdict_shape())
    scratch = torch.empty(_verdict_scratch_bytes(B, G, R), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_verdict_rows(
            *_ptrs(*args), B, G, C, K, R, int(next0), group,
            int(verdict_rows_in_smem(index, G, R)), scratch.data_ptr(), rows.data_ptr(), stream,
        )
    for name in VERDICT_ROWS_LAUNCHES:  # one C call launches the three in order
        _launched(name, err)
    return rows


def population_prologue(
    cand_cnt, cand_slot, cand_occ, sort_rank, occ_span: int, masks, k_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each population member's ``(cnt_b [P, G], rm_b [P, K], perm_b [P,
    G])`` from its removal mask (``population_verdict_kernel``'s prologue):
    the selected candidates' class counts, their live slots, and the FFD
    class order by a stable sort of the first-occurrence keys.  On the card
    one block per member (`population_pairs`), its (candidate, class)
    pairs spread over the threads."""
    dev = masks.device
    args = (cand_cnt, cand_slot, cand_occ, sort_rank)
    if dev.type == "cpu":
        return population_prologue_reference(*args, occ_span, masks, k_slots)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    P, U = masks.shape
    G = sort_rank.shape[0]
    i32 = torch.int32
    for name, t, dt, shp in (
        ("cand_cnt", cand_cnt, i32, (U, G)),
        ("cand_slot", cand_slot, i32, (U,)),
        ("cand_occ", cand_occ, i32, (U, G)),
        ("sort_rank", sort_rank, i32, (G,)),
        ("masks", masks, torch.bool, (P, U)),
    ):
        _check(name, t, dt, shp, dev)
    if not 0 <= int(occ_span) < 2**31:
        raise ValueError(f"occ_span={occ_span} outside int32")
    cnt_b = torch.empty((P, G), dtype=i32, device=dev)
    rm_b = torch.empty((P, k_slots), dtype=torch.bool, device=dev)
    perm_b = torch.empty((P, G), dtype=i32, device=dev)
    if P == 0:
        return cnt_b, rm_b, perm_b
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_population_prologue(
            *_ptrs(*args, masks), P, U, G, k_slots, int(occ_span),
            *_ptrs(cnt_b, rm_b, perm_b), stream,
        )
    _launched("population_pairs", err)
    return cnt_b, rm_b, perm_b


def removal_verdicts(
    req, maxper, slot, feas, alloc, price, openable,
    used0, cfg0, npods0, next0: int, sig0,
    pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b,
    *, objective: str = "nodes",
) -> torch.Tensor:
    """``removal_verdict_kernel``: `choose_config` once on the base, the B
    what-if scans in one `ffd_scan_batch`, then `verdict_rows`: [B,
    RV_WIDTH] float32, on the device the tensors lie on."""
    c_star, new_ok, per = choose_config(
        req, maxper, feas, alloc, price, openable, objective
    )
    outs = ffd_scan_batch(
        req, maxper, slot, feas, alloc, c_star, new_ok, per,
        used0, cfg0, npods0, next0, sig0, cnt_b, rm_b, perm_b,
    )
    return verdict_rows(
        *outs, perm_b, feas, alloc, price, openable,
        pool_id, zone_id, ct_id, compactable, next0,
    )


def population_verdicts(
    req, maxper, slot, feas, alloc, price, openable,
    used0, cfg0, npods0, next0: int, sig0,
    pool_id, zone_id, ct_id, compactable,
    cand_cnt, cand_slot, cand_occ, sort_rank, occ_span: int, masks,
    *, k_slots: int, objective: str = "nodes",
) -> torch.Tensor:
    """``population_verdict_kernel``: `population_prologue` derives each
    mask's counts, removed slots and class order, then `removal_verdicts`
    scores them: [P, RV_WIDTH] float32."""
    cnt_b, rm_b, perm_b = population_prologue(
        cand_cnt, cand_slot, cand_occ, sort_rank, occ_span, masks, k_slots
    )
    return removal_verdicts(
        req, maxper, slot, feas, alloc, price, openable,
        used0, cfg0, npods0, next0, sig0,
        pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b,
        objective=objective,
    )


# ---------------------------------------------------------------------------
# The admission fast path's score
# ---------------------------------------------------------------------------


# ``admit_kernel``'s block (csrc/ffd_pack.cu): at most ADMIT_THREADS
# threads (kAdmitThreads, its launch bound), and enough for
# ADMIT_SLOTS_AIM slot rounds and ADMIT_ROUNDS_AIM config rounds a thread,
# from ADMIT_MIN_THREADS.  A thread's rounds run one after another, so more
# warps shorten the chain; each warp adds its share of instructions to the
# one SM's issue, so past these counts they cost more than they save
# (measured on the card at phase 8's resident state and the live cluster).
ADMIT_THREADS, ADMIT_MIN_THREADS, ADMIT_SLOTS_AIM, ADMIT_ROUNDS_AIM = 512, 128, 4, 8


def admit_threads(K: int, Cp: int) -> int:
    """``admit_kernel``'s threads for K slots and Cp configs: a multiple of
    32 from `ADMIT_MIN_THREADS` to `ADMIT_THREADS`, enough for
    `ADMIT_SLOTS_AIM` slot rounds and `ADMIT_ROUNDS_AIM` config rounds a
    thread (so at most 8 slot rounds, the kernel's register-held ones, up
    to K 4096)."""
    need = max(-(-K // ADMIT_SLOTS_AIM), -(-Cp // ADMIT_ROUNDS_AIM))
    return min(max((need + 31) // 32 * 32, ADMIT_MIN_THREADS), ADMIT_THREADS)


def admit(req, cnt, feas, alloc, openable, used0, cfg0, g: int) -> torch.Tensor:
    """The single-pod admission score of class ``g`` (the JAX package's
    ``admit_kernel``): ONE [K+2] int32 tensor, take per slot, the placed
    total and the open-capacity bit (ops/packer.py: `admit_reference`, run
    for CPU tensors by the dispatcher `admit_kernel` there).  One launch of
    ``admit_kernel``: one block of `admit_threads` threads, two load rounds
    (the configs' bytes and the slots' configs; then the rows they name)
    and two block barriers."""
    dev = req.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    G, R = req.shape
    C = alloc.shape[0]
    K = used0.shape[0]
    for name, t, dt, shp in (
        ("req", req, torch.float32, (G, R)),
        ("cnt", cnt, torch.int32, (G,)),
        ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, torch.float32, (C, R)),
        ("openable", openable, torch.bool, (C,)),
        ("used0", used0, torch.float32, (K, R)),
        ("cfg0", cfg0, torch.int32, (K,)),
    ):
        _check(name, t, dt, shp, dev)
    if not 0 <= int(g) < G:
        raise ValueError(f"class {g} outside [0, {G})")
    out = torch.empty(K + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_admit(
            *_ptrs(req, cnt, feas, alloc, openable, used0, cfg0), G, C, K, R, int(g),
            admit_threads(K, C), out.data_ptr(), stream,
        )
    _launched("admit_kernel", err)
    return out


# ---------------------------------------------------------------------------
# The sharded pack over a device mesh (csrc/mesh_pack.cu)
# ---------------------------------------------------------------------------


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _card(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


# assemble_feasibility_kernel's layout (csrc/mesh_pack.cu: kAssembleWarps,
# kAssembleBytes, kAssembleMaxChunk, kAssembleMaxTiles)
ASSEMBLE_WARPS = 4  # a block's warps, each every 4th class of its chunk
ASSEMBLE_BYTES = 16  # configs a lane, one 16-byte store a row
ASSEMBLE_MAX_CHUNK = 32  # classes a block
ASSEMBLE_MAX_TILES = 32  # tiles a launch


class AssembleLayout(NamedTuple):
    """One launch of ``assemble_feasibility_kernel``: ``gc`` classes a
    block, ``grid`` (x, y, z) with z a tile."""

    gc: int
    grid: Tuple[int, int, int]


def assemble_layout(tiles: Sequence[Tuple[int, int, int, int, int]], sms: int) -> AssembleLayout:
    """The launch of ``tiles``, each ``(g0, g1, c0, c1, shift)`` with
    ``shift`` its first byte's address mod 16, on a card of ``sms`` SMs: a
    block runs 32 lanes x `ASSEMBLE_BYTES` configs by ``gc`` classes;
    ``gc`` is the largest multiple of `ASSEMBLE_WARPS` up to
    `ASSEMBLE_MAX_CHUNK` that still gives every SM a block (one full wave;
    else 4)."""
    xs = [-(-((c1 - c0 + shift + ASSEMBLE_BYTES - 1) // ASSEMBLE_BYTES) // 32)
          for _, _, c0, c1, shift in tiles]
    hs = [g1 - g0 for g0, g1, _, _, _ in tiles]
    blocks = lambda gc: sum(x * -(-h // gc) for x, h in zip(xs, hs))
    gc = next((gc for gc in range(ASSEMBLE_MAX_CHUNK, 0, -ASSEMBLE_WARPS)
               if blocks(gc) >= sms), ASSEMBLE_WARPS)
    return AssembleLayout(gc, (max(xs), max(-(-h // gc) for h in hs), len(tiles)))


def _admission(type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of) -> Tuple[int, ...]:
    """Check the seven admission tensors on one card; ``(S, T, Z, CT, G,
    C)``."""
    dev = type_ok.device
    _card(dev)
    S, T = type_ok.shape
    Z, CT = zone_ok.shape[1], ct_ok.shape[1]
    G, C = sig_of.shape[0], t_of.shape[0]
    for name, t, dt, shp in (
        ("type_ok", type_ok, torch.bool, (S, T)), ("zone_ok", zone_ok, torch.bool, (S, Z)),
        ("ct_ok", ct_ok, torch.bool, (S, CT)), ("sig_of", sig_of, torch.int32, (G,)),
        ("t_of", t_of, torch.int32, (C,)), ("z_of", z_of, torch.int32, (C,)),
        ("ct_of", ct_of, torch.int32, (C,)),
    ):
        _check(name, t, dt, shp, dev)
    return S, T, Z, CT, G, C


def _assemble_launch(adm: tuple, dims: tuple, tiles: list, ld: int) -> None:
    """One launch a run of at most `ASSEMBLE_MAX_TILES` of ``tiles``, each
    ``(g0, g1, c0, c1, address)``: the tile written at ``address``, rows
    ``ld`` bytes apart."""
    T, Z, CT = dims[1:4]
    dev = adm[0].device
    index = _index(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib("mesh_pack")
    for i in range(0, len(tiles), ASSEMBLE_MAX_TILES):
        run = tiles[i: i + ASSEMBLE_MAX_TILES]
        lay = assemble_layout([(g0, g1, c0, c1, at % 16) for g0, g1, c0, c1, at in run],
                              _sm_count(index))
        bounds = (ctypes.c_int * (4 * len(run)))(*(v for t in run for v in t[:4]))
        outs = (ctypes.c_void_p * len(run))(*(t[4] for t in run))
        err = lib.mesh_assemble_feasibility(
            *_ptrs(*adm), T, Z, CT, bounds, outs, len(run), ld, lay.gc,
            lay.grid[0], lay.grid[1], index, stream,
        )
        _launched("assemble_feasibility", err)


def _mask_check(out: torch.Tensor, G: int, C: int, dev) -> int:
    """``out``'s row stride in bytes: a [G, C] bool mask on ``dev`` whose
    rows are contiguous."""
    if out.device != dev or out.dtype != torch.bool or tuple(out.shape) != (G, C):
        raise ValueError(f"out must be a [{G}, {C}] bool mask on {dev}, not "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if (C > 1 and out.stride(1) != 1) or not max(C, 1) <= out.stride(0) < 2**31:
        raise ValueError(f"out's rows must be contiguous, strides {out.stride()}")
    return out.stride(0)


def assemble_feasibility(
    type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of,
    g0: int = 0, g1: Optional[int] = None, c0: int = 0, c1: Optional[int] = None,
) -> torch.Tensor:
    """The [g1 - g0, c1 - c0] tile (default: all of it) of the dense [G, C]
    feasibility mask from the factorized admission (the JAX package's
    ``parallel/mesh.py:assemble_feasibility``): ``type_ok [S, T]``,
    ``zone_ok [S, Z]``, ``ct_ok [S, CT]`` bool, ``sig_of [G]`` and ``t_of``,
    ``z_of``, ``ct_of [C]`` int32, every index in range.  On the card one
    launch of ``assemble_feasibility_kernel``, 16 configs of a row a lane;
    `assemble_tiles` writes tiles in place into a mask instead."""
    g1 = sig_of.shape[0] if g1 is None else g1
    c1 = t_of.shape[0] if c1 is None else c1
    args = (type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of)
    dev = type_ok.device
    if dev.type == "cpu":
        return assemble_feasibility_reference(*args, g0, g1, c0, c1)
    dims = _admission(*args)
    G, C = dims[4:]
    if not (0 <= g0 <= g1 <= G and 0 <= c0 <= c1 <= C):
        raise ValueError(f"tile [{g0}, {g1}) x [{c0}, {c1}) outside [{G}, {C}]")
    tile = torch.empty((g1 - g0, c1 - c0), dtype=torch.bool, device=dev)
    if tile.numel():
        _assemble_launch(args, dims, [(g0, g1, c0, c1, tile.data_ptr())], c1 - c0)
    return tile


def assemble_tiles(type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of, tiles,
                   out: torch.Tensor) -> None:
    """Every tile ``(g0, g1, c0, c1)`` of ``tiles`` written in place into
    the [G, C] mask ``out`` (ops/packer.py: `assemble_tiles_reference`):
    on the card one launch of ``assemble_feasibility_kernel`` for up to
    `ASSEMBLE_MAX_TILES` tiles, a tile a ``blockIdx.z``."""
    args = (type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of)
    dev = type_ok.device
    if dev.type == "cpu":
        return assemble_tiles_reference(*args, tiles, out)
    dims = _admission(*args)
    G, C = dims[4:]
    ld = _mask_check(out, G, C, dev)
    run = []
    for g0, g1, c0, c1 in tiles:
        if not (0 <= g0 <= g1 <= G and 0 <= c0 <= c1 <= C):
            raise ValueError(f"tile [{g0}, {g1}) x [{c0}, {c1}) outside [{G}, {C}]")
        if g1 > g0 and c1 > c0:
            run.append((g0, g1, c0, c1, out.data_ptr() + g0 * ld + c0))
    if run:
        _assemble_launch(args, dims, run, ld)


def choose_config_shard(
    req, maxper, feas, alloc, price, openable, g0: int, g1: int, c0: int, c1: int,
    objective: str = "nodes",
) -> torch.Tensor:
    """One tile of the hoisted new-node choice (classes [g0, g1), one model
    shard's configs [c0, c1), the price ceiling of the whole catalog):
    int32 [g1 - g0, MESH_REC] records (ops/packer.py:
    `choose_config_shard_reference`).  On the card one launch of the shard
    mode of ``choose_config_kernel`` (csrc/ffd_pack.cu), a block a class;
    an empty shard (c0 == c1) gets `REC_NONE` rows and no launch."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    dev = req.device
    if dev.type == "cpu":
        return choose_config_shard_reference(
            req, maxper, feas, alloc, price, openable, g0, g1, c0, c1, objective)
    _card(dev)
    G, R = req.shape
    C = alloc.shape[0]
    if not (0 <= g0 <= g1 <= G and 0 <= c0 <= c1 <= C):
        raise ValueError(f"tile [{g0}, {g1}) x [{c0}, {c1}) outside [{G}, {C}]")
    for name, t, dt, shp in (
        ("req", req, torch.float32, (G, R)), ("maxper", maxper, torch.int32, (G,)),
        ("feas", feas, torch.bool, (G, C)), ("alloc", alloc, torch.float32, (C, R)),
        ("price", price, torch.float32, (C,)), ("openable", openable, torch.bool, (C,)),
    ):
        _check(name, t, dt, shp, dev)
    if feas.data_ptr() % 16:
        raise ValueError("feas must start on a 16-byte boundary")
    rec = torch.empty((g1 - g0, MESH_REC), dtype=torch.int32, device=dev)
    if g1 == g0:
        return rec
    if c1 == c0:
        rec.fill_(0)
        rec[:, 0].fill_(REC_NONE[0])
        rec[:, 1].fill_(REC_NONE[1])
        return rec
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_choose_config_shard(
            *_ptrs(req, maxper, feas, alloc, price, openable), C, R, g0, g1, c0, c1,
            OBJECTIVES[objective], rec.data_ptr(), stream,
        )
    _launched("choose_config_shard", err)
    return rec


def _shard_desc(sh: MeshShard) -> tuple:
    """``(ShardArgs, device index, stream)`` of a shard's launches, checked
    and built on its first launch of the solve (its buffers stay put)."""
    if sh.desc is not None:
        return sh.desc
    dev = sh.device
    _card(dev)
    req, cnt, maxper, slot, feas, alloc = sh.rep
    G, R = req.shape
    C, kd = alloc.shape[0], sh.k1 - sh.k0
    S, M = sh.sig.shape[0], sh.rec.shape[0]
    i32, f32 = torch.int32, torch.float32
    for name, t, dt, shp in (
        ("req", req, f32, (G, R)), ("cnt", cnt, i32, (G,)), ("maxper", maxper, i32, (G,)),
        ("slot", slot, i32, (G,)), ("feas", feas, torch.bool, (G, C)),
        ("alloc", alloc, f32, (C, R)), ("rec", sh.rec, i32, (M, G, MESH_REC)),
        ("xchg", sh.xchg, i32, (2, G, sh.D)), ("used", sh.used, f32, (kd, R)),
        ("cfg", sh.cfg, i32, (kd,)), ("npods", sh.npods, i32, (kd,)),
        ("sig", sh.sig, i32, (S, kd)), ("take", sh.take, i32, (G, kd)),
        ("leftover", sh.leftover, i32, (G,)), ("cap", sh.cap, i32, (kd,)),
        ("nxt", sh.nxt, i32, (1,)),
    ):
        _check(name, t, dt, shp, dev)
    if feas.data_ptr() % 16:
        raise ValueError("feas must start on a 16-byte boundary")
    ptrs = _ptrs(req, cnt, maxper, slot, feas, alloc, sh.rec, sh.xchg, sh.used, sh.cfg,
                 sh.npods, sh.sig, sh.take, sh.leftover, sh.cap, sh.nxt)
    args = ShardArgs(*ptrs, G, C, R, S, M, sh.D, sh.d, sh.k0, kd, sh.K)
    sh.desc = (args, _index(dev), torch.cuda.current_stream(dev).cuda_stream)
    return sh.desc


def shard_scan_layout(kd: int, R: int, S: int, C: int, D: int,
                      G: int) -> Tuple[int, int, int]:
    """``(threads, slots per thread, dynamic shared-memory bytes)`` of a CTA
    of the cluster scan's shard mode (``mesh_shard_scan`` in
    csrc/ffd_pack.cu) whose largest data shard holds ``kd`` slots of a
    problem of G classes: the resident scan's block (`_block_layout`) with
    D x `CLUSTER_XCHG_BYTES` exchange bytes, and the G classes' choice rows
    (three int32 a class)."""
    per_thread, smem = _block_layout(kd, R, S, C, D * CLUSTER_XCHG_BYTES + 12 * G)
    return scan_threads(kd), per_thread, smem


def shard_scan_kernel(plan: MeshPlan, K: int, R: int, S: int, C: int) -> str:
    """Which scan the sharded pack runs, decided by the plan's layout and
    shapes alone: ``"ffd_shard_scan"`` (the whole scan in one cluster
    launch, a CTA a data shard) where every data row of ``plan`` sits on
    one device, there are at most `MAX_SHARDS` of them, the problem has at
    most `MAX_AXES` resource axes, the feasibility rows copy in 4-byte
    pieces or wider, and a CTA holds its shard with at most
    `MAX_SLOTS_PER_THREAD` slots a thread within `SMEM_PER_BLOCK`
    (`shard_scan_layout`); else ``"ffd_shard_pair"``, the cap and apply
    launches a shard a class with the exchanges between them (`mesh_scan`),
    which takes rows on several devices.  Of the default meshes
    (`parallel.mesh.make_mesh`), (1, 1) on one card and (1, 2) on two hold
    one data row on one card: D is 1, and the scan takes it up to 2,048
    slots (two a thread) where their state fits, the pair past that (the
    live cluster's 4,096); (2, 2) and larger, on four or more cards, put the
    rows on several cards and take the pair."""
    D = len(plan.tiles)
    kd = max((plan.k_bounds[d + 1] - plan.k_bounds[d] for d in range(D)), default=0)
    if (len({row[0] for row in plan.tiles}) == 1 and D <= MAX_SHARDS and R <= MAX_AXES
            and feas_copy_bytes(C)):
        _, per_thread, smem = shard_scan_layout(kd, R, S, C, D, plan.g_bounds[-1])
        if per_thread <= MAX_SLOTS_PER_THREAD and smem <= SMEM_PER_BLOCK:
            return "ffd_shard_scan"
    return "ffd_shard_pair"


def ffd_shard_scan(shards: list) -> None:
    """The whole scan over the classes for the data shards of one device,
    in place on their buffers (ops/packer.py: `ffd_shard_scan_reference`).
    On the card one launch of the cluster scan's shard mode
    (``ffd_scan_cluster_kernel<M, kShard>`` in csrc/ffd_pack.cu): a
    thread-block cluster of a CTA a shard, each shard's state resident in
    its CTA's shared memory, the per-class exchanges through the cluster's
    shared memory (`shard_scan_kernel` says where the pack takes it)."""
    first = shards[0]
    if first.device.type == "cpu":
        return ffd_shard_scan_reference(shards)
    D = len(shards)
    if D > MAX_SHARDS or any(sh.device != first.device for sh in shards):
        raise ValueError(f"ffd_shard_scan takes at most {MAX_SHARDS} shards of one device, "
                         f"not {[str(sh.device) for sh in shards]}")
    descs = [_shard_desc(sh) for sh in shards]
    args = (ShardArgs * D)(*(desc[0] for desc in descs))
    _, index, stream = descs[0]
    _launched("ffd_shard_scan", _lib().mesh_shard_scan(args, D, first.take.shape[0], index,
                                                       stream))


def ffd_shard_cap(sh: MeshShard, g: int) -> None:
    """Close class g - 1 on the shard's slots and compute class g's caps and
    their wrapped total (ops/packer.py: `ffd_shard_cap_reference`).  On the
    card one launch of ``ffd_shard_cap_kernel``: one block over the
    shard's slots, its state in device memory."""
    if sh.device.type == "cpu":
        return ffd_shard_cap_reference(sh, g)
    args, index, stream = _shard_desc(sh)
    _launched("ffd_shard_cap", _lib("mesh_pack").mesh_shard_cap(
        ctypes.byref(args), g, index, stream))


def ffd_shard_apply(sh: MeshShard, g: int) -> None:
    """Class g's first-fit take1 on the shard's slots from its prefix
    offset, and their wrapped sum (ops/packer.py:
    `ffd_shard_apply_reference`).  On the card one launch of
    ``ffd_shard_apply_kernel``."""
    if sh.device.type == "cpu":
        return ffd_shard_apply_reference(sh, g)
    args, index, stream = _shard_desc(sh)
    _launched("ffd_shard_apply", _lib("mesh_pack").mesh_shard_apply(
        ctypes.byref(args), g, index, stream))


def _plan_type(plan: MeshPlan) -> str:
    kinds = {dev.type for row in plan.tiles for dev in row}
    if len(kinds) != 1:
        raise ValueError(f"a mesh spans one kind of device, not {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind}")
    return kind


def mesh_assemble_feasibility(plan: MeshPlan, adm: dict, G: int, C: int) -> dict:
    """The sharded feasibility expansion (ops/packer.py:
    `mesh_assemble_reference` on CPU shards), in `mesh_assemble_plan`'s
    order: on a mesh of cards one launch of ``assemble_feasibility_kernel``
    a distinct device, writing every tile of that device in place into its
    [G, C] mask (`assemble_tiles`), then the tiles of the other devices
    copied in.  On one card: one launch and no copy."""
    if _plan_type(plan) == "cpu":
        return mesh_assemble_reference(plan, adm, G, C)
    ap = mesh_assemble_plan(plan)
    masks = mesh_assemble_masks(ap, G, C)
    for dev, tiles in ap.groups:
        assemble_tiles(*adm[dev], tiles, masks[dev])
    mesh_assemble_copies(ap, masks)
    return masks


def mesh_pack(
    plan: MeshPlan, reps: dict, slots: tuple, next0: int, objective: str = "nodes",
) -> Tuple[torch.Tensor, ...]:
    """The sharded pack (ops/packer.py: `mesh_pack_reference`, run for CPU
    shards): on a mesh of cards one launch of ``choose_config_kernel``'s
    shard mode a tile, then the scan `shard_scan_kernel` picks from the
    plan: ``"ffd_shard_scan"``, one cluster launch for the data shards of
    the one device (`ffd_shard_scan`), or ``"ffd_shard_pair"``, per class a
    launch of ``ffd_shard_cap_kernel`` and of ``ffd_shard_apply_kernel`` a
    data shard with the exchanges between, and one more cap launch a shard
    to close the last class: (G + 1) + G launches a shard, 2 G exchanges
    (`mesh_exchange_row`: copies only between devices).  The pair on any
    plan is `mesh_shards`, ``mesh_scan(shards, ffd_shard_cap,
    ffd_shard_apply)`` and `mesh_outputs`."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if _plan_type(plan) == "cpu":
        return mesh_pack_reference(plan, reps, slots, next0, objective)
    req, feas, sig0 = reps[plan.tiles[0][0]][0], reps[plan.tiles[0][0]][4], slots[0][3]
    picked = shard_scan_kernel(plan, plan.k_bounds[-1], req.shape[1], sig0.shape[0],
                               feas.shape[1])
    recs = [choose_config_shard(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                g0, g1, c0, c1, objective)
            for dev, g0, g1, c0, c1 in plan.tile_bounds()]
    shards = mesh_shards(plan, reps, recs, slots, next0)
    if picked == "ffd_shard_scan":
        ffd_shard_scan(shards)
    else:
        mesh_scan(shards, ffd_shard_cap, ffd_shard_apply)
    return mesh_outputs(shards)
