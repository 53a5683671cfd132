"""Device-mesh sharding for the scheduling solver.

Port of ``karpenter_tpu/parallel/mesh.py``.  The reference shards its solve
over a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives; the
port runs a **single-controller** mesh: one process holds a (data, model)
grid of `torch.device`s and launches each shard's hand-written kernel
(``csrc/mesh_pack.cu``, wrappers in ops/fused_packer.py) on its own
device's current stream, with the exchanges between shards through one
buffer a device (copied between devices):

- axis **"data"**: the node-slot axis K.  Data row d owns the slots
  ``split_bounds(K, D)[d:d + 2]`` of the open-bin state (usage, configs,
  pod counts, signature counters) on its first device.  The first-fit
  prefix over K is what crosses shards: per class every shard computes
  its caps and their wrapped int32 total, the totals are exchanged, each
  shard takes its share from its prefix offset, and the take1 sums are
  exchanged (n2 needs every shard's own sum where int32 wraps).
- axis **"model"**: the config axis C of the [G, C] passes (the hoisted
  new-node choice and `assemble_feasibility`): tile (d, m) scores the
  classes of data row d (``split_bounds(G, D)``) on the configs of model
  column m (``split_bounds(C, M)``), and the per-class records meet in a
  first-index argmin on every data row.
- the **class axis G is the sequential dimension**, as in the reference.

Memory: the class and catalog tensors are replicated, one copy on each
distinct device of the mesh (`SHARD_SPECS`: the scan reads ``alloc`` and
``feas`` rows of whatever config a slot holds, so each data row keeps the
whole catalog); what a shard writes is its own.  The shards of one device
share its exchange buffer, so 8 shards on one card run the shard kernels
as 8 cards would, with the exchange's copies left out (and its ordering
given by the one stream).

`mesh_pack_fn(mesh)` is a drop-in ``pack_fn`` for `TorchScheduler`, as the
reference's is for ``TensorScheduler``: same padding (the slot bucket at
least 8 x the data axis), the catalog constants uploaded once per snapshot
(site ``mesh_constants``), dispatch through the device observatory as
``mesh_pack``, and outputs gathered to the first device so ``fetch_pack``
and the decode are the single-device path's.  The resident state
(ops/resident.py) places its buffers by the same table and packs through
`sharded_pack`.

The mesh is a correct, simple form, not yet a fast one: a class costs two
launches a data shard and two exchanges (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.ops.packer import (
    PackResult,
    cached_device_put,
    mesh_plan,
    node_slot_bound,
    pad_problem,
    split_bounds,
)
from karpenter_tpu_torch.utils.trace import phase

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the pack's positional arguments, in order (ops/packer.py: pad_problem)
PACK_ARGS = ("req", "cnt", "maxper", "slot", "feas", "alloc", "price", "openable",
             "used0", "cfg0", "npods0", "next0", "sig0")

# THE table of where each buffer of a sharded pack lives, the counterpart of
# the reference's in_shardings (and of its resident `_mesh_shardings`):
#   repl   one copy on each distinct device of the mesh;
#   on_k   axis 0 (slots) split over the data rows, each on its row device;
#   on_sk  axis 1 (slots) split over the data rows.
SHARD_SPECS = {
    "req": "repl", "cnt": "repl", "maxper": "repl", "slot": "repl",
    "feas": "repl", "alloc": "repl", "price": "repl", "openable": "repl",
    "used0": "on_k", "cfg0": "on_k", "npods0": "on_k", "sig0": "on_sk",
}
_SLOT_AXIS = {"on_k": 0, "on_sk": 1}


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices; hashable, so it keys caches."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def rows(self) -> Tuple[torch.device, ...]:
        """Each data row's first device: where its slots live."""
        return tuple(row[0] for row in self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in row-major order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))


def _normal(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device; none raises).  Both axes are powers of two
    (devices past the largest power-of-two count are left out): the padded
    buckets are powers of two.  Counts >= 2 split (n/2, 2), so both axes
    are exercised; one device is (1, 1).  A device may be named more than
    once: 8 shards on one card are ``make_mesh(8, ["cuda:0"] * 8)``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; name the devices (devices=...) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA devices named but torch.cuda.is_available() is False")
    devices = [_normal(d) for d in devices]
    n = len(devices) if n_devices is None else min(n_devices, len(devices))
    p2 = 1
    while p2 * 2 <= n:
        p2 *= 2
    D, M = (p2 // 2, 2) if p2 >= 2 else (1, 1)
    return Mesh(tuple(tuple(devices[d * M: (d + 1) * M]) for d in range(D)))


class Sharded:
    """A buffer placed on a mesh by one spec of `SHARD_SPECS`: ``parts``
    maps each distinct device to its copy (``repl``), or holds each data
    row's slice in row order (``on_k``, ``on_sk``)."""

    __slots__ = ("spec", "parts", "shape", "dtype")

    def __init__(self, spec: str, parts, shape, dtype):
        self.spec, self.parts = spec, parts
        self.shape, self.dtype = tuple(shape), dtype

    def tensors(self) -> tuple:
        return tuple(self.parts.values()) if self.spec == "repl" else tuple(self.parts)

    def launch_signature(self) -> tuple:
        """The device observatory's key: spec, global shape, dtype, devices."""
        return ("m", self.spec, self.shape, str(self.dtype),
                tuple(str(t.device) for t in self.tensors()))

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in self.tensors())

    def host(self) -> np.ndarray:
        """The whole buffer as one host array (a check's read)."""
        if self.spec == "repl":
            return next(iter(self.parts.values())).cpu().numpy()
        return np.concatenate([t.cpu().numpy() for t in self.parts], axis=_SLOT_AXIS[self.spec])

    def gather(self, device: torch.device, site: str) -> torch.Tensor:
        """A slot-sharded buffer whole on ``device`` (a fresh allocation;
        each slice one counted exchange)."""
        axis = _SLOT_AXIS[self.spec]
        full = torch.empty(self.shape, dtype=self.dtype, device=device)
        lo = 0
        for t in self.parts:
            n = t.shape[axis]
            if n:
                OBSERVATORY.exchange(site, full.narrow(axis, lo, n), t)
            lo += n
        return full

    def scatter(self, full: torch.Tensor, site: str) -> None:
        """Copy a whole slot-sharded buffer back into the slices."""
        axis = _SLOT_AXIS[self.spec]
        lo = 0
        for t in self.parts:
            n = t.shape[axis]
            if n:
                OBSERVATORY.exchange(site, t, full.narrow(axis, lo, n))
            lo += n


def place(mesh: Mesh, spec: str, value, site: str) -> Sharded:
    """Upload a host array (numpy or a CPU tensor) to the mesh by ``spec``,
    each part one counted upload under ``site``."""
    arr = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
    if spec == "repl":
        parts = {dev: OBSERVATORY.put(site, arr, dev) for dev in mesh.distinct()}
    else:
        axis = _SLOT_AXIS[spec]
        b = split_bounds(arr.shape[axis], mesh.shape[0])
        parts = tuple(
            OBSERVATORY.put(site, np.take(arr, range(b[d], b[d + 1]), axis=axis), dev)
            for d, dev in enumerate(mesh.rows)
        )
    first = next(iter(parts.values())) if spec == "repl" else parts[0]
    return Sharded(spec, parts, arr.shape, first.dtype)


def _placed(mesh: Mesh, name: str, value, site: str) -> Sharded:
    spec = SHARD_SPECS[name]
    if isinstance(value, Sharded):
        if value.spec != spec:
            raise ValueError(f"{name} is placed {value.spec}, the table says {spec}")
        return value
    return place(mesh, spec, value, site)


def sharded_pack(
    mesh: Mesh, req, cnt, maxper, slot, feas, alloc, price, openable,
    used0, cfg0, npods0, next0, sig0, *, k_slots: int, objective: str = "nodes",
) -> PackResult:
    """The pack over ``mesh``: each argument a host array (placed here by
    `SHARD_SPECS` under site ``mesh_pack``) or a `Sharded` buffer placed by
    the same table (the resident state's, the cached catalog constants).
    Returns the five outputs whole on the mesh's first device, as a
    `PackResult` of tensors."""
    from karpenter_tpu_torch.ops import fused_packer

    plan, reps, slots, next0 = pack_layout(
        mesh, (req, cnt, maxper, slot, feas, alloc, price, openable,
               used0, cfg0, npods0, next0, sig0), site="mesh_pack")
    if plan.k_bounds[-1] != k_slots:
        raise ValueError(f"k_slots={k_slots} but the problem has {plan.k_bounds[-1]} slots")
    return PackResult(*fused_packer.mesh_pack(plan, reps, slots, next0, objective))


def pack_layout(mesh: Mesh, args: tuple, site: str) -> tuple:
    """The 13 pack arguments (host arrays, placed here under ``site``, or
    `Sharded` buffers) as the sharded pack takes them: ``(plan, reps,
    slots, next0)``, the `MeshPlan`, each device's replica of the class and
    catalog buffers, each data row's slot buffers."""
    vals = dict(zip(PACK_ARGS, args))
    vals = {n: v if n == "next0" else _placed(mesh, n, v, site) for n, v in vals.items()}
    G, C = vals["feas"].shape
    plan = mesh_plan(mesh.devices, G, C, vals["used0"].shape[0])
    reps = {dev: tuple(vals[n].parts[dev] for n in PACK_ARGS[:8]) for dev in mesh.distinct()}
    slots = tuple(tuple(vals[n].parts[d] for n in ("used0", "cfg0", "npods0", "sig0"))
                  for d in range(mesh.shape[0]))
    return plan, reps, slots, int(vals["next0"])


def assemble_feasibility(type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of) -> torch.Tensor:
    """Expand factorized admission vectors into the dense [G, C] mask, on
    the device the tensors lie on (one launch of the kernel on the card,
    its plain version for CPU tensors): ``type_ok[sig_of[g], t_of[c]] &
    zone_ok[sig_of[g], z_of[c]] & ct_ok[sig_of[g], ct_of[c]]``.  On a mesh
    `sharded_solve_step` runs it tile by tile."""
    from karpenter_tpu_torch.ops import fused_packer

    return OBSERVATORY.dispatch(
        "assemble_feasibility", fused_packer.assemble_feasibility,
        type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of,
    )


def solve_step(
    mesh: Mesh, type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of,
    req, cnt, maxper, slot, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
    *, k_slots: int, objective: str = "nodes",
) -> PackResult:
    """The full sharded step of `sharded_solve_step` on host arrays: the
    admission vectors replicated (site ``mesh_solve_step``), the
    feasibility expanded tile by tile and copied to every device, then
    `sharded_pack`."""
    from karpenter_tpu_torch.ops import fused_packer

    adm_host = (type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of)
    adm = {dev: tuple(OBSERVATORY.put("mesh_solve_step", np.asarray(a), dev) for a in adm_host)
           for dev in mesh.distinct()}
    G, C = len(sig_of), len(t_of)
    plan = mesh_plan(mesh.devices, G, C, k_slots)
    feas = fused_packer.mesh_assemble_feasibility(plan, adm, G, C)
    feas = Sharded("repl", feas, (G, C), torch.bool)
    return sharded_pack(mesh, req, cnt, maxper, slot, feas, alloc, price, openable,
                        used0, cfg0, npods0, next0, sig0, k_slots=k_slots, objective=objective)


def sharded_solve_step(mesh: Mesh, k_slots: int):
    """The mesh-sharded full solve step: ``step(type_ok, zone_ok, ct_ok,
    sig_of, t_of, z_of, ct_of, req, cnt, maxper, slot, alloc, price,
    openable, used0, cfg0, npods0, next0, sig0) -> PackResult``, the
    feasibility expansion followed by the pack, dispatched as
    ``mesh_solve_step``."""

    def step(*args) -> PackResult:
        return OBSERVATORY.dispatch("mesh_solve_step", solve_step, mesh, *args, k_slots=k_slots)

    return step


# (mesh, k_slots, objective) -> the sharded pack's step; Mesh is hashable
_SHARDED_PACK_CACHE: dict = {}


def _sharded_pack(mesh: Mesh, k_slots: int, objective: str):
    """The pack over ``mesh`` at ``k_slots`` slots as one callable of the
    13 pack arguments, dispatched as ``mesh_pack``."""
    key = (mesh, k_slots, objective)
    fn = _SHARDED_PACK_CACHE.get(key)
    if fn is None:

        def fn(*args) -> PackResult:
            return OBSERVATORY.dispatch("mesh_pack", sharded_pack, mesh, *args,
                                        k_slots=k_slots, objective=objective)

        _SHARDED_PACK_CACHE[key] = fn
    return fn


_MESH_CONST_CACHE: dict = {}


def mesh_pack_fn(mesh: Optional[Mesh] = None):
    """A `TorchScheduler` ``pack_fn`` that packs over a device mesh (default
    `make_mesh()`): the node-slot state over "data", the [G, C] passes'
    configs over "model".  Drop-in for ops/packer.py's ``run_pack``: same
    padding (the slot bucket at least 8 x the data axis, so each data row
    holds 8 slots or more), the catalog constants uploaded once per
    snapshot and mesh (site ``mesh_constants``), and the outputs whole on
    the first device for ``fetch_pack``."""
    if mesh is None:
        mesh = make_mesh()
    dp = mesh.shape[0]

    def pack(prob, k_slots: int = 0, objective: str = "nodes") -> PackResult:
        if k_slots <= 0:
            k_slots = node_slot_bound(prob)
        k_slots = max(k_slots, 8 * dp)
        with phase("pad"):
            args, kp = pad_problem(prob, k_slots)
        alloc, price, openable = cached_device_put(
            _MESH_CONST_CACHE,
            (prob.alloc, prob.price, prob.openable),
            (args[5].shape,),
            lambda: args[5:8],
            mesh,
            "mesh_constants",
            place=lambda a: place(mesh, "repl", a, "mesh_constants"),
        )
        return _sharded_pack(mesh, kp, objective)(*args[:5], alloc, price, openable, *args[8:])

    pack.kernel_name = "scan-sharded"
    pack.mesh = mesh
    return pack
