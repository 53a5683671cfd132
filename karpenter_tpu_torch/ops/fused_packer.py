"""Wrappers of the hand-written CUDA FFD pack (``csrc/ffd_pack.cu``).

Port of the TPU kernel ``karpenter_tpu/ops/pallas_packer.py:_pack_step``
(launched by ``_pallas_pack`` through ``pl.pallas_call``), which computes
the function of ``karpenter_tpu/ops/packer.py:_pack_core``.  On the card the
pack is two launches:

- `choose_config`: one block per class picks the config a new node of the
  class opens on (``_pack_core``'s hoisted new-node choice);
- `ffd_scan`: one block walks the classes in order (the sequential scan).

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
LAUNCHES: Dict[str, int] = {"choose_config": 0, "ffd_scan": 0}

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
        lib.ffd_scan.argtypes = [_P] * 13 + [_I] * 6 + [_P] * 6 + [_P]
        lib.ffd_scan.restype = _I
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


def ffd_scan(
    req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
    used0, cfg0, npods0, next0: int, sig0,
) -> Tuple[torch.Tensor, ...]:
    """The sequential class scan: ``(take [G, K], leftover [G],
    node_cfg [K], node_pods [K], node_used [K, R])``."""
    dev = req.device
    if dev.type == "cpu":
        return ffd_scan_reference(
            req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per,
            used0, cfg0, npods0, next0, sig0,
        )
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
    if not 0 <= int(next0) <= K:
        raise ValueError(f"next0={next0} outside [0, {K}]")
    take = torch.empty((G, K), dtype=i32, device=dev)
    leftover = torch.empty(G, dtype=i32, device=dev)
    node_cfg = torch.empty(K, dtype=i32, device=dev)
    node_pods = torch.empty(K, dtype=i32, device=dev)
    node_used = torch.empty((K, R), dtype=f32, device=dev)
    sigcnt = torch.empty((S, K), dtype=i32, device=dev)  # scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ffd_scan(
            req.data_ptr(), cnt.data_ptr(), maxper.data_ptr(),
            slot.data_ptr(), feas.data_ptr(), alloc.data_ptr(),
            c_star.data_ptr(), new_ok.data_ptr(), per.data_ptr(),
            used0.data_ptr(), cfg0.data_ptr(), npods0.data_ptr(),
            sig0.data_ptr(), G, C, K, R, S, int(next0),
            take.data_ptr(), leftover.data_ptr(), node_cfg.data_ptr(),
            node_pods.data_ptr(), node_used.data_ptr(), sigcnt.data_ptr(),
            stream,
        )
    _launched("ffd_scan", err)
    return take, leftover, node_cfg, node_pods, node_used


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
