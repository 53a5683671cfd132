"""The least time of the solve's class scan (``ffd_scan`` and the cluster
and grid kernels that implement it) on one call's data.

The arithmetic is the bring-up script's (``chip_smoke.kernel_bounds``),
copied so that the yardstick stays as it is when the script changes: every
input the scan needs is read once and every output written once; where the
need depends on the data (which slots are open, which configurations a
class fits), only what this call's data needs is counted.  `bound_ms`
feeds it the reference's own derivation of the call, unpadded, so the
count is the same whatever implements the scan.
"""

from __future__ import annotations

import numpy as np

from benchmarks.harness import BENCH, load_module

peaks = load_module(BENCH / "roofline" / "peaks.py")


def scan_bound(args: tuple, take: np.ndarray, node_cfg: np.ndarray) -> dict:
    """``args`` is the pack's ``(req, cnt, maxper, slot, feas, alloc, price,
    openable, used0, cfg0, npods0, next0, sig0)``, numpy arrays."""
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, _next0, sig0) = args
    G, R = req.shape
    K = used0.shape[0]
    ru = (req > 0).sum(axis=1)  # axes each class requests
    # slot k is open at class g if it was filled before the scan or first
    # took pods at a class before g; a class reads feas and the slot's alloc
    # row only for open slots, once per distinct config, and its signature
    # counter only where it fits
    taken = take > 0
    first = np.where(taken.any(axis=0), taken.argmax(axis=0), G)
    opened_at = np.where(cfg0 >= 0, -1, first)
    open_ = np.arange(G)[:, None] > opened_at[None, :]  # [G, K]
    cfg_k = np.maximum(node_cfg, 0)
    fits = open_ & feas[:, cfg_k]
    feas_pairs = sum(len(np.unique(cfg_k[open_[g]])) for g in range(G))
    alloc_rows = len(np.unique(cfg_k[fits.any(axis=0)]))
    gi, ki = np.nonzero(fits)
    sig_pairs = len(np.unique(slot[gi].astype(np.int64) * K + ki))
    # per fitting slot: capacity (4 per requested axis) plus the signature
    # room, min, prefix and clip (5); per slot that takes pods: the usage
    # update (mul + add per requested axis) and the take, pod and
    # signature counts (3)
    ops = int((fits * (4 * ru + 5)[:, None]).sum() + (taken * (2 * ru + 3)[:, None]).sum())
    byts = (
        req.nbytes + cnt.nbytes + maxper.nbytes + slot.nbytes + 3 * G * 4
        + feas_pairs + alloc_rows * R * 4 + sig_pairs * 4
        + used0.nbytes + cfg0.nbytes + npods0.nbytes
        + take.nbytes + G * 4 + 2 * K * 4 + K * R * 4  # outputs
    )
    return peaks.bound(byts, ops)


def pack_arrays(prob, pk) -> tuple:
    """The reference's problem and pack as the scan's arguments and
    outputs (int32 and float32, as the program holds them)."""
    G, E, K = len(prob.classes), prob.E, len(pk.cfg)
    i32 = np.int32
    take = np.zeros((G, K), i32)
    for g, (s, t) in enumerate(pk.takes):
        take[g, s] = t
    used0 = np.zeros((K, 3), np.float32)
    used0[:E] = prob.used0
    cfg0 = np.full(K, -1, i32)
    cfg0[:E] = prob.C + np.arange(E)
    npods0 = np.zeros(K, i32)
    npods0[:E] = [len(n["pods"]) for n in prob.nodes]
    args = (prob.req, prob.cnt.astype(i32), np.full(G, 2**30, i32), np.zeros(G, i32), prob.feas,
            prob.alloc, prob.price32, prob.openable, used0, cfg0, npods0, E, np.zeros((1, K), i32))
    return args, take, pk.cfg.astype(i32)


def bound_ms(prob, pk) -> float:
    return scan_bound(*pack_arrays(prob, pk))["bound_ms"]
