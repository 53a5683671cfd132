"""The least time of the fast path's score (``admit_kernel``) for one
attempt's class, on the attempt's data.

The arithmetic is the bring-up script's (``chip_smoke.admit_bound``),
copied so that the yardstick stays as it is when the script changes.  The
open-capacity bit is an any(): the configurations up to and including the
first that fits settle it (all of them when none fits).  Bytes: the
class's request row and count, cfg0, its feasibility bytes at the live
slots' configurations and at those configurations, openable where such a
configuration's byte is set, the requested axes of alloc and used0 of each
slot the class may use, the requested axes of alloc of each configuration
it may open on, the [K+2] output.  Operations: per such slot the capacity
(sub, div, add, floor, min a requested axis) and the prefix and clip (3);
per such configuration the capacity without the sub (4 a requested axis)
and its test (1).
"""

from __future__ import annotations

import numpy as np

from benchmarks.harness import BENCH, load_module
from benchmarks.reference.solve import per_node_cap

peaks = load_module(BENCH / "roofline" / "peaks.py")


def admit_bound(args: tuple, g: int) -> dict:
    """``args`` is ``(req, cnt, feas, alloc, openable, used0, cfg0)``, numpy."""
    req, cnt, feas, alloc, openable, used0, cfg0 = args
    fits = feas[g] & openable & (per_node_cap(alloc, req[g][None, :]) > 0)
    K = cfg0.shape[0]
    ru = int((req[g] > 0).sum())
    live = cfg0[cfg0 >= 0]
    slots = int(feas[g][live].sum())
    first = int(np.argmax(fits)) if fits.any() else fits.shape[0] - 1
    swept = np.arange(first + 1)
    configs = int((feas[g][swept] & openable[swept]).sum())
    feas_bytes = np.union1d(live, swept).size
    byts = (req.shape[1] * 4 + 4 + K * 4 + feas_bytes + int(feas[g][swept].sum())
            + slots * ru * 8 + configs * ru * 4 + (K + 2) * 4)
    ops = slots * (5 * ru + 3) + configs * (4 * ru + 1)
    return peaks.bound(byts, ops)


def bound_ms(prob) -> float:
    """The reference's one-pod problem as the kernel's arguments."""
    E = prob.E
    args = (prob.req, prob.cnt.astype(np.int32), prob.feas, prob.alloc, prob.openable,
            prob.used0, (prob.C + np.arange(E)).astype(np.int32))
    return admit_bound(args, 0)["bound_ms"]
