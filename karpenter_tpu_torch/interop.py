"""Plain arrays in, the port's `CompiledProblem` out.

The JAX package's ``CompiledProblem`` and the port's carry the same arrays.
`problem_from_arrays` builds the port's problem from a dict of numpy
arrays, so both packers can run on the same inputs; nothing of the JAX
package is imported — a caller hands over plain arrays (`problem_arrays`
reads them off any object with the same attribute names).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from karpenter_tpu_torch.ops.tensorize import CompiledProblem

# field -> dtype of the pack inputs a CompiledProblem carries
ARRAY_FIELDS = {
    "req": np.float32,
    "cnt": np.int32,
    "maxper": np.int32,
    "slot": np.int32,
    "feas": bool,
    "alloc": np.float32,
    "price": np.float32,
    "openable": bool,
    "used0": np.float32,
    "cfg0": np.int32,
    "npods0": np.int32,
    "sig_used0": np.int32,
}


def problem_arrays(prob) -> Dict[str, np.ndarray]:
    """The pack inputs of a compiled problem as a dict of numpy arrays,
    plus ``n_track_slots``."""
    d = {k: np.asarray(getattr(prob, k)) for k in ARRAY_FIELDS}
    d["n_track_slots"] = int(prob.n_track_slots)
    return d


def problem_from_arrays(
    d: Dict[str, np.ndarray], meta: Optional[dict] = None
) -> CompiledProblem:
    """A port `CompiledProblem` over the arrays of ``d`` (the fields of
    `ARRAY_FIELDS` and ``n_track_slots``).  ``meta`` may carry ``axes``; the
    class and config metadata stay empty, which is all the pack reads."""
    meta = meta or {}
    arrays = {k: np.ascontiguousarray(d[k], dtype=dt) for k, dt in ARRAY_FIELDS.items()}
    R = arrays["req"].shape[1] if arrays["req"].ndim == 2 else 0
    return CompiledProblem(
        axes=tuple(meta.get("axes", ("",) * R)),
        classes=[],
        configs=[],
        pool_daemon_overhead={},
        n_track_slots=int(d["n_track_slots"]),
        **arrays,
    )
