"""Lock constructors and access annotations under the JAX package's names.

The seams of the runtime lock sanitizer (``analysis/sanitizer.py``),
re-exported so the modules of the port that build their locks here keep
their import path: `make_lock`, `make_rlock`, `make_condition`,
`note_blocking`, `note_access`.  With no sanitizer enabled they hand out
the stdlib ``threading`` objects themselves and the annotations are a
branch; after ``sanitizer.enable()`` every lock built through them is
wrapped into the witness (a lock built before ``enable()`` stays stdlib).
"""

from __future__ import annotations

from karpenter_tpu_torch.analysis.sanitizer import (  # noqa: F401
    make_condition,
    make_lock,
    make_rlock,
    note_access,
    note_blocking,
)
