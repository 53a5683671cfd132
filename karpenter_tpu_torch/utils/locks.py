"""Lock constructors and access annotations under the JAX package's names.

The counterpart of the seams of ``karpenter_tpu/analysis/sanitizer.py``
(`make_lock`, `make_rlock`, `make_condition`, `note_access`,
`note_blocking`) with their signatures: plain ``threading`` primitives and
no-op annotations.  The runtime lock sanitizer itself is not ported; its
names keep the copied modules' lock sites as they are in the reference.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """``threading.Lock()``; ``name`` is the lock's static identity."""
    return threading.Lock()


def make_rlock(name: str):
    return threading.RLock()


def make_condition(name: str, lock=None):
    return threading.Condition(lock)


def note_blocking(op: str) -> None:
    """Marks a blocking seam; a no-op here."""


def note_access(fieldname: str, write: bool = True) -> None:
    """Marks a touch of a shared field ("Class.attr"); a no-op here."""
