"""The runtime half of the lock plane: the concurrency sanitizer.

Port of the part of ``karpenter_tpu/analysis/`` that runs inside the
process: `sanitizer.py` (the lock-order, blocking and lockset witness
behind the `make_lock` / `make_rlock` / `make_condition` / `note_blocking`
/ `note_access` seams, and the deadlock watchdog), `witness.py` (its
deterministic artifact) and what they read: `Finding` of ``core.py`` and
the sanctioned tables of ``allowlists.py``.  The static analysis (the rule
engine, the lock model of ``locks.py``, the lint CLI) is not ported
(ROADMAP A8b).

The package body imports nothing eagerly: every module that builds a lock
imports the sanitizer, which runs this ``__init__``.
"""
