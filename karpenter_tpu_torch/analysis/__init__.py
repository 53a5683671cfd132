"""Whole-program static analysis plane of the port, and its runtime half.

Port of ``karpenter_tpu/analysis/`` (docs/designs/static-analysis.md),
run over the port's own tree (``python -m karpenter_tpu_torch lint``):

- **Rule engine** (core.py): rules are registered classes over a shared
  parsed-AST snapshot of the package (`PackageSnapshot`), findings are
  structured records with stable fingerprints, per-rule allowlists live
  in ONE declarative table (allowlists.py), and a baseline file can
  suppress known findings without deleting the signal.
- **Lock-discipline analyzer** (locks.py): the static lock model over
  the `make_lock` seams, blocking operations under a held lock, and the
  acquisition order across the store/pipeline/operator layers.
- **Determinism-reachability analyzer** (reachability.py): nothing
  reachable from the byte-compared surfaces reaches the wall clock,
  unseeded random or ``os.environ`` outside the sanctioned sinks.
- **Launch-seam analyzer** (tracer.py): every launch wrapper of the CUDA
  library (a function that calls ``_lib().<entry>``) is dispatched through
  the device observatory's counted seam.
- The 11 legacy lint rules (rules_legacy.py); ``device-put`` fences the
  port's upload idioms (a tensor built with ``device=``, ``.to(device)``,
  ``.cuda()``, ``.copy_``) to the observatory's counted upload.
- **Runtime half**: the concurrency sanitizer (sanitizer.py) behind the
  `make_lock` / `make_rlock` / `make_condition` / `note_blocking` /
  `note_access` seams, and its witness artifact (witness.py), which
  ``lint --witness`` cross-validates against the static lock model.
"""

# The package body imports NOTHING eagerly: every production module now
# imports analysis.sanitizer (the lock construction seam), which runs
# this __init__ — pulling the whole rule engine in eagerly would tax
# every process start and plant a circular-import trap for any future
# rule module that imports production code.  The engine surface loads on
# first attribute access (PEP 562) instead.

_CORE_EXPORTS = frozenset(
    {
        "Finding",
        "PackageSnapshot",
        "Rule",
        "RULES",
        "load_baseline",
        "register",
        "run_rules",
        "to_report",
    }
)


def load_rules() -> None:
    """Import every rule module (idempotent): RULES is complete after.
    Called by __getattr__ below and by core.run_rules, so a direct
    ``from karpenter_tpu_torch.analysis.core import run_rules`` can never run
    against a half-registered catalog."""
    from karpenter_tpu_torch.analysis import (  # noqa: F401
        locks,
        reachability,
        rules_legacy,
        settings_flow,
        tenant_metrics,
        tracer,
    )


def __getattr__(name: str):
    if name in _CORE_EXPORTS:
        load_rules()
        from karpenter_tpu_torch.analysis import core

        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
