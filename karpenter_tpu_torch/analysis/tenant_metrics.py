"""Rule 12: service-plane metric emissions carry a ``tenant`` label.

The multi-tenant SolverService's observability contract (docs/designs/
solver-service.md): every metrics family the service plane emits is
tenant-attributed, so one tenant's traffic can never hide inside another
tenant's series — the isolation half of "one mesh serving a fleet".
Machine-checked, the way rule 5 guards the metrics doc:

- every registry WRITE verb (inc / set / observe / time / unset /
  reset_gauge) in a ``service/`` module whose metric-name literal starts
  with ``karpenter_service_`` must pass a labels dict literal containing
  a ``"tenant"`` key at the emission site;
- and the family must appear in docs/torch/metrics.md, the port's page
  (regenerate with
  ``python -m karpenter_tpu_torch.tools.gen_metrics_doc``) — a tenant-labeled
  series that ships undocumented is only half-observable.

The allowlist names ``service/`` files exempt because they are a
DIFFERENT plane (the store servers: one shared cluster store per
deployment, tenant-less by design) — path strings, each argued in
allowlists.py.  Dynamic names (``reg.inc(name)``) are out of scope, as
in rule 5: a computed family name is already unlintable there too.
"""

from __future__ import annotations

import ast
import re
from typing import List

from karpenter_tpu_torch.analysis.core import Finding, Rule, register

_WRITE_VERBS = frozenset(
    {"inc", "set", "observe", "time", "unset", "reset_gauge"}
)
_SERVICE_PREFIX = "karpenter_service_"


def _has_tenant_labels(call: ast.Call) -> bool:
    """True when some argument (positional or ``labels=``) is a dict
    literal carrying a literal ``"tenant"`` key."""
    candidates = list(call.args[1:]) + [
        kw.value for kw in call.keywords if kw.arg == "labels"
    ]
    for arg in candidates:
        if isinstance(arg, ast.Dict) and any(
            isinstance(k, ast.Constant) and k.value == "tenant"
            for k in arg.keys
        ):
            return True
    return False


@register
class ServiceTenantMetricsRule(Rule):
    """Every karpenter_service_* emission in service/ is tenant-labeled
    and documented."""

    name = "service-tenant-metrics"
    title = "service-plane metric emissions tenant-labeled and documented"
    guards = (
        "per-tenant observability isolation (no tenant-blind service "
        "series can ship)"
    )

    def check(self, snap, allowlist) -> List[Finding]:
        documented = set(
            re.findall(
                r"`(karpenter_[a-z0-9_]+)`",
                snap.doc_text("docs", "torch", "metrics.md"),
            )
        )
        out: List[Finding] = []
        for info in snap.in_package():
            if not info.rel_in_pkg.startswith("service/"):
                continue
            if info.rel in allowlist or info.rel_in_pkg in allowlist:
                continue
            for node in ast.walk(info.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _WRITE_VERBS
                    and node.args
                ):
                    continue
                first = node.args[0]
                if not (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith(_SERVICE_PREFIX)
                ):
                    continue
                fam = first.value
                if not _has_tenant_labels(node):
                    out.append(
                        self.finding(
                            info.rel, node.lineno,
                            f"{fam!r} emitted without a 'tenant' label "
                            "— a tenant-blind service series breaks the "
                            "per-tenant observability isolation "
                            "contract; pass an inline labels dict with "
                            "a 'tenant' key",
                        )
                    )
                if fam not in documented and fam not in allowlist:
                    out.append(
                        self.finding(
                            info.rel, node.lineno,
                            f"{fam!r} absent from docs/torch/metrics.md — "
                            "regenerate with `python -m karpenter_tpu_torch."
                            "tools.gen_metrics_doc`",
                        )
                    )
        return out
