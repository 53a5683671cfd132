"""Admission-time validation + defaulting (the webhook analogue,
reference pkg/webhooks/webhooks.go:34-63 + pkg/apis/v1alpha5/
provisioner.go:44-60 + settings_validation.go).

The reference runs knative admission webhooks; here the same rules run as
plain functions the KubeStore applies on `put_*` — one process, same
contract: invalid objects never enter the store, and legacy-dialect
defaults (os=linux, arch=amd64, capacity-type=on-demand) are available
for pools that opt into them.
"""

from __future__ import annotations

from typing import List

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import NodeClass, NodePool, Taint
from karpenter_tpu_torch.api.requirements import Op, Requirement

# labels that may never appear as pool requirements (reference
# v1alpha5 restricted labels: karpenter-owned + hostname)
RESTRICTED_REQUIREMENT_KEYS = frozenset(
    {
        L.LABEL_HOSTNAME,
        L.LABEL_NODE_INITIALIZED,
        L.LABEL_NODE_REGISTERED,
    }
)

VALID_TAINT_EFFECTS = frozenset(
    {
        L.TAINT_EFFECT_NO_SCHEDULE,
        L.TAINT_EFFECT_PREFER_NO_SCHEDULE,
        L.TAINT_EFFECT_NO_EXECUTE,
    }
)

VALID_CONSOLIDATION_POLICIES = frozenset({"WhenEmpty", "WhenUnderutilized"})


class ValidationError(ValueError):
    pass


def validate_node_pool(pool: NodePool) -> None:
    errs: List[str] = []
    if not pool.name:
        errs.append("name is required")
    if not pool.node_class_ref:
        errs.append("nodeClassRef is required")
    for r in pool.requirements:
        if r.key in RESTRICTED_REQUIREMENT_KEYS:
            errs.append(f"requirement on restricted label {r.key}")
    # template_requirements() folds labels into requirements, so the same
    # restriction must cover spec.labels (the reference webhook does both)
    for key in pool.labels:
        if key in RESTRICTED_REQUIREMENT_KEYS:
            errs.append(f"label on restricted key {key}")
    for t in pool.taints + pool.startup_taints:
        if t.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"invalid taint effect {t.effect!r}")
        if not t.key:
            errs.append("taint key is required")
    d = pool.disruption
    if d.consolidation_policy not in VALID_CONSOLIDATION_POLICIES:
        errs.append(f"invalid consolidationPolicy {d.consolidation_policy!r}")
    if d.consolidate_after is not None and d.consolidate_after < 0:
        errs.append("consolidateAfter must be >= 0")
    if d.expire_after is not None and d.expire_after <= 0:
        errs.append("expireAfter must be > 0")
    for b in d.budgets:
        if b.endswith("%"):
            try:
                pct = float(b[:-1])
            except ValueError:
                errs.append(f"invalid budget {b!r}")
                continue
            if not 0 <= pct <= 100:
                errs.append(f"budget percentage out of range: {b!r}")
        else:
            try:
                if int(b) < 0:
                    errs.append(f"budget must be >= 0: {b!r}")
            except ValueError:
                errs.append(f"invalid budget {b!r}")
    if pool.kubelet_max_pods is not None and pool.kubelet_max_pods <= 0:
        errs.append("kubelet maxPods must be > 0")
    for fname, res in (
        ("kubeReserved", pool.kubelet_kube_reserved),
        ("systemReserved", pool.kubelet_system_reserved),
        ("evictionHard", pool.kubelet_eviction_hard),
    ):
        if res is not None and any(v < 0 for _, v in res.items()):
            errs.append(f"kubelet {fname} values must be >= 0")
    if errs:
        raise ValidationError(f"NodePool {pool.name!r}: " + "; ".join(errs))


VALID_BINDING_MODES = frozenset(["WaitForFirstConsumer", "Immediate"])


def validate_storage_class(sc) -> None:
    errs: List[str] = []
    if not sc.name:
        errs.append("name is required")
    if sc.binding_mode not in VALID_BINDING_MODES:
        errs.append(f"invalid volumeBindingMode {sc.binding_mode!r}")
    if errs:
        raise ValidationError(f"StorageClass {sc.name!r}: " + "; ".join(errs))


def default_node_pool(pool: NodePool, legacy_defaults: bool = False) -> NodePool:
    """Defaulting webhook: fill in unset requirement keys.

    With ``legacy_defaults`` (the v1alpha5 dialect,
    provisioner.go:44-60): os=linux, arch=amd64, capacity-type=on-demand.
    The v1beta1 dialect adds nothing — capacity choice stays
    spot-if-flexible (instance.go:376-389).
    """
    if legacy_defaults:
        for key, value in (
            (L.LABEL_OS, "linux"),
            (L.LABEL_ARCH, "amd64"),
            (L.LABEL_CAPACITY_TYPE, L.CAPACITY_TYPE_ON_DEMAND),
        ):
            if pool.requirements.get(key) is None:
                pool.requirements.add(Requirement(key, Op.IN, [value]))
    return pool


def validate_node_class(nc: NodeClass) -> None:
    errs: List[str] = []
    if not nc.name:
        errs.append("name is required")
    if nc.image_family not in ("standard", "accelerated", "custom"):
        errs.append(f"unknown imageFamily {nc.image_family!r}")
    if nc.image_family == "custom" and not nc.image_selector_terms:
        errs.append("custom imageFamily requires imageSelectorTerms")
    for term in (
        nc.subnet_selector_terms
        + nc.security_group_selector_terms
        + nc.image_selector_terms
    ):
        if term.id and (term.tags or term.name):
            errs.append("selector term may not mix id with tags/name")
    for bdm in nc.block_device_mappings:
        if bdm.volume_size <= 0:
            errs.append("blockDeviceMapping volumeSize must be > 0")
    if errs:
        raise ValidationError(f"NodeClass {nc.name!r}: " + "; ".join(errs))
