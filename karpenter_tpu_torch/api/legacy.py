"""Legacy v1alpha API conversion (reference pkg/apis/v1alpha5 Provisioner +
pkg/apis/v1alpha1 AWSNodeTemplate, and the karpenter-convert migration
mapping from the v0.31->v0.32 upgrade path).

`convert_provisioner` maps a v1alpha5 Provisioner manifest (parsed JSON)
onto a NodePool, and `convert_aws_node_template` maps an AWSNodeTemplate
onto a NodeClass — the same translations the conversion tool applies:

- ``ttlSecondsAfterEmpty``        -> ``disruption.consolidationPolicy:
  WhenEmpty`` + ``consolidateAfter`` (mutually exclusive with
  ``consolidation.enabled`` in v1alpha5, enforced here as there)
- ``consolidation.enabled: true`` -> ``WhenUnderutilized``
- ``ttlSecondsUntilExpired``      -> ``disruption.expireAfter``
- ``providerRef``                 -> ``nodeClassRef``
- tag-map selectors (``subnetSelector`` etc.) -> selector term lists
- ``amiFamily`` AL2/Ubuntu -> ``standard``, Bottlerocket ->
  ``accelerated`` (the settings-document bootstrapper), Custom ->
  ``custom`` (see providers/bootstrap.py for the family formats)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api.objects import (
    BlockDeviceMapping,
    Disruption,
    NodeClass,
    NodePool,
    SelectorTerm,
    Taint,
)
from karpenter_tpu_torch.api.requirements import Op, Requirement, Requirements
from karpenter_tpu_torch.api.resources import Resources, parse_quantity
from karpenter_tpu_torch.api.validation import default_node_pool

_OPS = {
    "In": Op.IN,
    "NotIn": Op.NOT_IN,
    "Exists": Op.EXISTS,
    "DoesNotExist": Op.DOES_NOT_EXIST,
    "Gt": Op.GT,
    "Lt": Op.LT,
}

_FAMILIES = {
    "AL2": "standard",
    "Ubuntu": "standard",
    "Bottlerocket": "accelerated",
    "Custom": "custom",
}


class ConversionError(ValueError):
    pass


def _taints(raw: Optional[List[dict]]) -> List[Taint]:
    return [
        Taint(t["key"], t.get("value", ""), t.get("effect", "NoSchedule"))
        for t in (raw or [])
    ]


def _requirements(raw: Optional[List[dict]]) -> Requirements:
    out = Requirements()
    for r in raw or []:
        op = _OPS.get(r.get("operator", "In"))
        if op is None:
            raise ConversionError(
                f"unsupported requirement operator {r.get('operator')!r}"
            )
        key = r.get("key")
        if not key:
            raise ConversionError(f"requirement entry missing 'key': {r!r}")
        out.add(Requirement(key, op, [str(v) for v in r.get("values", [])]))
    return out


def convert_provisioner(raw: dict) -> NodePool:
    """v1alpha5 Provisioner -> NodePool (karpenter-convert semantics)."""
    if raw.get("kind") not in (None, "Provisioner"):
        raise ConversionError(f"not a Provisioner: kind={raw.get('kind')!r}")
    spec = raw.get("spec", {})
    name = raw.get("metadata", {}).get("name", "")
    if not name:
        raise ConversionError("provisioner has no metadata.name")

    ttl_empty = spec.get("ttlSecondsAfterEmpty")
    consolidation = (spec.get("consolidation") or {}).get("enabled", False)
    if ttl_empty is not None and consolidation:
        # the v1alpha5 webhook rejects this combination; refuse to guess
        raise ConversionError(
            "ttlSecondsAfterEmpty and consolidation.enabled are mutually "
            "exclusive (v1alpha5 validation)"
        )
    if consolidation:
        disruption = Disruption(
            consolidation_policy="WhenUnderutilized", consolidate_after=None
        )
    elif ttl_empty is not None:
        disruption = Disruption(
            consolidation_policy="WhenEmpty", consolidate_after=float(ttl_empty)
        )
    else:
        # neither mechanism: v1alpha5 never deprovisions empty nodes, so
        # the converted policy must NEVER act — WhenEmpty with an
        # infinite window (None would mean "immediately")
        disruption = Disruption(
            consolidation_policy="WhenEmpty",
            consolidate_after=float("inf"),
        )
    ttl_expired = spec.get("ttlSecondsUntilExpired")
    if ttl_expired is not None:
        disruption.expire_after = float(ttl_expired)

    provider_ref = (spec.get("providerRef") or {}).get("name", "")
    if spec.get("provider") is not None:
        raise ConversionError(
            "inline .spec.provider is not supported; extract it into an "
            "AWSNodeTemplate and use providerRef (karpenter-convert does "
            "the same)"
        )

    # Resources takes the mapping positionally, preserving resource names
    # verbatim (kwargs would corrupt names containing underscores)
    limits = Resources((spec.get("limits") or {}).get("resources") or {})

    kubelet = spec.get("kubeletConfiguration") or {}
    pool = NodePool(
        name=name,
        weight=int(spec.get("weight", 0)),
        requirements=_requirements(spec.get("requirements")),
        taints=_taints(spec.get("taints")),
        startup_taints=_taints(spec.get("startupTaints")),
        labels=dict(spec.get("labels") or {}),
        annotations=dict(spec.get("annotations") or {}),
        limits=limits,
        disruption=disruption,
        node_class_ref=provider_ref,
        kubelet_max_pods=kubelet.get("maxPods"),
    )
    # the v1alpha5 defaulting webhook dialect: os=linux, arch=amd64, and —
    # the behavioral one — capacity-type=on-demand (without it the
    # v1beta1 spot-if-flexible path would silently move workloads to spot)
    return default_node_pool(pool, legacy_defaults=True)


def _selector_terms(tag_map: Optional[Dict[str, str]]) -> List[SelectorTerm]:
    """v1alpha tag-map selector -> one v1beta1 selector term.  The map is
    a conjunction in both dialects; the special ``aws-ids`` key selects by
    id.  ``Name`` stays a TAG match (both dialects treat it as the Name
    tag, which is also how ``*`` wildcards keep working)."""
    if not tag_map:
        return []
    tags = dict(tag_map)
    ids = tags.pop("aws-ids", None) or tags.pop("aws::ids", None)
    if ids:
        # drop empty segments: a trailing comma must not become an
        # id="" term, which matches EVERYTHING
        return [
            SelectorTerm.of(id=i.strip()) for i in ids.split(",") if i.strip()
        ]
    return [SelectorTerm(tags=tuple(sorted(tags.items())))]


def convert_aws_node_template(raw: dict) -> NodeClass:
    """v1alpha1 AWSNodeTemplate -> NodeClass."""
    if raw.get("kind") not in (None, "AWSNodeTemplate"):
        raise ConversionError(
            f"not an AWSNodeTemplate: kind={raw.get('kind')!r}"
        )
    spec = raw.get("spec", {})
    name = raw.get("metadata", {}).get("name", "")
    if not name:
        raise ConversionError("node template has no metadata.name")
    family_raw = spec.get("amiFamily", "AL2")
    family = _FAMILIES.get(family_raw)
    if family is None:
        raise ConversionError(f"unknown amiFamily {family_raw!r}")
    bdms = []
    for m in spec.get("blockDeviceMappings") or []:
        ebs = m.get("ebs") or {}
        size = ebs.get("volumeSize")
        bdms.append(
            BlockDeviceMapping(
                device_name=m.get("deviceName", "/dev/xvda"),
                volume_size=(
                    parse_quantity(size)
                    if size is not None
                    else BlockDeviceMapping.volume_size
                ),
                volume_type=ebs.get("volumeType", "gp3"),
                encrypted=bool(ebs.get("encrypted", True)),
                delete_on_termination=bool(
                    ebs.get("deleteOnTermination", True)
                ),
            )
        )
    return NodeClass(
        name=name,
        image_family=family,
        subnet_selector_terms=_selector_terms(spec.get("subnetSelector")),
        security_group_selector_terms=_selector_terms(
            spec.get("securityGroupSelector")
        ),
        image_selector_terms=_selector_terms(spec.get("amiSelector")),
        launch_template_name=spec.get("launchTemplate", "") or "",
        user_data=spec.get("userData", "") or "",
        tags=dict(spec.get("tags") or {}),
        block_device_mappings=bdms,
        role=spec.get("instanceProfile", "") or "",
        detailed_monitoring=bool(spec.get("detailedMonitoring", False)),
        metadata_options=dict(spec.get("metadataOptions") or {}),
    )
