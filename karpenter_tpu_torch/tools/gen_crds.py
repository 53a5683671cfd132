"""CRD generator: OpenAPI v3 schemas for the API objects, from source.

The reference ships its CustomResourceDefinitions as a separate chart
(charts/karpenter-crd/ — provisioners, machines, nodepools, nodeclaims,
awsnodetemplates), generated from the Go types by controller-gen.  The
analogue here derives the CRD schemas from the dataclasses in
api/objects.py, so the install story (deploy/crds/) can never drift from
the code — tests/test_deploy.py asserts regeneration is a no-op, the
same codegen-freshness contract as docs/metrics.md.

``deploy/crds/`` is the JAX package's install story, shared by the port:
the port's api/objects.py is a copy of the reference's, so this generator
renders the same files byte for byte, their `HEADER` (which names the
reference's generator) included, and regenerating with either package is
a no-op (tests/test_torch_deploy.py).

Usage::

    python -m karpenter_tpu_torch.tools.gen_crds [out_dir]
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import sys

GROUP = "karpenter.tpu.sh"
VERSION = "v1beta1"
# the first line of every generated file, as the checked-in files carry it
HEADER = "# generated by karpenter_tpu.tools.gen_crds — do not edit\n"

# dataclass field type annotation -> OpenAPI schema node.  Complex value
# objects (Requirements, Resources, nested dataclass lists) keep an open
# schema: their validation runs in-process at admission
# (api/validation.py), which is this build's webhook analogue.
_SCALARS = {
    "str": {"type": "string"},
    "int": {"type": "integer"},
    "float": {"type": "number"},
    "bool": {"type": "boolean"},
}


def _schema_for(annotation: str) -> dict:
    ann = annotation.strip()
    m = re.fullmatch(r"Optional\[(.+)\]", ann)
    if m:
        return _schema_for(m.group(1))
    if ann in _SCALARS:
        return dict(_SCALARS[ann])
    m = re.fullmatch(r"List\[(.+)\]", ann)
    if m:
        inner = m.group(1)
        if inner in _SCALARS:
            return {"type": "array", "items": dict(_SCALARS[inner])}
        return {
            "type": "array",
            "items": {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            },
        }
    m = re.fullmatch(r"Dict\[str, (.+)\]", ann)
    if m:
        inner = m.group(1)
        vals = (
            dict(_SCALARS[inner])
            if inner in _SCALARS
            else {"x-kubernetes-preserve-unknown-fields": True}
        )
        return {"type": "object", "additionalProperties": vals}
    return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}


def _camel(snake: str) -> str:
    head, *rest = snake.split("_")
    return head + "".join(p.capitalize() for p in rest)


# fields that are controller-written state, not user spec
_STATUS_FIELDS = {
    "NodeClass": {
        "resolved_subnets", "resolved_security_groups", "resolved_images",
        "resolved_instance_profile",
    },
    "NodeClaim": {
        "provider_id", "instance_type_name", "zone", "capacity_type",
        "image_id", "price", "capacity", "allocatable", "conditions",
        "created_at",
    },
    "NodePool": set(),
}

# object-level bookkeeping that never appears in a manifest
_SKIP_FIELDS = {"name", "deleted"}


def _crd(cls) -> dict:
    kind = cls.__name__
    low = kind.lower()
    plural = low + ("es" if low.endswith("s") else "s")
    spec_props, status_props = {}, {}
    for f in dataclasses.fields(cls):
        if f.name in _SKIP_FIELDS:
            continue
        target = (
            status_props
            if f.name in _STATUS_FIELDS.get(kind, set())
            else spec_props
        )
        target[_camel(f.name)] = _schema_for(str(f.type))
    schema = {
        "type": "object",
        "properties": {
            "spec": {"type": "object", "properties": spec_props},
            "status": {"type": "object", "properties": status_props},
        },
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": low,
            },
            "scope": "Cluster",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "schema": {"openAPIV3Schema": schema},
                }
            ],
        },
    }


def generate() -> dict:
    """crd file name -> rendered YAML text."""
    import yaml

    from karpenter_tpu_torch.api.objects import NodeClaim, NodeClass, NodePool

    out = {}
    for cls in (NodePool, NodeClaim, NodeClass):
        low = cls.__name__.lower()
        plural = low + ("es" if low.endswith("s") else "s")
        name = f"{GROUP}_{plural}.yaml"
        out[name] = HEADER + yaml.safe_dump(_crd(cls), sort_keys=True)
    return out


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    out_dir = pathlib.Path(args[0] if args else "deploy/crds")
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in generate().items():
        (out_dir / name).write_text(text)
        print(f"wrote {out_dir / name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
