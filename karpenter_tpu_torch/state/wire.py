"""Wire codec for cluster-store objects: typed JSON, no pickling.

The shared-store subsystem (service/store_server.py + state/remote.py)
ships every KubeStore object over the same length-prefixed socket frames
the solver sidecar uses (service/codec.py).  Like the solver protocol,
the store protocol must never execute peer-controlled payloads, so
objects travel as tagged JSON trees, not pickles: each node is either a
JSON native or a one-key tag —

    {"!dc": "ClassName", "f": {field: value, ...}}   dataclass
    {"!res": {axis: float}}                          Resources (canonical units)
    {"!req": {...normalized Requirement fields...}}  Requirement
    {"!reqs": [...]}                                 Requirements conjunction
    {"!t": [...]}                                    tuple
    {"!fs": [...]}                                   frozenset (sorted)
    {"!m": {...}}                                    plain mapping

Only classes in the registry decode — an unknown tag is an error, never
an attribute lookup on arbitrary names.  ``canonical`` (sort_keys dumps)
is the byte form used for resourceVersion shadow-diffing on the client:
two semantically equal objects encode to equal bytes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

from karpenter_tpu_torch.api.objects import (
    BlockDeviceMapping,
    Disruption,
    NodeClaim,
    NodeClass,
    NodePool,
    Overhead,
    PersistentVolumeClaim,
    Pod,
    PodAffinityTerm,
    SelectorTerm,
    StorageClass,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.requirements import Requirement, Requirements
from karpenter_tpu_torch.api.resources import Resources
from karpenter_tpu_torch.state.kube import Node, PodDisruptionBudget
from karpenter_tpu_torch.utils.leader import Lease

# the CLOSED set of classes the store protocol itself ships.  The binary
# codec (state/binwire.py) derives its class-id table and schema
# fingerprint from exactly this tuple, so it must stay static: classes
# added later via register_dataclass extend the tagged-JSON codec only
# (the simulator's trace lines), never the negotiated binary protocol.
STORE_WIRE_CLASSES = (
    BlockDeviceMapping,
    Disruption,
    Lease,
    Node,
    NodeClaim,
    NodeClass,
    NodePool,
    Overhead,
    PersistentVolumeClaim,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    SelectorTerm,
    StorageClass,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)

_DATACLASSES = {cls.__name__: cls for cls in STORE_WIRE_CLASSES}

def register_dataclass(cls: type) -> type:
    """Extend the wire codec with an additional dataclass.

    The store protocol itself only ever ships the closed set above, but
    the codec is reused by other subsystems — the cluster simulator's
    trace (sim/trace.py) encodes fake-cloud objects (MachineShape,
    FakeImage, ...) through the same tagged-JSON rules.  Registration is
    idempotent; a NAME collision with a different class is an error, so
    no registered kind can ever be silently re-bound."""
    existing = _DATACLASSES.get(cls.__name__)
    if existing is not None and existing is not cls:
        raise ValueError(
            f"wire dataclass name collision: {cls.__name__!r} already "
            f"registered to {existing.__module__}.{existing.__qualname__}"
        )
    _DATACLASSES[cls.__name__] = cls
    return cls


# kind name -> (class, KubeStore dict attribute, key function)
STORE_KINDS: Dict[str, Tuple[type, str, Any]] = {
    "Pod": (Pod, "pods", lambda o: o.key()),
    "Node": (Node, "nodes", lambda o: o.name),
    "NodeClaim": (NodeClaim, "node_claims", lambda o: o.name),
    "NodePool": (NodePool, "node_pools", lambda o: o.name),
    "NodeClass": (NodeClass, "node_classes", lambda o: o.name),
    "PodDisruptionBudget": (PodDisruptionBudget, "pdbs", lambda o: o.name),
    "StorageClass": (StorageClass, "storage_classes", lambda o: o.name),
    "PersistentVolumeClaim": (
        PersistentVolumeClaim,
        "pvcs",
        lambda o: o.key(),
    ),
    "Lease": (Lease, "leases", lambda o: o.name),
}


def to_wire(value: Any) -> Any:
    """Object tree -> tagged-JSON tree (see module docstring)."""
    if isinstance(value, Resources):
        return {"!res": value.to_dict()}
    if isinstance(value, Requirements):
        return {"!reqs": [to_wire(r) for r in value]}
    if isinstance(value, Requirement):
        return {
            "!req": {
                "key": value.key,
                "complement": value.complement,
                "values": sorted(value.values),
                "gt": value.greater_than,
                "lt": value.less_than,
                "min_values": value.min_values,
                "absent_ok": value.absent_ok,
            }
        }
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            "!dc": type(value).__name__,
            "f": {
                f.name: to_wire(getattr(value, f.name))
                for f in dataclasses.fields(value)
            },
        }
    if isinstance(value, tuple):
        return {"!t": [to_wire(v) for v in value]}
    if isinstance(value, frozenset):
        return {"!fs": sorted(to_wire(v) for v in value)}
    if isinstance(value, dict):
        return {"!m": {str(k): to_wire(v) for k, v in value.items()}}
    if isinstance(value, list):
        return [to_wire(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(f"unencodable store value: {type(value).__name__}")


def from_wire(data: Any) -> Any:
    """Tagged-JSON tree -> object tree.  Unknown tags/classes error."""
    if isinstance(data, dict):
        if "!res" in data:
            return Resources._from_raw(
                {k: float(v) for k, v in data["!res"].items()}
            )
        if "!reqs" in data:
            return Requirements(from_wire(r) for r in data["!reqs"])
        if "!req" in data:
            r = data["!req"]
            return Requirement._raw(
                r["key"],
                r["complement"],
                frozenset(r["values"]),
                r["gt"],
                r["lt"],
                r["min_values"],
                r["absent_ok"],
            )
        if "!dc" in data:
            cls = _DATACLASSES.get(data["!dc"])
            if cls is None:
                raise ValueError(f"unknown wire dataclass: {data['!dc']!r}")
            return cls(**{k: from_wire(v) for k, v in data["f"].items()})
        if "!t" in data:
            return tuple(from_wire(v) for v in data["!t"])
        if "!fs" in data:
            return frozenset(from_wire(v) for v in data["!fs"])
        if "!m" in data:
            return {k: from_wire(v) for k, v in data["!m"].items()}
        raise ValueError(f"untagged wire mapping: {sorted(data)[:3]}")
    if isinstance(data, list):
        return [from_wire(v) for v in data]
    return data


def materialize(value: Any) -> Any:
    """Wire tree OR already-decoded value -> decoded value.

    The negotiated binary codec (state/binwire.py) ships store objects
    natively, so an event's ``obj`` may arrive as a live dataclass (or a
    tuple, for cluster-event appends) instead of a tagged tree; the
    tagged-JSON path always ships trees.  Both halves of the store plane
    normalize through this one seam."""
    return from_wire(value) if isinstance(value, (dict, list)) else value


def canonical(obj: Any) -> str:
    """Deterministic byte form of an object (shadow-diffing + equality)."""
    return json.dumps(to_wire(obj), sort_keys=True, separators=(",", ":"))
