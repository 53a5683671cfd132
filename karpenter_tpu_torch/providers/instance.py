"""Instance provider: launch / terminate / describe machines.

Re-creation of reference pkg/providers/instance/instance.go:

- `create`: filter exotic types unless explicitly required (:478-499),
  spot-vs-OD mixed-offer filter (:451-473), price-ascending order capped at
  MAX_INSTANCE_TYPES=60 (:54,:391-408), capacity-type choice — spot iff the
  claim is flexible to spot and a spot offering exists (:376-389) —
  zonal-subnet selection with in-flight IP tracking (subnet.go:110-146),
  launch-template resolution, the (type x zone x subnet) override
  cross-product (:324-363), a coalesced CreateFleet (batcher
  createfleet.go:42-60), insufficient-capacity feedback into the ICE cache
  (:365-371), and one retry on a stale launch template (:94-98).
- `delete` / `get` / `list`: coalesced TerminateInstances /
  DescribeInstances with the managed-by tag filter.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import InstanceType, NodeClaim, NodeClass, NodePool
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.batcher.core import (
    Batcher,
    CREATE_FLEET_WINDOWS,
    DESCRIBE_WINDOWS,
    TERMINATE_WINDOWS,
)
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.fake.backend import (
    FakeCloud,
    FakeInstance,
    InsufficientCapacityError,
    LaunchTemplateNotFoundError,
)
from karpenter_tpu_torch.errors import (
    InsufficientCapacityAggregateError,
    NodeClaimNotFoundError,
    NoImageResolvedError,
)
from karpenter_tpu_torch.providers.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider

log = logging.getLogger(__name__)

# cap on instance-type diversity per CreateFleet (reference instance.go:54)
MAX_INSTANCE_TYPES = 60
# below this many types, warn that on-demand fallback flexibility is low
# (reference instance.go:55,274-295)
MIN_FLEXIBLE_TYPES = 5


class InstanceProvider:
    def __init__(
        self,
        cloud: FakeCloud,
        subnets: SubnetProvider,
        launch_templates: LaunchTemplateProvider,
        unavailable: UnavailableOfferings,
        tags: Optional[Mapping[str, str]] = None,
        batch_windows: Optional[dict] = None,
        registry=None,
    ):
        self.cloud = cloud
        self.subnets = subnets
        self.launch_templates = launch_templates
        self.unavailable = unavailable
        self.base_tags = dict(tags or {})
        windows = batch_windows or {}
        cf = windows.get("create_fleet", CREATE_FLEET_WINDOWS)
        de = windows.get("describe", DESCRIBE_WINDOWS)
        te = windows.get("terminate", TERMINATE_WINDOWS)
        # CreateFleet merges N identical single-capacity requests into one
        # call with TotalTargetCapacity=N (reference createfleet.go:42-60)
        self._fleet_batcher = Batcher(
            executor=self._exec_create_fleet,
            idle_s=cf[0], max_s=cf[1], max_items=cf[2],
            hasher=lambda req: req["hash"],
            name="create-fleet", registry=registry,
        )
        self._describe_batcher = Batcher(
            executor=self._exec_describe,
            idle_s=de[0], max_s=de[1], max_items=de[2],
            name="describe-instances", registry=registry,
        )
        self._terminate_batcher = Batcher(
            executor=self._exec_terminate,
            idle_s=te[0], max_s=te[1], max_items=te[2],
            name="terminate-instances", registry=registry,
        )

    # ------------------------------------------------------------------ create
    def create(
        self,
        claim: NodeClaim,
        node_class: NodeClass,
        instance_types: Sequence[InstanceType],
    ) -> FakeInstance:
        types = self._filter_instance_types(claim, list(instance_types))
        types = self._order_and_cap(types, claim)
        if not types:
            raise InsufficientCapacityAggregateError([])
        if len(types) < MIN_FLEXIBLE_TYPES:
            log.warning(
                "launching %s with only %d instance-type options; "
                "capacity errors are more likely",
                claim.name, len(types),
            )
        capacity_type = self._capacity_type(claim, types)
        try:
            return self._launch(claim, node_class, types, capacity_type)
        except LaunchTemplateNotFoundError as exc:
            if node_class.launch_template_name:
                # user-owned static template vanished: recreating it is not
                # ours to do — surface the error
                raise
            # the cached managed template went stale (deleted out-of-band):
            # drop ONLY that template and retry ONCE (instance.go:94-98);
            # a blanket invalidation would break concurrent launches that
            # are mid-flight against other, perfectly valid templates
            log.debug("stale launch template for %s; recreating", claim.name)
            self.launch_templates.invalidate_template(exc.name)
            return self._launch(claim, node_class, types, capacity_type)

    def _launch(
        self,
        claim: NodeClaim,
        node_class: NodeClass,
        types: List[InstanceType],
        capacity_type: str,
    ) -> FakeInstance:
        zones = self._allowed_zones(claim, types, capacity_type)
        chosen_subnets = self.subnets.zonal_subnets_for_launch(node_class, zones)
        if not chosen_subnets:
            raise InsufficientCapacityAggregateError([])
        templates = self.launch_templates.ensure_all(
            node_class, _pool_stub(claim), types
        )
        if not templates:
            # launching template-less would boot an unconfigured machine;
            # fail the claim with an actionable error instead
            self.subnets.update_inflight_ips(chosen_subnets, [])
            raise NoImageResolvedError(node_class.name)
        overrides = self._overrides(
            types, chosen_subnets, capacity_type, claim
        )
        if not overrides:
            self.subnets.update_inflight_ips(chosen_subnets, [])
            raise InsufficientCapacityAggregateError([])
        template = templates[0]
        # fleet-level tags carry only POOL-level identity: claim-specific
        # tags (Name, nodeclaim) would make merged batch requests lie about
        # N-1 of the N instances (the reference's batcher hashes the whole
        # CreateFleetInput, so only identical requests merge — here the
        # claim tags are stamped per instance after launch instead)
        request = {
            "overrides": overrides,
            "capacity_type": capacity_type,
            "launch_template": template.name,
            "image_id": template.image_id,
            "security_group_ids": list(template.security_group_ids),
            "tags": {
                **self.base_tags,
                **node_class.tags,
                L.ANNOTATION_MANAGED_BY: "karpenter-tpu",
                "karpenter.sh/nodepool": claim.pool_name,
            },
        }
        request["hash"] = self._fleet_hash(request)
        try:
            instance, errors = self._fleet_batcher.call(request)
        except Exception:
            # refund the in-flight IP reservation on any fleet failure
            # (stale template, API error) so subnet accounting stays sound
            self.subnets.update_inflight_ips(chosen_subnets, [])
            raise
        # capacity-error feedback keeps failed pools masked for 3m
        # (reference instance.go:365-371)
        for err in errors:
            itype, zone, ct = err.pool
            self.unavailable.mark_unavailable(ct, itype, zone, reason=err.code)
        self.subnets.update_inflight_ips(
            chosen_subnets, [instance.subnet_id] if instance else []
        )
        if instance is None:
            raise InsufficientCapacityAggregateError(
                [e.pool for e in errors]
            )
        # claim-specific attribution tags, stamped on THIS instance only
        # (LinkController adoption and _instance_to_claim read these)
        self.cloud.create_tags(
            instance.id,
            {"Name": claim.name, "karpenter.sh/nodeclaim": claim.name},
        )
        return instance

    # -------------------------------------------------------- create helpers
    def _filter_instance_types(
        self, claim: NodeClaim, types: List[InstanceType]
    ) -> List[InstanceType]:
        """Drop exotic shapes unless the claim explicitly asks for them
        (reference instance.go:478-499): bare metal and accelerator types
        only launch when the claim requests the accelerator resource or
        pins the type."""
        pinned = claim.requirements.get(L.LABEL_INSTANCE_TYPE)
        wants_gpu = claim.requests.get(L.RESOURCE_GPU) > 0
        wants_tpu = claim.requests.get(L.RESOURCE_TPU) > 0
        out = []
        for it in types:
            if pinned is not None and pinned.has(it.name):
                out.append(it)
                continue
            has_gpu = it.capacity.get(L.RESOURCE_GPU) > 0
            has_tpu = it.capacity.get(L.RESOURCE_TPU) > 0
            if has_gpu and not wants_gpu:
                continue
            if has_tpu and not wants_tpu:
                continue
            out.append(it)
        return out or list(types)

    def _order_and_cap(
        self, types: List[InstanceType], claim: NodeClaim
    ) -> List[InstanceType]:
        """Price-ascending, truncated to MAX_INSTANCE_TYPES
        (reference instance.go:88-91,391-408)."""
        priced = [
            (it.cheapest_price(claim.requirements), it)
            for it in types
            if it.cheapest_price(claim.requirements) != float("inf")
        ]
        priced.sort(key=lambda pair: pair[0])
        return [it for _, it in priced[:MAX_INSTANCE_TYPES]]

    def _capacity_type(
        self, claim: NodeClaim, types: Sequence[InstanceType]
    ) -> str:
        """Spot iff the claim tolerates spot and any spot offering is
        available (reference instance.go:376-389)."""
        req = claim.requirements.get(L.LABEL_CAPACITY_TYPE)
        if req is None or req.has(L.CAPACITY_TYPE_SPOT):
            for it in types:
                for o in it.offerings.available():
                    if o.capacity_type == L.CAPACITY_TYPE_SPOT and (
                        req is None or req.has(L.CAPACITY_TYPE_SPOT)
                    ):
                        return L.CAPACITY_TYPE_SPOT
        return L.CAPACITY_TYPE_ON_DEMAND

    def _allowed_zones(
        self,
        claim: NodeClaim,
        types: Sequence[InstanceType],
        capacity_type: str,
    ) -> List[str]:
        zr = claim.requirements.get(L.LABEL_ZONE)
        zones = set()
        for it in types:
            for o in it.offerings.available():
                if o.capacity_type != capacity_type:
                    continue
                if zr is not None and not zr.has(o.zone):
                    continue
                zones.add(o.zone)
        return sorted(zones)

    def _overrides(
        self,
        types: Sequence[InstanceType],
        subnets: Mapping[str, object],
        capacity_type: str,
        claim: NodeClaim,
    ) -> List[dict]:
        """(instance type x zone x subnet) candidates
        (reference instance.go:324-363)."""
        zr = claim.requirements.get(L.LABEL_ZONE)
        out = []
        for it in types:
            for o in it.offerings.available():
                if o.capacity_type != capacity_type:
                    continue
                if zr is not None and not zr.has(o.zone):
                    continue
                subnet = subnets.get(o.zone)
                if subnet is None:
                    continue
                out.append(
                    {
                        "instance_type": it.name,
                        "zone": o.zone,
                        "subnet_id": subnet.id,
                        "price": o.price,
                    }
                )
        return out

    @staticmethod
    def _fleet_hash(request: dict) -> tuple:
        """Bucket key covering the ENTIRE merged request — only requests
        whose every field matches may coalesce (the reference hashes the
        whole CreateFleetInput, createfleet.go:44-55)."""
        return (
            request["launch_template"],
            request["image_id"],
            tuple(request["security_group_ids"]),
            request["capacity_type"],
            tuple(sorted(request["tags"].items())),
            tuple(
                sorted(
                    (o["instance_type"], o["zone"], o["subnet_id"])
                    for o in request["overrides"]
                )
            ),
        )

    # ----------------------------------------------------------- batch execs
    def _exec_create_fleet(self, requests: Sequence[dict]):
        """Merged CreateFleet: N single-capacity requests -> one call with
        count=N (reference createfleet.go:42-60); instances fan back out in
        request order, shortfalls become per-request None + shared errors."""
        first = requests[0]
        instances, errors = self.cloud.create_fleet(
            overrides=first["overrides"],
            capacity_type=first["capacity_type"],
            count=len(requests),
            launch_template=first["launch_template"],
            image_id=first["image_id"],
            security_group_ids=first["security_group_ids"],
            tags=first["tags"],
        )
        results = []
        for i in range(len(requests)):
            inst = instances[i] if i < len(instances) else None
            results.append((inst, errors))
        return results

    def _exec_describe(self, requests: Sequence[Tuple[str, ...]]):
        ids = sorted({i for req in requests for i in req})
        found = {
            inst.id: inst
            for inst in self.cloud.describe_instances(ids=ids)
        }
        return [
            [found[i] for i in req if i in found] for req in requests
        ]

    def _exec_terminate(self, requests: Sequence[str]):
        done = set(self.cloud.terminate_instances(list(dict.fromkeys(requests))))
        return [i in done for i in requests]

    # ------------------------------------------------------------- get/list
    def get(self, instance_id: str) -> FakeInstance:
        found = self._describe_batcher.call((instance_id,))
        if not found or found[0].state == "terminated":
            raise NodeClaimNotFoundError(instance_id)
        return found[0]

    def list(self) -> List[FakeInstance]:
        """All live instances managed by this controller."""
        return [
            i
            for i in self.cloud.describe_instances(
                tag_filters={L.ANNOTATION_MANAGED_BY: "*"}
            )
            if i.state not in ("terminated", "shutting-down")
        ]

    def delete(self, instance_id: str) -> None:
        terminated = self._terminate_batcher.call(instance_id)
        if not terminated:
            raise NodeClaimNotFoundError(instance_id)


def _pool_stub(claim: NodeClaim) -> NodePool:
    """The launch-template resolver only reads pool identity/taints/kubelet
    config, all of which the claim carries — build a stub pool from it."""
    return NodePool(
        name=claim.pool_name,
        taints=list(claim.taints),
        startup_taints=list(claim.startup_taints),
        kubelet_max_pods=claim.kubelet_max_pods,
    )
