"""Launch-template provider (reference pkg/providers/launchtemplate).

`ensure_all` resolves a (node class, pool) into one launch template per
(image, max_pods) group and creates/caches templates by an options hash
(launchtemplate.go:99-126,139-145).  A static template name on the node
class bypasses resolution entirely (launchtemplate.go:104-107).  The cache
maps hash -> template name; on start the cache is hydrated from the
cloud-side template store (launchtemplate.go:323-339), and cache eviction
deletes the remote template (launchtemplate.go:340-357).
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence

from karpenter_tpu_torch.api import InstanceType, NodeClass, NodePool
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cache.ttl import DEFAULT_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, FakeLaunchTemplate
from karpenter_tpu_torch.providers.image import LaunchSpec, Resolver
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

# tag key recording the options hash on the remote template, so a restarted
# controller can rebuild the hash -> name map (launchtemplate.go:323-339)
OPTIONS_HASH_TAG = "karpenter.sh/options-hash"
CLUSTER_TAG = "karpenter.sh/cluster"


@dataclass
class LaunchTemplate:
    """A resolved, ready-to-launch template."""

    name: str
    image_id: str
    security_group_ids: List[str]
    user_data: str
    instance_types: List[InstanceType]
    max_pods: Optional[int] = None
    static: bool = False  # spec.launchTemplateName passthrough


class LaunchTemplateProvider:
    def __init__(
        self,
        cloud: FakeCloud,
        resolver: Resolver,
        security_groups: SecurityGroupProvider,
        clock: Clock,
        cluster_name: str = "",
        cluster_endpoint: str = "",
    ):
        self.cloud = cloud
        self.resolver = resolver
        self.security_groups = security_groups
        self.cluster_name = cluster_name
        self.cluster_endpoint = cluster_endpoint
        if not cluster_name:
            # Settings.validate() makes this unreachable through the
            # Operator; a directly-constructed anonymous provider cannot
            # re-adopt its templates after restart, so they leak remotely
            log.warning(
                "launch-template provider has no cluster name: templates "
                "created now cannot be re-owned after a restart"
            )
        # options hash -> template name; expiry deletes the remote template
        self._cache = TTLCache(clock, DEFAULT_TTL, on_evict=self._evict)
        self.hydrate()

    # ------------------------------------------------------------- hydration
    def hydrate(self) -> None:
        """Rebuild the cache from cloud-side templates tagged for this
        cluster, so repeat launches after a restart reuse templates instead
        of recreating them (launchtemplate.go:323-339).  Adoption requires
        an EXACT cluster-tag match: with no cluster name configured there
        is no safe ownership claim, so nothing is adopted (cache eviction
        deletes remote templates — wildcard adoption would make this
        provider delete other clusters' templates)."""
        if not self.cluster_name:
            return
        for lt in self.cloud.describe_launch_templates(
            tag_filters={CLUSTER_TAG: self.cluster_name}
        ):
            h = lt.tags.get(OPTIONS_HASH_TAG)
            if h:
                self._cache.set(h, lt.name)

    # ------------------------------------------------------------ ensure_all
    def ensure_all(
        self,
        node_class: NodeClass,
        pool: NodePool,
        instance_types: Sequence[InstanceType],
    ) -> List[LaunchTemplate]:
        """One launch template per (image, max_pods) group covering the
        requested instance types (launchtemplate.go:99-126).  A static
        `launch_template_name` on the node class bypasses resolution
        (launchtemplate.go:104-107) — the user owns that template."""
        self._cache.purge_expired()
        if node_class.launch_template_name:
            return [self._static(node_class, list(instance_types))]
        sg_ids = [g.id for g in self.security_groups.list(node_class)]
        specs = self.resolver.resolve(
            node_class,
            pool,
            instance_types,
            cluster_name=self.cluster_name,
            cluster_endpoint=self.cluster_endpoint,
        )
        out: List[LaunchTemplate] = []
        for spec in specs:
            h = self._options_hash(node_class, spec, sg_ids)
            name = self._cache.get(h)
            if name is not None:
                self._cache.touch(h)  # keep hot templates alive
            else:
                name = f"lt-{h}"
                self.cloud.create_launch_template(
                    FakeLaunchTemplate(
                        name=name,
                        image_id=spec.image_id,
                        security_group_ids=list(sg_ids),
                        user_data=spec.user_data,
                        block_device_mappings=list(spec.block_device_mappings),
                        tags={
                            CLUSTER_TAG: self.cluster_name,
                            OPTIONS_HASH_TAG: h,
                            L.ANNOTATION_MANAGED_BY: "karpenter-tpu",
                        },
                    )
                )
                self._cache.set(h, name)
            out.append(
                LaunchTemplate(
                    name=name,
                    image_id=spec.image_id,
                    security_group_ids=sg_ids,
                    user_data=spec.user_data,
                    instance_types=spec.instance_types,
                    max_pods=spec.max_pods,
                )
            )
        return out

    def _static(
        self, node_class: NodeClass, instance_types: List[InstanceType]
    ) -> LaunchTemplate:
        """User-owned template: pass through by name; image/SGs come from
        the template itself at launch time."""
        lt = self.cloud.launch_templates.get(node_class.launch_template_name)
        return LaunchTemplate(
            name=node_class.launch_template_name,
            image_id=lt.image_id if lt else "",
            security_group_ids=list(lt.security_group_ids) if lt else [],
            user_data=lt.user_data if lt else "",
            instance_types=instance_types,
            static=True,
        )

    @staticmethod
    def _options_hash(
        node_class: NodeClass, spec: LaunchSpec, sg_ids: Sequence[str]
    ) -> str:
        payload = {
            "image": spec.image_id,
            "max_pods": spec.max_pods,
            "sgs": sorted(sg_ids),
            "user_data": spec.user_data,
            # full storage layout: resizing or re-typing a volume must
            # rotate the template, not just renaming the device
            "bdm": [
                (
                    b.device_name,
                    b.volume_size,
                    b.volume_type,
                    b.encrypted,
                    b.delete_on_termination,
                )
                for b in spec.block_device_mappings
            ],
            "monitoring": node_class.detailed_monitoring,
            "tags": sorted(node_class.tags.items()),
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()[:12]

    # ------------------------------------------------------------- eviction
    def _evict(self, _hash: str, name: str) -> None:
        """Cache eviction deletes the remote template
        (launchtemplate.go:340-357)."""
        self.cloud.delete_launch_template(name)

    def invalidate(self) -> None:
        """Drop every cached template (e.g. after node-class drift) so the
        next launch re-resolves; the remote templates are deleted like any
        other eviction."""
        for h in list(self._cache.keys()):
            name = self._cache.get(h)
            self._cache.delete(h)
            if name is not None:
                self._evict(h, name)

    def invalidate_template(self, name: str) -> None:
        """Drop the cache entry for a template OBSERVED MISSING remotely
        (the stale-launch-template retry): only the failing template is
        re-resolved, so concurrent launches against other templates keep
        their cache entries — and their single retry.  No remote delete:
        the template is already gone, and a concurrent retry may have just
        recreated it under the same deterministic name — deleting here
        would tear down that fresh template and burn the peer's retry."""
        for h in list(self._cache.keys()):
            if self._cache.get(h) == name:
                self._cache.delete(h)
