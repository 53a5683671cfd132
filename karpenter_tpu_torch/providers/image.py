"""Image family provider + resolver (reference pkg/providers/amifamily).

Families (reference al2.go / bottlerocket.go / ubuntu.go / windows.go /
custom.go) map here to "standard" / "accelerated" / "custom": each family
supplies a default-image query (the SSM-parameter analogue,
ami.go:65-79), boot user-data generation (bootstrap/bootstrap.go:124), and
block-device defaults.

`Resolver.resolve` reproduces resolver.go:118-177: discover candidate
images (selector terms or family default), map each instance type to the
newest compatible image by requirements (ami.go:94-105), then group types
again by (image, max_pods) so each group becomes one launch-template spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import InstanceType, NodeClass, NodePool, Requirements
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import BlockDeviceMapping
from karpenter_tpu_torch.api.requirements import Op, Requirement
from karpenter_tpu_torch.cache.ttl import DEFAULT_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, FakeImage
from karpenter_tpu_torch.providers.bootstrap import (
    BootstrapConfig,
    Bootstrapper,
    CustomBootstrap,
    ShellBootstrap,
    TomlBootstrap,
)
from karpenter_tpu_torch.providers.stale import StaleGuard
from karpenter_tpu_torch.utils.clock import Clock


@dataclass(frozen=True)
class ImageFamily:
    """One AMI-family analogue: default-image query key, bootstrapper,
    and block-device defaults (reference al2.go / bottlerocket.go /
    custom.go each implement exactly this trio)."""

    name: str
    bootstrapper: Callable[[BootstrapConfig], Bootstrapper]
    # default storage layout when the node class doesn't specify one
    # (reference DefaultBlockDeviceMappings per family)
    block_device_defaults: Tuple[BlockDeviceMapping, ...]


FAMILIES: Dict[str, ImageFamily] = {
    # shell/MIME boot like AL2/Ubuntu: one general-purpose root volume
    # (al2.go:99-108)
    "standard": ImageFamily(
        name="standard",
        bootstrapper=ShellBootstrap,
        block_device_defaults=(BlockDeviceMapping(device_name="/dev/xvda"),),
    ),
    # settings-document boot like Bottlerocket: a small immutable OS
    # volume plus the data volume (bottlerocket.go:112-126)
    "accelerated": ImageFamily(
        name="accelerated",
        bootstrapper=TomlBootstrap,
        block_device_defaults=(
            BlockDeviceMapping(device_name="/dev/xvda", volume_size=4 * 2**30),
            BlockDeviceMapping(device_name="/dev/xvdb"),
        ),
    ),
    # verbatim passthrough: the user owns boot config AND storage layout
    # (custom.go — DefaultBlockDeviceMappings is nil)
    "custom": ImageFamily(
        name="custom",
        bootstrapper=CustomBootstrap,
        block_device_defaults=(),
    ),
}

IMAGE_FAMILIES = tuple(FAMILIES)


def _image_requirements(im: FakeImage) -> Requirements:
    return Requirements([Requirement(L.LABEL_ARCH, Op.IN, [im.arch])])


@dataclass
class ImageCandidate:
    image: FakeImage
    requirements: Requirements


@dataclass
class LaunchSpec:
    """One (image, max_pods) group -> one launch template
    (reference resolver.go:118-177 Resolve output)."""

    image_id: str
    instance_types: List[InstanceType]
    max_pods: Optional[int]
    user_data: str
    block_device_mappings: List[BlockDeviceMapping] = field(default_factory=list)


class ImageProvider:
    """Image discovery with a TTL cache (reference ami.go:118-235)."""

    def __init__(self, cloud: FakeCloud, clock: Clock, registry=None):
        self.cloud = cloud
        self.registry = registry
        self._cache = TTLCache(clock, DEFAULT_TTL)
        self._stale = StaleGuard("image", clock, registry)

    def _discover(self, node_class: NodeClass) -> List[FakeImage]:
        if node_class.image_selector_terms:
            return self.cloud.describe_images(node_class.image_selector_terms)
        family = image_family(node_class).name
        images = []
        for arch in ("amd64", "arm64"):
            im = self.cloud.latest_image(family, arch)
            if im is not None:
                images.append(im)
        return images

    def list(self, node_class: NodeClass) -> List[ImageCandidate]:
        """Candidate images for a node class, newest-first.

        Selector terms take precedence; otherwise the family default (the
        SSM-parameter analogue) per architecture.
        """
        key = (
            tuple(node_class.image_selector_terms),
            node_class.image_family,
        )
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        images, fresh = self._stale.fetch(
            key, lambda: self._discover(node_class)
        )
        images = sorted(images, key=lambda im: -im.created_at)
        out = [ImageCandidate(im, _image_requirements(im)) for im in images]
        if fresh:
            self._cache.set(key, out)
        return out

    def invalidate(self) -> None:
        """Flush the image cache (catalog roll).  Ledgered: the compile
        storms and drift churn that follow a roll start HERE, and the
        doctor's "compile-cache misses spiked after the catalog roll"
        correlation needs the trigger to be a ledger fact, not an
        inference (obs/doctor.py)."""
        self._cache.flush()
        if self.registry is not None:
            self.registry.event("CatalogRolled", provider="image")


def image_family(node_class: NodeClass) -> ImageFamily:
    return FAMILIES.get(node_class.image_family, FAMILIES["standard"])


def generate_user_data(
    node_class: NodeClass,
    pool: NodePool,
    cluster_name: str,
    cluster_endpoint: str,
    max_pods: Optional[int] = None,
) -> str:
    """Boot configuration for a node, in the node class's family format
    (reference resolver.go:179-186 hands Options to the family's
    UserData(); the Bootstrapper owns the document shape)."""
    cfg = BootstrapConfig(
        cluster_name=cluster_name,
        cluster_endpoint=cluster_endpoint,
        node_pool=pool.name,
        labels={**pool.labels, L.LABEL_NODEPOOL: pool.name},
        taints=list(pool.taints) + list(pool.startup_taints),
        max_pods=max_pods if max_pods is not None else pool.kubelet_max_pods,
        custom_user_data=node_class.user_data,
    )
    return image_family(node_class).bootstrapper(cfg).script()


class Resolver:
    """(NodeClass, NodePool, instance types) -> launch specs
    (reference resolver.go:44-110)."""

    def __init__(self, image_provider: ImageProvider):
        self.images = image_provider

    def resolve(
        self,
        node_class: NodeClass,
        pool: NodePool,
        instance_types: Sequence[InstanceType],
        cluster_name: str = "",
        cluster_endpoint: str = "",
    ) -> List[LaunchSpec]:
        candidates = self.images.list(node_class)
        if not candidates:
            return []
        # newest compatible image per instance type (ami.go:94-105)
        by_image: Dict[str, List[InstanceType]] = {}
        for it in instance_types:
            for cand in candidates:  # newest-first
                if it.requirements.intersects(cand.requirements):
                    by_image.setdefault(cand.image.id, []).append(it)
                    break
        family = image_family(node_class)
        bdms = list(node_class.block_device_mappings) or list(
            family.block_device_defaults
        )
        specs: List[LaunchSpec] = []
        for image_id, types in by_image.items():
            # group again by max-pods so kubelet config is uniform per
            # template (resolver.go:118-177)
            by_max_pods: Dict[Optional[int], List[InstanceType]] = {}
            for it in types:
                mp = pool.kubelet_max_pods
                by_max_pods.setdefault(mp, []).append(it)
            for mp, group in by_max_pods.items():
                specs.append(
                    LaunchSpec(
                        image_id=image_id,
                        instance_types=group,
                        max_pods=mp,
                        # user data is per-group: max-pods rides in the
                        # boot document, so each group gets its own
                        user_data=generate_user_data(
                            node_class, pool, cluster_name,
                            cluster_endpoint, max_pods=mp,
                        ),
                        block_device_mappings=bdms,
                    )
                )
        return specs
