"""Error taxonomy (reference pkg/errors/errors.go + karpenter-core's
cloudprovider error wrappers, cloudprovider.go:101, instance.go:121)."""

from __future__ import annotations

from karpenter_tpu_torch.cloud.fake.backend import (
    CloudAPIError,
    InsufficientCapacityError,
    LaunchTemplateNotFoundError,
)


class NodeClaimNotFoundError(Exception):
    """The machine backing a NodeClaim no longer exists in the cloud."""

    def __init__(self, provider_id: str):
        super().__init__(f"nodeclaim not found: {provider_id}")
        self.provider_id = provider_id


class NoImageResolvedError(Exception):
    """Image resolution produced no launchable template for the node
    class — bad selector terms or every candidate deprecated (the
    reference's amifamily resolver fails the launch with "no amis exist
    given constraints", resolver.go:118-127)."""

    def __init__(self, node_class: str):
        super().__init__(f"no image resolved for node class {node_class!r}")
        self.node_class = node_class


class InsufficientCapacityAggregateError(Exception):
    """Every launch candidate was capacity-constrained (the core treats
    this as retryable-later; the ICE cache keeps the failed pools masked,
    reference cloudprovider.go:101)."""

    def __init__(self, pools):
        super().__init__(f"insufficient capacity in all {len(pools)} pools")
        self.pools = list(pools)


def is_not_found(err: Exception) -> bool:
    return isinstance(err, NodeClaimNotFoundError) or (
        isinstance(err, CloudAPIError)
        and err.code in ("InvalidInstanceID.NotFound", "NotFound")
    )


def is_insufficient_capacity(err: Exception) -> bool:
    return isinstance(
        err, (InsufficientCapacityError, InsufficientCapacityAggregateError)
    )
