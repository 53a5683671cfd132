"""Interruption controller (reference pkg/controllers/interruption).

Polls the cloud event queue (the SQS analogue fed by the platform's event
bus, designs/interruption-handling.md) and reacts to four message kinds via
a parser registry (reference messages/*, controller.go:82-139):

- spot interruption   -> mark the offering unavailable in the ICE cache
                         (controller.go:228-235) + cordon-and-drain
- rebalance recommendation -> cordon-and-drain (proactive)
- scheduled change (health event) -> cordon-and-drain
- state change (stopping/terminated) -> cordon-and-drain

Draining happens by marking the NodeClaim for deletion; the termination
controller does the graceful cordon/evict/terminate (controller.go:247-259).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.api import NodeClaim
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, QueueMessage
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.pipeline import run_concurrently
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.kube import KubeStore

log = logging.getLogger(__name__)

KIND_SPOT_INTERRUPTION = "spot_interruption"
KIND_REBALANCE = "rebalance_recommendation"
KIND_SCHEDULED_CHANGE = "scheduled_change"
KIND_STATE_CHANGE = "state_change"


@dataclass
class ParsedMessage:
    kind: str
    instance_id: str
    detail: str = ""


def _parse(body: dict) -> Optional[ParsedMessage]:
    """Parser registry analogue (reference messages/parser.go): tolerant of
    unknown kinds — they are dropped with a metric, not an error."""
    kind = body.get("kind")
    instance_id = body.get("instance_id", "")
    if kind in (
        KIND_SPOT_INTERRUPTION,
        KIND_REBALANCE,
        KIND_SCHEDULED_CHANGE,
    ):
        return ParsedMessage(kind, instance_id, body.get("detail", ""))
    if kind == KIND_STATE_CHANGE:
        state = body.get("state", "")
        if state in ("stopping", "stopped", "shutting-down", "terminated"):
            return ParsedMessage(kind, instance_id, state)
        return None
    return None


class InterruptionController:
    def __init__(
        self,
        kube: KubeStore,
        cloud: FakeCloud,
        termination: TerminationController,
        unavailable: UnavailableOfferings,
        registry: Registry = REGISTRY,
    ):
        self.kube = kube
        self.cloud = cloud
        self.termination = termination
        self.unavailable = unavailable
        self.registry = registry
        # per-instance override: the simulator sets 1 so message handling
        # (and the DeleteMessage/TerminateInstances calls it makes) happens
        # in queue order — reproducible traces need a reproducible call
        # stream, which a thread pool cannot give
        self.workers = self.WORKERS

    # worker fan-out per batch (reference controller.go:108-118 runs the
    # 10-message batch through a 10-way errgroup)
    WORKERS = 10

    def reconcile(self) -> None:
        messages = self.cloud.receive_messages(max_messages=10)
        if not messages:
            return
        claims_by_instance: Dict[str, NodeClaim] = {
            c.provider_id: c
            for c in self.kube.node_claims.values()
            if c.provider_id
        }
        now = self.cloud.clock.now()

        def process(msg: QueueMessage) -> None:
            """One message end-to-end, errors ISOLATED: a failed message is
            left on the queue (visibility timeout redelivers it) while the
            rest of the batch completes (controller.go:120-133)."""
            if msg.enqueued_at:
                # end-to-end reaction latency (reference
                # interruption/metrics.go message latency histogram)
                self.registry.observe(
                    "karpenter_interruption_message_latency_time_seconds",
                    max(now - msg.enqueued_at, 0.0),
                )
            try:
                self._handle(msg, claims_by_instance)
                self.cloud.delete_message(msg)
            except Exception as exc:
                log.warning("interruption message %s failed: %s", msg.id, exc)
                self.registry.inc("karpenter_interruption_message_errors")
                return  # NOT deleted -> redelivered next poll
            self.registry.inc("karpenter_interruption_deleted_messages")

        # the sanctioned fan-out seam (pipeline.run_concurrently):
        # workers=1 drains deterministically in order (sim mode), and
        # process() swallows per-message errors (handle AND delete), so
        # the batch always drains either way
        run_concurrently(
            [(lambda m=msg: process(m)) for msg in messages],
            max_workers=self.workers,
        )

    def _handle(self, msg: QueueMessage, claims: Dict[str, NodeClaim]) -> None:
        parsed = _parse(msg.body)
        if parsed is None:
            self.registry.inc(
                "karpenter_interruption_message_parse_failed",
            )
            return
        self.registry.inc(
            "karpenter_interruption_received_messages",
            {"message_type": parsed.kind},
        )
        claim = claims.get(parsed.instance_id)
        if claim is None:
            return  # not ours (or already gone)
        if parsed.kind == KIND_SPOT_INTERRUPTION:
            # remember the reclaimed pool so the next solves avoid it
            # (reference controller.go:228-235)
            if claim.instance_type_name and claim.zone:
                self.unavailable.mark_unavailable(
                    L.CAPACITY_TYPE_SPOT,
                    claim.instance_type_name,
                    claim.zone,
                    reason="spot-interrupted",
                )
        self.kube.record_event(
            "NodeClaim", "Interruption", claim.name, parsed.kind
        )
        self.registry.inc(
            "karpenter_interruption_actions_performed",
            {"action": "CordonAndDrain", "message_type": parsed.kind},
        )
        self.registry.event(
            "NodeDisrupted", node=claim.name,
            reason=f"interruption/{parsed.kind}",
        )
        self.termination.mark_for_deletion(claim, reason=parsed.kind)
