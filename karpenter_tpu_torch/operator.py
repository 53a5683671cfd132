"""Operator: the dependency-injection root of the port (reference pkg/operator
operator.go:83-204 + cmd/controller/main.go:33-70).

Port of ``karpenter_tpu/operator.py`` with the provisioning and disruption
loops: it builds the caches and providers in dependency order (pricing ->
subnet -> securitygroup -> version -> instanceprofile -> image -> resolver
-> launchtemplate -> instancetype -> instance, reference
operator.go:126-165), composes the CloudProvider facade behind the retry
layer and the metrics decorator, and registers the control loops in the
reference's order: nodeclass, provisioner, lifecycle, interruption (when an
interruption queue is set), disruption, termination, link, garbage
collection, tagging, metrics state and consistency.  The Provisioner's
long-lived `TorchScheduler` and the disruption controller's simulation
scheduler run on ``device`` (the card unless the caller asks for the CPU),
and so does the admission fast path (`scheduling/fastpath.py`).  Under
``enable_pipelined_reconcile`` the disruption controller's speculative
stages bracket the tick as in the reference: `reconcile_dispatch` enqueues
the next pass's round-0 population scoring on the card at the tick's end,
and `reconcile_advance` joins it at the next tick's start.

`reconcile_once` drives every controller one tick: it mints the tick's
trace ID, marks the device observatory's tick boundary, runs the
controllers with the reference's crash containment and backoff, refreshes
prices every 12 h, and exports the observatory's counters into the
registry.  Not ported here, each an item of ROADMAP §A: the SLO engine,
the anomaly detector, the flight recorder, the span dump under
``profile_dir``, the lock watchdog and leader election.
The constructor refuses the settings that would ask for one of them
(`_refuse_unported`), so none is accepted and then ignored.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import Settings
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.cloud.provider import CloudProvider, ProviderBundle
from karpenter_tpu_torch.cloud.retry import RetryingCloud
from karpenter_tpu_torch.controllers.consistency import ConsistencyController
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.garbagecollection import GarbageCollectionController
from karpenter_tpu_torch.controllers.interruption import InterruptionController
from karpenter_tpu_torch.controllers.lifecycle import LifecycleController
from karpenter_tpu_torch.controllers.link import LinkController
from karpenter_tpu_torch.controllers.metrics_state import MetricsStateController
from karpenter_tpu_torch.controllers.nodeclass import NodeClassController
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.tagging import TaggingController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.metrics.decorators import MetricsCloudProvider
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.obs.context import mint_trace_id, set_tick
from karpenter_tpu_torch.obs.device import OBSERVATORY, export_device_metrics
from karpenter_tpu_torch.obs.events import EventLedger
from karpenter_tpu_torch.ops.packer import resolve_device
from karpenter_tpu_torch.pipeline import StageSpec, TickPipeline
from karpenter_tpu_torch.providers.image import ImageProvider, Resolver
from karpenter_tpu_torch.providers.instance import InstanceProvider
from karpenter_tpu_torch.providers.instanceprofile import InstanceProfileProvider
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.providers.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.providers.pricing import (
    PRICING_RETRY_PERIOD,
    PRICING_UPDATE_PERIOD,
    PricingProvider,
)
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.providers.version import VersionProvider
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.trace import TRACER

log = logging.getLogger(__name__)


class Operator:
    def __init__(
        self,
        cloud: FakeCloud,
        kube: KubeStore,
        settings: Optional[Settings] = None,
        clock: Optional[Clock] = None,
        registry: Registry = REGISTRY,
        batch_windows: Optional[dict] = None,
        device=None,
    ):
        self.cloud = cloud
        self.kube = kube
        self.settings = settings or Settings()
        self.settings.validate()
        _refuse_unported(self.settings)
        # the card unless the caller asks for the CPU; asking for CUDA
        # without a card raises here, before anything is built
        self.device = resolve_device(device)
        self.clock = clock or cloud.clock
        self.registry = registry
        self.cluster = Cluster(kube, clock=self.clock)
        # cluster event ledger (obs/events.py): typed decision records on
        # the injected clock, attached to the registry so every layer that
        # holds one emits through `registry.event(...)`
        self.ledger = EventLedger(clock=self.clock, registry=registry)
        registry.ledger = self.ledger
        # per-tick trace context (obs/context.py): reconcile_once mints
        # one trace ID per tick; spans and ledger events stamp it
        self._tick_seq = 0
        self.tracer = TRACER
        # assign unconditionally: a later operator with profiling off must
        # actually turn the process tracer off
        self.tracer.enabled = self.settings.enable_profiling
        # device observatory (obs/device.py): launch/transfer/resident
        # telemetry behind the kernel wrappers.  Process-global like the
        # tracer; the tick tail exports its deltas into this registry.
        # The enabled flag only gates COUNTING.
        OBSERVATORY.enabled = self.settings.enable_device_observatory
        self._dev_exported: Optional[dict] = None
        # resilience layer (cloud/retry.py): every provider talks to the
        # cloud through classified retries + per-API circuit breakers
        self.retrying = RetryingCloud(
            cloud, clock=self.clock, settings=self.settings, registry=registry
        )
        # connectivity preflight (reference operator.go:190-200's dry-run
        # DescribeInstanceTypes), through the retry layer
        try:
            shapes = self.retrying.describe_instance_types()
        except Exception as exc:
            raise RuntimeError(
                f"cloud connectivity preflight failed: {exc}"
            ) from exc
        if not shapes:
            raise RuntimeError(
                "cloud connectivity preflight: instance-type catalog is "
                "empty — nothing could ever be provisioned"
            )

        # ---- caches + providers, dependency order (operator.go:126-165)
        rcloud = self.retrying
        self.unavailable = UnavailableOfferings(self.clock)
        self.pricing = PricingProvider(rcloud, registry=registry)
        self.pricing.update_on_demand()
        self.pricing.update_spot()
        self.subnets = SubnetProvider(rcloud, self.clock, registry=registry)
        self.security_groups = SecurityGroupProvider(
            rcloud, self.clock, registry=registry
        )
        self.version = VersionProvider(rcloud, self.clock, registry=registry)
        self.instance_profiles = InstanceProfileProvider(
            rcloud, self.clock, self.settings.cluster_name
        )
        self.images = ImageProvider(rcloud, self.clock, registry=registry)
        self.resolver = Resolver(self.images)
        self.launch_templates = LaunchTemplateProvider(
            rcloud,
            self.resolver,
            self.security_groups,
            self.clock,
            cluster_name=self.settings.cluster_name,
            cluster_endpoint=self.settings.cluster_endpoint,
        )
        self.instance_types = InstanceTypeProvider(
            rcloud, self.pricing, self.subnets, self.unavailable,
            self.settings, self.clock, registry=registry,
        )
        self.instances = InstanceProvider(
            rcloud, self.subnets, self.launch_templates, self.unavailable,
            tags=self.settings.tags, batch_windows=batch_windows,
            registry=registry,
        )
        # duration/error decoration mirrors reference main.go:46
        self.cloud_provider = MetricsCloudProvider(
            CloudProvider(
                rcloud,
                kube,
                ProviderBundle(
                    instance_types=self.instance_types,
                    instances=self.instances,
                    images=self.images,
                    subnets=self.subnets,
                    security_groups=self.security_groups,
                ),
            ),
            registry=registry,
        )

        # ---- controllers
        self.provisioner = Provisioner(
            kube, self.cluster, self.cloud_provider, self.clock,
            self.settings, registry, device=self.device,
        )
        self.termination = TerminationController(
            kube, self.cloud_provider, self.clock, registry
        )
        self.lifecycle = LifecycleController(
            kube, self.cloud_provider, self.clock, registry
        )
        self.garbage_collection = GarbageCollectionController(
            kube, self.cloud_provider, self.clock, registry
        )
        self.tagging = TaggingController(kube, rcloud)
        self.link = LinkController(kube, self.cloud_provider, registry)
        self.node_class_controller = NodeClassController(
            kube, self.subnets, self.security_groups, self.images,
            self.instance_profiles,
        )
        self.disruption = DisruptionController(
            kube, self.cluster, self.cloud_provider, self.termination,
            self.clock, feature_gate_drift=self.settings.feature_gate_drift,
            registry=registry,
            search_rounds=self.settings.consolidation_search_rounds,
            population_size=self.settings.consolidation_population_size,
            device=self.device,
        )
        self.interruption: Optional[InterruptionController] = None
        if self.settings.interruption_queue_name:
            self.interruption = InterruptionController(
                kube, rcloud, self.termination, self.unavailable, registry
            )
        self.metrics_state = MetricsStateController(
            kube, self.cluster, self.clock, registry
        )
        self.consistency = ConsistencyController(
            kube, self.cluster, self.cloud_provider, self.clock, registry
        )
        self._pricing_updated_at = self.clock.now()
        # per-controller requeue backoff: name -> (retry_at, current delay)
        self._ctrl_backoff: Dict[str, Tuple[float, float]] = {}
        # pipelined reconcile schedule (pipeline.py): the canonical mutate
        # order below is unchanged either way; pipelining brackets it with
        # disruption's speculative stages — dispatch (tick end: enqueue the
        # next consolidation search's round-0 scoring on the device) and
        # advance (tick start: join round 0, chain round 1 under the
        # provisioning solve)
        sequence: List[Tuple[str, object]] = [
            ("nodeclass", self.node_class_controller),
            ("provisioner", self.provisioner),
            ("lifecycle", self.lifecycle),
        ]
        if self.interruption is not None:
            sequence.append(("interruption", self.interruption))
        sequence += [
            ("disruption", self.disruption),
            ("termination", self.termination),
            # adopt before GC lists, so no race to reap
            ("link", self.link),
            ("garbagecollection", self.garbage_collection),
            ("tagging", self.tagging),
            ("metrics_state", self.metrics_state),
            ("consistency", self.consistency),
        ]
        specs = [
            StageSpec(
                name,
                controller,
                dispatch=(
                    self.disruption.reconcile_dispatch
                    if name == "disruption" else None
                ),
                advance=(
                    self.disruption.reconcile_advance
                    if name == "disruption" else None
                ),
            )
            for name, controller in sequence
        ]
        self.pipeline = TickPipeline(
            specs, registry=registry, tracer=self.tracer,
            enabled=self.settings.enable_pipelined_reconcile,
        )

    # ------------------------------------------------------------------ loop
    def _reconcile(self, name: str, controller) -> None:
        """One controller tick with reconcile metrics.

        Crash-contained: a raising controller is caught here — error
        metric, log, health gauge, and a per-controller exponential requeue
        backoff — while the rest of the tick's sequence proceeds.  A
        controller still inside its backoff window is skipped entirely."""
        now = self.clock.now()
        entry = self._ctrl_backoff.get(name)
        if entry is not None and now < entry[0]:
            return  # requeued; not yet due
        labels = {"controller": name}
        self.registry.inc("karpenter_controller_reconcile_total", labels)
        try:
            with self.tracer.span(f"controller.{name}"), self.registry.time(
                "karpenter_controller_reconcile_time_seconds", labels
            ):
                controller.reconcile()
        except Exception:
            self.registry.inc(
                "karpenter_controller_reconcile_errors_total", labels
            )
            delay = (
                min(entry[1] * 2, self.settings.controller_backoff_max)
                if entry is not None
                else self.settings.controller_backoff_base
            )
            self._ctrl_backoff[name] = (now + delay, delay)
            self.registry.set("karpenter_tpu_controller_healthy", 0.0, labels)
            log.exception(
                "controller %s reconcile failed; requeued in %.1fs", name, delay
            )
            return
        if entry is not None:
            del self._ctrl_backoff[name]
        self.registry.set("karpenter_tpu_controller_healthy", 1.0, labels)

    def reconcile_once(self) -> None:
        """One tick of every control loop, in a stable order: status
        resolution, provisioning, lifecycle, events, disruption, cleanup."""
        # mint this tick's trace ID: every controller span, solver phase,
        # retry attempt and ledger event below correlates on it
        self._tick_seq += 1
        set_tick(mint_trace_id(self._tick_seq, ""))
        # tick boundary for the device observatory: new launch signatures
        # from here on count warm for any function launched in an earlier
        # tick, and the tick sections delta against this point
        OBSERVATORY.begin_tick(self._tick_seq)
        t0 = time.perf_counter()
        try:
            self._run_controllers()
        finally:
            self._observe_tick(time.perf_counter() - t0)

    def _run_controllers(self) -> None:
        # re-arm the shared cloud-API retry budget for this tick
        self.retrying.begin_tick()

        # a controller inside its crash-requeue backoff window is skipped
        def ready(name: str) -> bool:
            entry = self._ctrl_backoff.get(name)
            return entry is None or self.clock.now() >= entry[0]

        if not self.pipeline.run(self._reconcile, lambda: True, ready):
            return
        # 12h pricing refresh (reference pricing/controller.go:39-41).  The
        # provider degrades to last-good prices on API failure, and the
        # except below keeps even an unexpected error from killing the
        # tick.  A refresh that did NOT land is re-attempted after
        # PRICING_RETRY_PERIOD, not another 12h.
        if self.clock.now() - self._pricing_updated_at >= PRICING_UPDATE_PERIOD:
            ok = True
            try:
                if not self.settings.isolated_vpc:
                    ok = self.pricing.update_on_demand()
                    ok = self.pricing.update_spot() and ok
            except Exception:
                ok = False
                log.exception("pricing refresh failed; keeping last prices")
            now = self.clock.now()
            self._pricing_updated_at = (
                now if ok else now - PRICING_UPDATE_PERIOD + PRICING_RETRY_PERIOD
            )

    def _observe_tick(self, dur_s: float) -> None:
        """The tick tail: observe the tick's wall duration and export the
        device observatory's counter deltas into the registry (the
        ``karpenter_device_*`` families)."""
        self.registry.observe(
            "karpenter_reconcile_tick_duration_seconds", dur_s
        )
        self._dev_exported, _warm = export_device_metrics(
            self.registry, OBSERVATORY, self._dev_exported
        )


def _refuse_unported(settings: Settings) -> None:
    """Raise for a setting whose path the port does not run yet, naming the
    ROADMAP item that brings it: accepting it and then ignoring it would
    hide the gap."""
    refused = []
    if settings.enable_profiling and settings.profile_dir:
        refused.append(
            "profile_dir (the span dump and device trace under "
            "enable_profiling: ROADMAP A8)"
        )
    if settings.flight_dir:
        refused.append("flight_dir (the flight recorder: ROADMAP A3c)")
    if settings.lock_watchdog_stall_s > 0:
        refused.append("lock_watchdog_stall_s (the lock watchdog: ROADMAP A3e)")
    if refused:
        raise ValueError(
            "not ported yet, so the port's operator refuses: " + "; ".join(refused)
        )


def solver_counters(scheduler) -> Tuple[int, int, int]:
    """A scheduler's monotonic (compile-cache hits, misses, resident hits)."""
    return (
        scheduler.compile_cache_hits,
        scheduler.compile_cache_misses,
        scheduler.resident_hits,
    )


def solve_kind(before: Tuple[int, int, int], after: Tuple[int, int, int]) -> str:
    """The kind of the one solve between two `solver_counters` readings:
    "hit" (a compile-cache hit), "delta" (a miss the resident tensors
    absorbed), "cold" (a full compile), or "" (no solve)."""
    hits, misses, resident = (a - b for a, b in zip(after, before))
    if hits:
        return "hit"
    if misses:
        return "delta" if resident else "cold"
    return ""
