"""Fake cloud backend: the in-memory analogue of the reference's fake AWS
(pkg/fake/ec2api.go:40-196 plus fake SSM/IAM/Pricing/SQS).

One object simulates the whole cloud surface the providers consume:
machine-shape catalog, zonal offerings, subnets/security-groups/images,
fleet launches with per-pool capacity and injectable insufficient-capacity
errors (`InsufficientCapacityPools`, reference ec2api.go:40-44), an instance
store so describe reflects prior launches (ec2api.go:112-196), spot/on-demand
pricing, an interruption message queue (fake SQS), and instance profiles
(fake IAM).  Every API records its calls and supports one-shot error
injection (`NextError`, ec2api.go:66-67).

Port copy of ``karpenter_tpu/cloud/fake/backend.py``; the machine-shape
catalog (`MachineShape`, `generate_catalog`) lives in ``catalog.py``.
"""

from __future__ import annotations

import itertools
import math
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import BlockDeviceMapping
from karpenter_tpu_torch.cloud.fake.catalog import (  # noqa: F401  (re-exported)
    MachineShape,
    generate_catalog,
)
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock, make_rlock


class CloudAPIError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


class InsufficientCapacityError(CloudAPIError):
    def __init__(self, pool: Tuple[str, str, str]):
        super().__init__(
            "InsufficientInstanceCapacity",
            f"no capacity in pool {pool}",
        )
        self.pool = pool  # (instance_type, zone, capacity_type)


class LaunchTemplateNotFoundError(CloudAPIError):
    """CreateFleet referenced a launch template that no longer exists —
    the stale-template race the reference retries once
    (pkg/providers/instance/instance.go:94-98)."""

    def __init__(self, name: str):
        super().__init__("InvalidLaunchTemplateName.NotFound", name)
        self.name = name


@dataclass
class FakeLaunchTemplate:
    """Cloud-side launch template (reference pkg/fake stores LTs so
    hydration at launchtemplate.go:323-339 has something to read)."""

    name: str
    image_id: str = ""
    security_group_ids: List[str] = field(default_factory=list)
    user_data: str = ""
    block_device_mappings: List[BlockDeviceMapping] = field(default_factory=list)
    tags: Dict[str, str] = field(default_factory=dict)
    created_at: float = 0.0


@dataclass
class FakeSubnet:
    id: str
    zone: str
    available_ips: int = 4096
    tags: Dict[str, str] = field(default_factory=dict)
    name: str = ""
    public: bool = False


@dataclass
class FakeSecurityGroup:
    id: str
    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class FakeImage:
    id: str
    family: str = "standard"
    arch: str = "amd64"
    created_at: float = 0.0
    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    deprecated: bool = False


@dataclass
class FakeInstance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    subnet_id: str = ""
    image_id: str = ""
    security_group_ids: List[str] = field(default_factory=list)
    tags: Dict[str, str] = field(default_factory=dict)
    state: str = "running"  # pending|running|shutting-down|stopping|stopped|terminated
    launch_time: float = 0.0
    launch_template: str = ""


@dataclass
class QueueMessage:
    id: str
    body: dict
    receipt: str = ""
    enqueued_at: float = 0.0  # queue-side timestamp (SQS SentTimestamp)
    # in-flight window: a received message is hidden from other consumers
    # until this deadline; an undeleted (failed) message reappears after
    # it — the SQS visibility-timeout contract the interruption
    # controller's redelivery path relies on
    invisible_until: float = 0.0


class ChaosEngine:
    """Seeded, scriptable fault schedules for the fake cloud — the analogue
    of an AWS region having a bad day, sustained rather than one-shot.

    Every trigger fires inside `_CallRecorder.record`, i.e. at API entry and
    BEFORE the backend mutates anything, so a chaos-failed call never
    half-applies.  Latency rides the injected `Clock` (`clock.sleep`), so a
    `FakeClock` suite experiences it as time passing, not wall waiting.
    Schedules compose: latency applies first, then blackouts, then throttle
    bursts, then per-API error rates.  `"*"` targets every API.
    """

    def __init__(self, clock: Clock, seed: int = 0):
        self.clock = clock
        self.rng = random.Random(seed)
        self.enabled = True
        # api (or "*") -> (probability, error code)
        self.error_rates: Dict[str, Tuple[float, str]] = {}
        # api (or "*") -> injected seconds per call
        self.latency: Dict[str, float] = {}
        # (start, end, apis-or-None, code): every matching call raises
        self.blackouts: List[Tuple[float, float, Optional[frozenset], str]] = []
        # (start, end, apis-or-None): RequestLimitExceeded burst windows
        self.throttles: List[Tuple[float, float, Optional[frozenset]]] = []
        # probability each requested CreateFleet instance is withheld
        self.partial_fleet_rate = 0.0

    # ----------------------------------------------------------- scripting
    def reseed(self, seed: int) -> None:
        self.rng = random.Random(seed)

    def set_error_rate(self, api: str, rate: float, code: str = "InternalError"):
        self.error_rates[api] = (rate, code)

    def set_latency(self, api: str, seconds: float) -> None:
        self.latency[api] = seconds

    def add_blackout(
        self,
        start: float,
        duration: float,
        apis: Optional[Iterable[str]] = None,
        code: str = "ServiceUnavailable",
    ) -> None:
        self.blackouts.append(
            (start, start + duration, None if apis is None else frozenset(apis), code)
        )

    def add_throttle_burst(
        self, start: float, duration: float, apis: Optional[Iterable[str]] = None
    ) -> None:
        self.throttles.append(
            (start, start + duration, None if apis is None else frozenset(apis))
        )

    def set_partial_fleet(self, rate: float) -> None:
        self.partial_fleet_rate = rate

    def clear(self) -> None:
        """Drop every schedule (the faults 'clearing'); keeps the RNG
        stream so a seeded run stays reproducible across the clear."""
        self.error_rates = {}
        self.latency = {}
        self.blackouts = []
        self.throttles = []
        self.partial_fleet_rate = 0.0

    # ------------------------------------------------------------- firing
    def on_call(self, api: str) -> None:
        if not self.enabled:
            return
        lat = self.latency.get(api, self.latency.get("*"))
        if lat:
            self.clock.sleep(lat)
        now = self.clock.now()
        for start, end, apis, code in self.blackouts:
            if start <= now < end and (apis is None or api in apis):
                raise CloudAPIError(code, f"chaos blackout: {api}")
        for start, end, apis in self.throttles:
            if start <= now < end and (apis is None or api in apis):
                raise CloudAPIError(
                    "RequestLimitExceeded", f"chaos throttle: {api}"
                )
        rate = self.error_rates.get(api, self.error_rates.get("*"))
        if rate is not None and self.rng.random() < rate[0]:
            raise CloudAPIError(rate[1], f"chaos error: {api}")

    def fleet_shortfall(self, count: int) -> int:
        """How many of `count` requested CreateFleet instances chaos
        withholds (partial fulfillment, reported as per-pool errors)."""
        if not self.enabled or not self.partial_fleet_rate:
            return 0
        return sum(
            1 for _ in range(count) if self.rng.random() < self.partial_fleet_rate
        )


class _CallRecorder:
    """MockedFunction-style call capture (reference pkg/fake/utils.go).

    Error injection is layered: explicit sequences (`set_error_sequence`,
    with `set_next_error` as its one-shot wrapper), call-count triggers
    (`set_error_at_call`), then the sustained chaos schedule.  Thread-safe:
    the batcher and the interruption worker pool drive APIs from threads.
    """

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = {}
        self._error_seq: Dict[str, List[Exception]] = {}
        self._error_at: Dict[str, Dict[int, Exception]] = {}
        self._lock = make_lock("_CallRecorder._lock")
        self.chaos: Optional[ChaosEngine] = None  # wired by FakeCloud
        # observers called with (api, args) at every API entry, BEFORE any
        # injected error fires — the cluster simulator's trace recorder
        # (sim/trace.py) rides this to capture the full call stream
        self.taps: List = []

    def record(self, api: str, *args) -> None:
        with self._lock:
            self.calls.setdefault(api, []).append(args)
            n = len(self.calls[api])
            err: Optional[Exception] = None
            seq = self._error_seq.get(api)
            if seq:
                err = seq.pop(0)
                if not seq:
                    del self._error_seq[api]
            if err is None:
                err = self._error_at.get(api, {}).pop(n, None)
        for tap in self.taps:
            tap(api, args)
        if err is not None:
            raise err
        if self.chaos is not None:
            self.chaos.on_call(api)

    def set_next_error(self, api: str, err: Exception) -> None:
        """One-shot injection — thin wrapper over `set_error_sequence`."""
        self.set_error_sequence(api, [err])

    def set_error_sequence(self, api: str, errs: Sequence[Exception]) -> None:
        """Fail the next len(errs) calls of `api` in order (appended to any
        errors already pending)."""
        with self._lock:
            self._error_seq.setdefault(api, []).extend(errs)

    def set_error_at_call(self, api: str, nth: int, err: Exception) -> None:
        """Fail the nth FUTURE call of `api` (1 = the very next call);
        calls in between succeed."""
        with self._lock:
            trigger = len(self.calls.get(api, ())) + nth
            self._error_at.setdefault(api, {})[trigger] = err

    def count(self, api: str) -> int:
        with self._lock:
            return len(self.calls.get(api, ()))


class FakeCloud:
    """The programmable cloud.  Thread-safe where the batcher needs it."""

    def __init__(
        self,
        clock: Clock,
        shapes: Sequence[MachineShape] = (),
        zones: Sequence[str] = ("zone-a", "zone-b", "zone-c"),
        region: str = "region-1",
        spot_discount: float = 0.3,
    ):
        self.clock = clock
        self.region = region
        self.zones = list(zones)
        self.shapes: Dict[str, MachineShape] = {s.name: s for s in shapes}
        self.spot_discount = spot_discount
        # offering availability: (type, zone) present = offered there.
        # default: every type offered in every zone.
        self.offerings: Dict[Tuple[str, str], bool] = {}
        # spot price overrides per (type, zone); default od_price * discount
        self.spot_prices: Dict[Tuple[str, str], float] = {}
        # capacity pools: (type, zone, capacity_type) -> remaining launchable
        # count; missing key = unlimited (reference fakes default to success)
        self.capacity_pools: Dict[Tuple[str, str, str], int] = {}
        # ICE injection (reference InsufficientCapacityPools ec2api.go:40-44)
        self.insufficient_pools: set[Tuple[str, str, str]] = set()
        self.subnets: Dict[str, FakeSubnet] = {}
        self.security_groups: Dict[str, FakeSecurityGroup] = {}
        self.images: Dict[str, FakeImage] = {}
        self.instances: Dict[str, FakeInstance] = {}
        self.launch_templates: Dict[str, FakeLaunchTemplate] = {}
        self.instance_profiles: Dict[str, str] = {}  # name -> role
        self.queue: List[QueueMessage] = []
        self.kube_version = "1.28"
        self.recorder = _CallRecorder()
        self.chaos = ChaosEngine(clock)
        self.recorder.chaos = self.chaos
        self._seq = itertools.count(1)
        self._lock = make_rlock("FakeCloud._lock")

    # ------------------------------------------------------------------ setup
    def with_default_topology(self) -> "FakeCloud":
        """One private subnet + one SG per zone, one image per arch/family."""
        for i, z in enumerate(self.zones):
            self.add_subnet(FakeSubnet(id=f"subnet-{i}", zone=z, name=f"private-{z}"))
        self.add_security_group(FakeSecurityGroup(id="sg-default", name="default"))
        now = self.clock.now()
        for fam in ("standard", "accelerated"):
            for arch in ("amd64", "arm64"):
                self.add_image(
                    FakeImage(
                        id=f"image-{fam}-{arch}",
                        family=fam,
                        arch=arch,
                        created_at=now,
                        name=f"{fam}-{arch}",
                    )
                )
        return self

    def add_subnet(self, s: FakeSubnet) -> None:
        with self._lock:
            s.tags.setdefault("Name", s.name or s.id)
            self.subnets[s.id] = s

    def add_security_group(self, g: FakeSecurityGroup) -> None:
        with self._lock:
            g.tags.setdefault("Name", g.name or g.id)
            self.security_groups[g.id] = g

    def add_image(self, im: FakeImage) -> None:
        with self._lock:
            self.images[im.id] = im

    def set_capacity(self, instance_type: str, zone: str, capacity_type: str, n: int):
        with self._lock:
            self.capacity_pools[(instance_type, zone, capacity_type)] = n

    def mark_insufficient(self, instance_type: str, zone: str, capacity_type: str):
        with self._lock:
            self.insufficient_pools.add((instance_type, zone, capacity_type))

    def mark_zone_insufficient(self, zone: str) -> None:
        """AZ capacity loss: every (type, capacity_type) pool in the zone
        starts returning InsufficientInstanceCapacity — the sim's
        az-blackout building block (cloud APIs keep answering; only the
        zone's capacity is gone, like a real AZ event)."""
        with self._lock:
            for t in self.shapes:
                for ct in (L.CAPACITY_TYPE_ON_DEMAND, L.CAPACITY_TYPE_SPOT):
                    self.insufficient_pools.add((t, zone, ct))

    def clear_zone_insufficient(self, zone: str) -> None:
        """The AZ heals: drop every insufficient-pool mark in the zone."""
        with self._lock:
            self.insufficient_pools = {
                p for p in self.insufficient_pools if p[1] != zone
            }

    # -------------------------------------------------------------- catalog
    def describe_instance_types(self) -> List[MachineShape]:
        with self._lock:
            self.recorder.record("DescribeInstanceTypes")
            return list(self.shapes.values())

    def describe_instance_type_offerings(self) -> List[Tuple[str, str]]:
        """(instance_type, zone) pairs currently offered."""
        with self._lock:
            self.recorder.record("DescribeInstanceTypeOfferings")
            if self.offerings:
                return [k for k, v in self.offerings.items() if v]
            return [(t, z) for t in self.shapes for z in self.zones]

    # -------------------------------------------------------------- network
    def describe_subnets(self, selector_terms) -> List[FakeSubnet]:
        with self._lock:
            self.recorder.record("DescribeSubnets", tuple(selector_terms))
            return [
                s
                for s in self.subnets.values()
                if any(t.matches(s.id, s.name, s.tags) for t in selector_terms)
            ]

    def describe_security_groups(self, selector_terms) -> List[FakeSecurityGroup]:
        with self._lock:
            self.recorder.record("DescribeSecurityGroups", tuple(selector_terms))
            return [
                g
                for g in self.security_groups.values()
                if any(t.matches(g.id, g.name, g.tags) for t in selector_terms)
            ]

    def describe_images(self, selector_terms) -> List[FakeImage]:
        with self._lock:
            self.recorder.record("DescribeImages", tuple(selector_terms))
            return [
                im
                for im in self.images.values()
                if any(t.matches(im.id, im.name, im.tags) for t in selector_terms)
            ]

    def latest_image(self, family: str, arch: str) -> Optional[FakeImage]:
        """SSM-parameter analogue: newest non-deprecated image of a family
        (reference pkg/providers/amifamily/ami.go:65-79)."""
        with self._lock:
            self.recorder.record("GetParameter", family, arch)
            cands = [
                im
                for im in self.images.values()
                if im.family == family and im.arch == arch and not im.deprecated
            ]
            return max(cands, key=lambda im: im.created_at, default=None)

    # -------------------------------------------------------------- cluster
    def describe_cluster_version(self) -> str:
        """Control-plane version discovery (the DescribeCluster analogue the
        version provider polls)."""
        with self._lock:
            self.recorder.record("DescribeCluster")
            return self.kube_version

    # -------------------------------------------------------------- pricing
    def on_demand_price(self, instance_type: str) -> float:
        return self.shapes[instance_type].od_price

    def spot_price(self, instance_type: str, zone: str) -> float:
        key = (instance_type, zone)
        if key in self.spot_prices:
            return self.spot_prices[key]
        return self.shapes[instance_type].od_price * self.spot_discount

    def describe_spot_price_history(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            self.recorder.record("DescribeSpotPriceHistory")
            return {
                (t, z): self.spot_price(t, z) for t in self.shapes for z in self.zones
            }

    def get_products(self) -> Dict[str, float]:
        with self._lock:
            self.recorder.record("GetProducts")
            return {t: s.od_price for t, s in self.shapes.items()}

    # ----------------------------------------------------- launch templates
    def create_launch_template(self, lt: FakeLaunchTemplate) -> FakeLaunchTemplate:
        with self._lock:
            self.recorder.record("CreateLaunchTemplate", lt.name)
            if not lt.created_at:
                lt.created_at = self.clock.now()
            self.launch_templates[lt.name] = lt
            return lt

    def describe_launch_templates(
        self, tag_filters: Optional[Mapping[str, str]] = None
    ) -> List[FakeLaunchTemplate]:
        with self._lock:
            self.recorder.record(
                "DescribeLaunchTemplates", tuple((tag_filters or {}).items())
            )
            out = []
            for lt in self.launch_templates.values():
                if tag_filters and not all(
                    lt.tags.get(k) == v or (v == "*" and k in lt.tags)
                    for k, v in tag_filters.items()
                ):
                    continue
                out.append(lt)
            return out

    def delete_launch_template(self, name: str) -> None:
        with self._lock:
            self.recorder.record("DeleteLaunchTemplate", name)
            self.launch_templates.pop(name, None)

    # -------------------------------------------------------------- tagging
    def create_tags(self, resource_id: str, tags: Mapping[str, str]) -> None:
        """Per-resource tag stamping (the reference's CreateTags; used for
        claim-specific tags that must NOT ride the shared fleet request)."""
        with self._lock:
            self.recorder.record("CreateTags", resource_id, tuple(sorted(tags.items())))
            inst = self.instances.get(resource_id)
            if inst is not None:
                inst.tags.update(tags)

    # -------------------------------------------------------------- fleet
    def create_fleet(
        self,
        overrides: Sequence[Mapping],
        capacity_type: str,
        count: int = 1,
        launch_template: str = "",
        image_id: str = "",
        security_group_ids: Sequence[str] = (),
        tags: Optional[Mapping[str, str]] = None,
    ) -> Tuple[List[FakeInstance], List[InsufficientCapacityError]]:
        """Launch `count` instances, trying overrides cheapest-first.

        Overrides are (instance_type, zone, subnet_id[, price]) candidates —
        the analogue of CreateFleet's LaunchTemplateOverrides cross-product
        (reference pkg/providers/instance/instance.go:324-363).  Pools marked
        insufficient or exhausted yield per-pool errors, which the caller
        feeds back into the unavailable-offerings cache (instance.go:365-371).
        """
        with self._lock:
            self.recorder.record("CreateFleet", len(overrides), capacity_type, count)
            if launch_template and launch_template not in self.launch_templates:
                raise LaunchTemplateNotFoundError(launch_template)
            errors: Dict[Tuple[str, str, str], InsufficientCapacityError] = {}
            launched: List[FakeInstance] = []
            ordered = sorted(
                overrides,
                key=lambda o: o.get(
                    "price",
                    self.spot_price(o["instance_type"], o["zone"])
                    if capacity_type == L.CAPACITY_TYPE_SPOT
                    else self.on_demand_price(o["instance_type"]),
                ),
            )
            # chaos partial fulfillment: withheld instances surface as a
            # capacity error on the pool that would have served them — the
            # shape a real CreateFleet takes when a pool runs dry MID
            # request (earlier instances landed there, the rest ICE'd).
            # Attributed to the first pool not already known-unavailable so
            # the error carries new information for the caller's ICE cache.
            shortfall = self.chaos.fleet_shortfall(count)
            if shortfall and ordered:
                for o in ordered:
                    pool = (o["instance_type"], o["zone"], capacity_type)
                    if pool in self.insufficient_pools:
                        continue
                    remaining = self.capacity_pools.get(pool)
                    if remaining is not None and remaining <= 0:
                        continue
                    errors[pool] = InsufficientCapacityError(pool)
                    break
            for _ in range(count - shortfall):
                placed = False
                for o in ordered:
                    pool = (o["instance_type"], o["zone"], capacity_type)
                    if pool in self.insufficient_pools:
                        errors[pool] = InsufficientCapacityError(pool)
                        continue
                    remaining = self.capacity_pools.get(pool)
                    if remaining is not None and remaining <= 0:
                        errors[pool] = InsufficientCapacityError(pool)
                        continue
                    subnet = self.subnets.get(o.get("subnet_id", ""))
                    if subnet is not None and subnet.available_ips <= 0:
                        continue
                    if remaining is not None:
                        self.capacity_pools[pool] = remaining - 1
                    if subnet is not None:
                        subnet.available_ips -= 1
                    inst = FakeInstance(
                        id=f"i-{next(self._seq):08d}",
                        instance_type=o["instance_type"],
                        zone=o["zone"],
                        subnet_id=o.get("subnet_id", ""),
                        capacity_type=capacity_type,
                        image_id=image_id,
                        security_group_ids=list(security_group_ids),
                        tags=dict(tags or {}),
                        state="running",
                        launch_time=self.clock.now(),
                        launch_template=launch_template,
                    )
                    self.instances[inst.id] = inst
                    launched.append(inst)
                    placed = True
                    break
                if not placed:
                    break
            return launched, list(errors.values())

    def describe_instances(
        self, ids: Optional[Iterable[str]] = None, tag_filters: Optional[Mapping] = None
    ) -> List[FakeInstance]:
        with self._lock:
            self.recorder.record(
                "DescribeInstances", tuple(ids or ()), tuple((tag_filters or {}).items())
            )
            out = []
            for inst in self.instances.values():
                if ids is not None and inst.id not in set(ids):
                    continue
                if tag_filters and not all(
                    inst.tags.get(k) == v or (v == "*" and k in inst.tags)
                    for k, v in tag_filters.items()
                ):
                    continue
                out.append(inst)
            return out

    def terminate_instances(self, ids: Iterable[str]) -> List[str]:
        with self._lock:
            ids = list(ids)
            self.recorder.record("TerminateInstances", tuple(ids))
            done = []
            for i in ids:
                inst = self.instances.get(i)
                if inst is not None and inst.state != "terminated":
                    inst.state = "terminated"
                    subnet = self.subnets.get(inst.subnet_id)
                    if subnet is not None:
                        subnet.available_ips += 1
                    done.append(i)
            return done

    # -------------------------------------------------------------- IAM
    def ensure_instance_profile(self, name: str, role: str) -> str:
        with self._lock:
            self.recorder.record("CreateInstanceProfile", name, role)
            self.instance_profiles[name] = role
            return name

    def delete_instance_profile(self, name: str) -> None:
        with self._lock:
            self.recorder.record("DeleteInstanceProfile", name)
            self.instance_profiles.pop(name, None)

    # -------------------------------------------------------------- queue
    def send_message(self, body: dict) -> None:
        with self._lock:
            self.queue.append(
                QueueMessage(
                    id=f"m-{next(self._seq)}",
                    body=body,
                    enqueued_at=self.clock.now(),
                )
            )

    # SQS default VisibilityTimeout (seconds); tests may lower it
    visibility_timeout = 30.0

    def receive_messages(self, max_messages: int = 10) -> List[QueueMessage]:
        with self._lock:
            self.recorder.record("ReceiveMessage", max_messages)
            now = self.clock.now()
            batch = [
                m for m in self.queue if m.invisible_until <= now
            ][:max_messages]
            for m in batch:
                m.receipt = f"r-{m.id}"
                m.invisible_until = now + self.visibility_timeout
            return batch

    def delete_message(self, message: QueueMessage) -> None:
        with self._lock:
            self.recorder.record("DeleteMessage", message.id)
            self.queue = [m for m in self.queue if m.id != message.id]
