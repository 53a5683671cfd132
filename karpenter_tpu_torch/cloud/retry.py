"""Retrying cloud client: the resilience layer between providers and the
backend (the role the AWS SDK's adaptive retryer plays under the reference's
providers — karpenter gets throttle/transient retries for free; this
reproduction has to build them).

`RetryingCloud` decorates a `FakeCloud` (or anything API-compatible) and

- **classifies** every `CloudAPIError` by code: *throttle*
  (RequestLimitExceeded & friends) and *transient* (InternalError,
  ServiceUnavailable, ...) are retried; everything else is *terminal* and
  passes through untouched — notably `InsufficientInstanceCapacity`, which
  must reach the ICE cache unretried, and
  `InvalidLaunchTemplateName.NotFound`, which the instance provider handles
  with its own single recreate-and-retry;
- **retries** with exponential backoff + full jitter paced on the injected
  `Clock` (a `FakeClock` suite experiences backoff as time passing), capped
  per call by `cloud_max_retries` and per reconcile tick by a shared retry
  budget (`cloud_retry_budget_per_tick`, re-armed by
  `Operator.reconcile_once` via `begin_tick()`) so a storm cannot stall a
  tick indefinitely;
- **breaks the circuit** per API after `cloud_circuit_failure_threshold`
  consecutive throttle/transient failures: while open, calls fail fast with
  `CircuitOpenError` (code `CircuitOpen`) without touching the backend;
  after `cloud_circuit_reset_timeout` the breaker half-opens and the next
  call probes — success closes it, failure re-opens.  Terminal errors are
  business outcomes, not API-health signals, and never trip the breaker.

Providers with caches catch `CloudAPIError` (which `CircuitOpenError` is)
and degrade to serve-last-good (providers/stale.py), so an open circuit
means stale-but-working data, not a dead controller.

Observability: `karpenter_cloud_api_retries_total{api,classification}` and
`karpenter_cloud_api_circuit_state{api}` (0 closed / 1 half-open / 2 open).
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict

from karpenter_tpu_torch.cloud.fake.backend import CloudAPIError
from karpenter_tpu_torch.utils.locks import make_lock

log = logging.getLogger(__name__)

# error-code classification (the AWS SDK's retryable-code tables)
THROTTLE = "throttle"
TRANSIENT = "transient"
TERMINAL = "terminal"

THROTTLE_CODES = frozenset(
    {
        "RequestLimitExceeded",
        "Throttling",
        "ThrottlingException",
        "Throttled",
        "TooManyRequestsException",
        "RequestThrottled",
        "SlowDown",
    }
)
TRANSIENT_CODES = frozenset(
    {
        "InternalError",
        "InternalFailure",
        "ServiceUnavailable",
        "Unavailable",
        "RequestTimeout",
        "RequestTimeoutException",
    }
)

# every backend method the retry layer mediates; all other attributes pass
# through untouched (clock, recorder, chaos, the raw state dicts tests poke)
RETRYABLE_APIS = frozenset(
    {
        "describe_instance_types",
        "describe_instance_type_offerings",
        "describe_subnets",
        "describe_security_groups",
        "describe_images",
        "latest_image",
        "describe_cluster_version",
        "describe_spot_price_history",
        "get_products",
        "create_launch_template",
        "describe_launch_templates",
        "delete_launch_template",
        "create_tags",
        "create_fleet",
        "describe_instances",
        "terminate_instances",
        "ensure_instance_profile",
        "delete_instance_profile",
        "receive_messages",
        "delete_message",
    }
)

# circuit states, exported as the gauge value
CLOSED, HALF_OPEN, OPEN = 0.0, 1.0, 2.0


def classify(err: Exception) -> str:
    if isinstance(err, CircuitOpenError):
        return TERMINAL  # never retry into an open breaker
    if isinstance(err, CloudAPIError):
        if err.code in THROTTLE_CODES:
            return THROTTLE
        if err.code in TRANSIENT_CODES:
            return TRANSIENT
    return TERMINAL


class CircuitOpenError(CloudAPIError):
    """Fail-fast result while an API's breaker is open."""

    def __init__(self, api: str, retry_at: float):
        super().__init__("CircuitOpen", f"circuit open for {api}")
        self.api = api
        self.retry_at = retry_at


class _Circuit:
    __slots__ = ("state", "failures", "opened_at")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0


class RetryingCloud:
    """Transparent decorator: API methods gain retry/circuit behavior,
    everything else (clock, recorder, state dicts) proxies to the inner
    backend."""

    def __init__(self, inner, clock=None, settings=None, registry=None, seed: int = 0):
        if settings is None:
            from karpenter_tpu_torch.api import Settings

            settings = Settings()
        if registry is None:
            from karpenter_tpu_torch.metrics.registry import REGISTRY as registry
        self._inner = inner
        self._clock = clock if clock is not None else inner.clock
        self._registry = registry
        self.max_retries = settings.cloud_max_retries
        self.budget_per_tick = settings.cloud_retry_budget_per_tick
        self.backoff_base = settings.cloud_backoff_base
        self.backoff_max = settings.cloud_backoff_max
        self.failure_threshold = settings.cloud_circuit_failure_threshold
        self.reset_timeout = settings.cloud_circuit_reset_timeout
        self._rng = random.Random(seed)
        self._lock = make_lock("RetryingCloud._lock")
        self._budget = self.budget_per_tick
        self._circuits: Dict[str, _Circuit] = {}

    # ------------------------------------------------------------- proxying
    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in RETRYABLE_APIS and callable(attr):
            wrapped = self._wrap(name, attr)
            self.__dict__[name] = wrapped  # build each wrapper once
            return wrapped
        return attr

    # --------------------------------------------------------------- budget
    def begin_tick(self) -> None:
        """Re-arm the shared per-tick retry budget (called by the operator
        at the top of every reconcile tick)."""
        with self._lock:
            self._budget = self.budget_per_tick

    def _take_budget(self) -> bool:
        with self._lock:
            if self._budget <= 0:
                return False
            self._budget -= 1
            return True

    # -------------------------------------------------------------- circuit
    def circuit_state(self, api: str) -> float:
        with self._lock:
            c = self._circuits.get(api)
            return c.state if c is not None else CLOSED

    def _set_state(self, c: _Circuit, api: str, state: float) -> None:
        # callers hold self._lock
        c.state = state
        self._registry.set(
            "karpenter_cloud_api_circuit_state", state, {"api": api}
        )

    def _gate(self, api: str) -> None:
        """Raise CircuitOpenError while the breaker is open; flip to
        half-open once the reset timer elapses so one probe goes through."""
        now = self._clock.now()
        with self._lock:
            c = self._circuits.setdefault(api, _Circuit())
            if c.state == OPEN:
                retry_at = c.opened_at + self.reset_timeout
                if now < retry_at:
                    raise CircuitOpenError(api, retry_at)
                self._set_state(c, api, HALF_OPEN)

    def _record_failure(self, api: str) -> None:
        now = self._clock.now()
        with self._lock:
            c = self._circuits.setdefault(api, _Circuit())
            c.failures += 1
            if c.state == HALF_OPEN or c.failures >= self.failure_threshold:
                if c.state != OPEN:
                    log.warning("circuit for %s opened after %d consecutive "
                                "failures", api, c.failures)
                    self._registry.event(
                        "CircuitOpen", api=api, failures=c.failures
                    )
                c.opened_at = now
                self._set_state(c, api, OPEN)

    def _record_success(self, api: str) -> None:
        with self._lock:
            c = self._circuits.get(api)
            if c is None:
                return
            if c.failures or c.state != CLOSED:
                c.failures = 0
                self._set_state(c, api, CLOSED)

    # ---------------------------------------------------------------- retry
    def _wrap(self, api: str, fn):
        def call(*args, **kwargs):
            attempt = 0
            while True:
                self._gate(api)
                try:
                    result = fn(*args, **kwargs)
                except Exception as exc:
                    cls = classify(exc)
                    if cls == TERMINAL:
                        # a business outcome (ICE, NotFound, validation):
                        # pass through untouched, breaker unaffected
                        raise
                    self._record_failure(api)
                    if attempt >= self.max_retries or not self._take_budget():
                        raise
                    self._registry.inc(
                        "karpenter_cloud_api_retries_total",
                        {"api": api, "classification": cls},
                    )
                    cap = min(self.backoff_max, self.backoff_base * (2 ** attempt))
                    with self._lock:
                        sleep = self._rng.uniform(0, cap)  # full jitter
                    # ledgered with the tick's trace ID: a CreateFleet
                    # retry shows up on the same timeline as the solve
                    # and nomination it delayed (seeded jitter, so the
                    # sim records this deterministically)
                    self._registry.event(
                        "RetryBackoff", api=api, classification=cls,
                        attempt=attempt + 1, backoff_s=f"{sleep:.6f}",
                    )
                    self._clock.sleep(sleep)
                    attempt += 1
                    continue
                self._record_success(api)
                return result

        call.__name__ = api
        return call
