"""Retry, backoff and circuit breaking for every remote dependency.

The port's copy of ``platform_aware_scheduling_tpu/kube/retry.py``.  The
service depends on two remote APIs, the kube API server and the
custom-metrics API; this module wraps the clients of both:

  * :class:`RetryPolicy`: per-verb deadlines and capped exponential
    backoff with deterministic jitter (an LCG over (seed, verb, attempt),
    so a schedule is reproducible), honouring a server-sent
    ``Retry-After`` on 429/503;
  * :class:`CircuitBreaker`: one per endpoint group (``kube`` and
    ``metrics``): closed, open after N consecutive transport failures,
    one half-open probe after the reset timeout, closed again when the
    probe succeeds.  While open, calls fail fast with
    :class:`CircuitOpenError`;
  * :class:`FaultTolerantClient`: idempotent reads retry under the
    policy; non-idempotent writes (bind, evict, patch, update) get one
    breaker-gated attempt and are never retried blind.  Lease
    create/update retry like reads: each attempt carries the observed
    resourceVersion, so a retry of a committed write answers 409.
    Watches pass through untouched; the informer owns relist and backoff.

Metric families: ``pas_kube_retry_total{verb,reason}``,
``pas_kube_giveup_total{verb}``, ``pas_circuit_state{group}`` (0 closed,
1 half-open, 2 open) and ``pas_circuit_transitions_total{group,to}``.
Everything takes an injectable ``clock`` and ``sleep``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from platform_aware_scheduling_tpu_torch.kube.client import (
    ConflictError,
    KubeError,
    NotFoundError,
)
from platform_aware_scheduling_tpu_torch.tas.metrics import MetricsError
from platform_aware_scheduling_tpu_torch.utils import klog, trace
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

# circuit states, also the pas_circuit_state gauge encoding
STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half-open"
STATE_OPEN = "open"
_STATE_GAUGE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}

#: endpoint groups: the kube API server and the custom-metrics API fail
#: independently (a dead metrics adapter must not open the kube circuit)
GROUP_KUBE = "kube"
GROUP_METRICS = "metrics"

#: idempotent read verbs: safe to retry any number of times
READ_VERBS = frozenset(
    {
        "list_nodes",
        "get_node",
        "list_pods",
        "get_pod",
        "list_taspolicies",
        "get_taspolicy",
        "get_node_custom_metric",
        "get_node_metric",
        "get_lease",
        "get_configmap",
    }
)

#: writes made idempotent by fencing: a retried attempt whose first try
#: committed answers a deterministic 409, so these retry like reads
FENCED_WRITE_VERBS = frozenset({"create_lease", "update_lease"})

#: non-idempotent writes: at most ONE attempt here.  Conflict retry
#: (re-read and re-apply on 409) belongs to callers that can re-read state
WRITE_VERBS = frozenset(
    {
        "patch_node",
        "update_pod",
        "bind_pod",
        "evict_pod",
        "create_taspolicy",
        "update_taspolicy",
        "delete_taspolicy",
        "create_configmap",
        "update_configmap",
    }
)

#: verb -> endpoint group (default kube)
_VERB_GROUP = {
    "get_node_custom_metric": GROUP_METRICS,
    "get_node_metric": GROUP_METRICS,
}


def verb_group(verb: str) -> str:
    return _VERB_GROUP.get(verb, GROUP_KUBE)


class CircuitOpenError(KubeError):
    """Fail-fast refusal while a circuit is open; carries the group."""

    def __init__(self, group: str):
        super().__init__(f"circuit open for {group} API group", status=0)
        self.group = group


def retry_reason(exc: BaseException) -> Optional[str]:
    """The bounded retry-reason label when ``exc`` is retryable, else
    None.  A server-answered client error (404, 409, other 4xx) is not
    retryable: retrying cannot change a deterministic answer."""
    if isinstance(exc, CircuitOpenError):
        return None  # the breaker already refused
    if isinstance(exc, (NotFoundError, ConflictError)):
        return None
    status = getattr(exc, "status", None)
    if isinstance(status, int) and status:
        if status == 429:
            return "throttled"
        if status >= 500:
            return "server_error"
        return None
    if isinstance(exc, KubeError):
        return "network"  # status 0: a transport-level failure
    if isinstance(exc, (TimeoutError, OSError)):
        return "network"
    # the metrics client wraps transport trouble into a MetricsError with
    # a __cause__; a cause-less one ("no metrics returned") is the server
    # answering that the data does not exist, neither retryable nor a
    # circuit failure
    if isinstance(exc, MetricsError):
        cause = exc.__cause__
        return retry_reason(cause) if cause is not None else None
    return "api_error"


def circuit_failure(exc: BaseException) -> bool:
    """Whether ``exc`` counts against the breaker: transport-level and
    5xx/429 failures do; a 404/409/4xx means the server is up."""
    return retry_reason(exc) is not None


def stable_hash(text: str) -> int:
    """FNV-1a over the UTF-8 bytes: a string hash that does not change
    between processes (``hash()`` is salted per process)."""
    h = 2166136261
    for byte in text.encode("utf-8"):
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def _deterministic_jitter(seed: int, n: int) -> float:
    """A reproducible jitter factor in [0.5, 1.0): one LCG step over a
    mixed (seed, n)."""
    x = (seed * 2654435761 + n * 40503 + 12345) & 0x7FFFFFFF
    x = (1103515245 * x + 12345) & 0x7FFFFFFF
    return 0.5 + (x / float(0x80000000)) * 0.5


def backoff_delay(attempt: int, base_delay_s: float, max_delay_s: float, seed: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter for the
    ``attempt``-th consecutive failure (1-based)."""
    n = max(1, int(attempt))
    raw = min(float(max_delay_s), float(base_delay_s) * (2.0 ** (n - 1)))
    return raw * _deterministic_jitter(seed, n)


@dataclass
class RetryPolicy:
    """How many times, how far apart and for how long in total a verb may
    be retried.  ``verb_deadlines`` overrides the shared deadline for
    specific verbs."""

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    deadline_s: float = 30.0
    seed: int = 0
    verb_deadlines: Dict[str, float] = field(default_factory=dict)

    def deadline_for(self, verb: str) -> float:
        return self.verb_deadlines.get(verb, self.deadline_s)

    def backoff(self, attempt: int, verb: str = "", retry_after_s: Optional[float] = None) -> float:
        """Delay before the next try after ``attempt`` failures; a
        server-sent ``Retry-After`` is a floor."""
        delay = backoff_delay(
            attempt, self.base_delay_s, self.max_delay_s, seed=self.seed ^ stable_hash(verb)
        )
        if retry_after_s is not None and retry_after_s > 0:
            delay = max(delay, float(retry_after_s))
        return delay


class CircuitBreaker:
    """Consecutive-failure breaker for one endpoint group.

    closed: all calls pass; N consecutive failures trip it open.
    open: calls refused (CircuitOpenError) until ``reset_timeout_s``
    elapses, then ONE half-open probe is let through.
    half-open: probe success closes the circuit; probe failure re-opens
    it and re-arms the timer.
    """

    def __init__(
        self,
        group: str,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[CounterSet] = None,
    ):
        self.group = group
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self.counters = counters if counters is not None else trace.COUNTERS
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self._publish(STATE_CLOSED, transition=False)

    def _publish(self, state: str, transition: bool = True) -> None:
        self.counters.set_gauge("pas_circuit_state", _STATE_GAUGE[state], labels={"group": self.group})
        if transition:
            self.counters.inc("pas_circuit_transitions_total", labels={"group": self.group, "to": state})

    def _set_state(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        klog.v(2).info_s(f"circuit {self.group}: -> {state}", component="retry")
        self._publish(state)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (
            self._state == STATE_OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._set_state(STATE_HALF_OPEN)
            self._probe_in_flight = False

    def allow(self) -> bool:
        """Whether a call may proceed right now; half-open admits exactly
        one in-flight probe."""
        with self._lock:
            self._maybe_half_open()
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            if self._state != STATE_CLOSED:
                self._set_state(STATE_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            if self._state == STATE_HALF_OPEN:
                # the probe failed: straight back to open, timer re-armed
                self._opened_at = self._clock()
                self._set_state(STATE_OPEN)
                return
            self._failures += 1
            if self._state == STATE_CLOSED and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._set_state(STATE_OPEN)


class CircuitBreakerRegistry:
    """The per-process breaker set, one per endpoint group, shared by
    every wrapped client."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[CounterSet] = None,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._counters = counters
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def breaker(self, group: str) -> CircuitBreaker:
        with self._lock:
            if group not in self._breakers:
                self._breakers[group] = CircuitBreaker(
                    group,
                    failure_threshold=self.failure_threshold,
                    reset_timeout_s=self.reset_timeout_s,
                    clock=self._clock,
                    counters=self._counters,
                )
            return self._breakers[group]

    def states(self) -> Dict[str, str]:
        with self._lock:
            breakers = list(self._breakers.values())
        return {b.group: b.state for b in breakers}

    def open_groups(self) -> List[str]:
        """Groups currently refusing calls (open or probing half-open)."""
        return sorted(group for group, state in self.states().items() if state != STATE_CLOSED)


class FaultTolerantClient:
    """Retry/backoff/circuit-breaking proxy over any client with the
    ``KubeClient`` (or metrics ``Client``) method surface, the test fakes
    included.  Reads retry under the policy; writes get one attempt
    behind the breaker; every other attribute (seeding helpers, watches,
    config) is the inner client's own."""

    def __init__(
        self,
        inner,
        policy: Optional[RetryPolicy] = None,
        breakers: Optional[CircuitBreakerRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        counters: Optional[CounterSet] = None,
    ):
        self._inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        self.breakers = breakers if breakers is not None else CircuitBreakerRegistry()
        self._clock = clock
        self._sleep = sleep
        self.counters = counters if counters is not None else trace.COUNTERS

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in READ_VERBS or name in FENCED_WRITE_VERBS:
            return self._wrap_read(name, attr)
        if name in WRITE_VERBS:
            return self._wrap_write(name, attr)
        return attr

    # -- reads: retry freely ---------------------------------------------------

    def _wrap_read(self, verb: str, fn):
        def call(*args, **kwargs):
            breaker = self.breakers.breaker(verb_group(verb))
            deadline = self._clock() + self.policy.deadline_for(verb)
            attempt = 0
            last_exc: Optional[BaseException] = None
            while attempt < self.policy.max_attempts:
                attempt += 1
                if not breaker.allow():
                    raise CircuitOpenError(breaker.group)
                try:
                    result = fn(*args, **kwargs)
                except Exception as exc:
                    reason = retry_reason(exc)
                    if reason is None:
                        # a deterministic answer: the server is up
                        breaker.record_success()
                        raise
                    breaker.record_failure()
                    last_exc = exc
                    if attempt >= self.policy.max_attempts:
                        break
                    delay = self.policy.backoff(
                        attempt, verb=verb, retry_after_s=getattr(exc, "retry_after", None)
                    )
                    if self._clock() + delay > deadline:
                        break  # the deadline would expire mid-sleep
                    self.counters.inc("pas_kube_retry_total", labels={"verb": verb, "reason": reason})
                    klog.v(4).info_s(
                        f"{verb} failed ({reason}), retry {attempt}/{self.policy.max_attempts} "
                        f"in {delay:.3f}s: {exc}",
                        component="retry",
                    )
                    self._sleep(delay)
                    continue
                breaker.record_success()
                return result
            self.counters.inc("pas_kube_giveup_total", labels={"verb": verb})
            if last_exc is None:
                raise RuntimeError(f"{verb}: no attempt was made")
            raise last_exc

        call.__name__ = verb
        return call

    # -- writes: one attempt, breaker-gated ------------------------------------

    def _wrap_write(self, verb: str, fn):
        def call(*args, **kwargs):
            breaker = self.breakers.breaker(verb_group(verb))
            if not breaker.allow():
                raise CircuitOpenError(breaker.group)
            try:
                result = fn(*args, **kwargs)
            except Exception as exc:
                if circuit_failure(exc):
                    breaker.record_failure()
                else:
                    breaker.record_success()
                raise
            breaker.record_success()
            return result

        call.__name__ = verb
        return call
