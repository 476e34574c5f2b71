"""Deterministic fault injection for the control plane.

The port's copy of ``platform_aware_scheduling_tpu/testing/faults.py``.
Every fault is scripted: per-verb schedules of errors, latencies and
flaps, consumed call by call, with any randomness drawn from a seeded LCG
over the call index, never the wall clock.  The same plan against the
same code gives the same failure sequence on every run.

  * :class:`FakeClock`: a hand-advanced monotonic clock whose ``sleep``
    advances it, so retry backoff, circuit reset timers, telemetry
    freshness and lease deadlines run with no real sleeping;
  * :class:`FaultPlan`: the script: ``fail(verb, n)``, ``outage(verb)`` /
    ``clear(verb)``, ``flap``, ``error_rate`` (seeded), ``latency``
    (advances the fault clock) and ``truncate``; per-verb call counts are
    recorded;
  * :class:`FaultyClient`: wraps any client so every public method
    consults the plan under its own name before delegating;
  * :class:`FakeMetricsClient`: a per-metric store speaking the
    ``tas.metrics.Client`` protocol with the same plan hook.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from platform_aware_scheduling_tpu_torch.kube.client import KubeError
from platform_aware_scheduling_tpu_torch.kube.retry import stable_hash
from platform_aware_scheduling_tpu_torch.tas.metrics import MetricsError, NodeMetric, NodeMetricsInfo
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity


class FakeClock:
    """Hand-advanced monotonic clock; ``sleep`` advances instead of
    blocking, so a whole backoff schedule runs in microseconds."""

    def __init__(self, start: float = 1_000.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    __call__ = now

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._t += float(seconds)

    def sleep(self, seconds: float) -> None:
        """A drop-in for ``time.sleep`` in retry wrappers."""
        self.advance(seconds)


class Fault:
    """One scripted outcome for one call: raise, delay, and/or truncate.

    ``truncate`` is for payload-shaped verbs: the call succeeds but the
    consumer keeps only the first N items of the payload.  Raising faults
    ignore it."""

    __slots__ = ("exc_factory", "latency_s", "truncate")

    def __init__(
        self,
        exc_factory: Optional[Callable[[], BaseException]] = None,
        latency_s: float = 0.0,
        truncate: Optional[int] = None,
    ):
        self.exc_factory = exc_factory
        self.latency_s = float(latency_s)
        self.truncate = None if truncate is None else max(0, int(truncate))

    def apply(self, clock: Optional[FakeClock]) -> None:
        if self.latency_s and clock is not None:
            clock.advance(self.latency_s)
        if self.exc_factory is not None:
            raise self.exc_factory()


def _default_error(status: int = 503) -> Callable[[], BaseException]:
    return lambda: KubeError(f"injected fault: HTTP {status}", status=status)


class FaultPlan:
    """Scripted per-verb fault schedules, consumed one call at a time.

    Resolution order per call: an ``outage`` (persistent until cleared)
    wins; else the next scripted entry for the verb (or the ``"*"``
    wildcard) is consumed; else the seeded error rate fires or not, from
    the verb's call index.  Exhausted scripts mean healthy."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._scripts: Dict[str, List[Optional[Fault]]] = {}
        self._outages: Dict[str, Fault] = {}
        self._rates: Dict[str, tuple] = {}  # verb -> (rate, factory)
        #: verb -> calls observed, faulted or not
        self.calls: Dict[str, int] = {}

    # -- authoring -------------------------------------------------------------

    def script(self, verb: str, faults: List[Optional[Fault]]) -> "FaultPlan":
        """Append an explicit outcome sequence (None = a healthy call)."""
        with self._lock:
            self._scripts.setdefault(verb, []).extend(faults)
        return self

    def fail(
        self,
        verb: str,
        count: int,
        status: int = 503,
        exc_factory: Optional[Callable[[], BaseException]] = None,
    ) -> "FaultPlan":
        """The next ``count`` calls of ``verb`` fail."""
        factory = exc_factory or _default_error(status)
        return self.script(verb, [Fault(factory)] * count)

    def latency(self, verb: str, count: int, seconds: float) -> "FaultPlan":
        """The next ``count`` calls advance the fault clock by ``seconds``
        before answering (a slow API, not a dead one)."""
        return self.script(verb, [Fault(latency_s=seconds) for _ in range(count)])

    def truncate(self, verb: str, count: int, keep: int) -> "FaultPlan":
        """The next ``count`` calls of ``verb`` answer with only the first
        ``keep`` payload items."""
        return self.script(verb, [Fault(truncate=keep) for _ in range(count)])

    def flap(self, verb: str, ok: int, fail: int, cycles: int, status: int = 503) -> "FaultPlan":
        """``cycles`` repetitions of ``ok`` healthy calls then ``fail``
        failing ones."""
        factory = _default_error(status)
        seq: List[Optional[Fault]] = []
        for _ in range(cycles):
            seq.extend([None] * ok)
            seq.extend([Fault(factory)] * fail)
        return self.script(verb, seq)

    def outage(
        self,
        verb: str,
        status: int = 503,
        exc_factory: Optional[Callable[[], BaseException]] = None,
    ) -> "FaultPlan":
        """Hard down: every call of ``verb`` fails until :meth:`clear`."""
        with self._lock:
            self._outages[verb] = Fault(exc_factory or _default_error(status))
        return self

    def error_rate(
        self,
        verb: str,
        rate: float,
        status: int = 500,
        exc_factory: Optional[Callable[[], BaseException]] = None,
    ) -> "FaultPlan":
        """A deterministic pseudo-random error rate: whether call #n fails
        is a pure function of (seed, verb, n)."""
        with self._lock:
            self._rates[verb] = (float(rate), exc_factory or _default_error(status))
        return self

    def clear(self, verb: Optional[str] = None) -> "FaultPlan":
        """End the outage, rate and remaining script of ``verb`` (or of
        every verb)."""
        with self._lock:
            if verb is None:
                self._outages.clear()
                self._rates.clear()
                self._scripts.clear()
            else:
                self._outages.pop(verb, None)
                self._rates.pop(verb, None)
                self._scripts.pop(verb, None)
        return self

    # -- consumption -----------------------------------------------------------

    def _rate_fires(self, verb: str, rate: float, n: int) -> bool:
        x = ((self.seed * 2654435761) ^ (stable_hash(verb) * 97) ^ (n * 40503)) & 0x7FFFFFFF
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        return (x / float(0x80000000)) < rate

    def next(self, verb: str) -> Optional[Fault]:
        """The fault (or None) for this call of ``verb``; records the call
        either way."""
        with self._lock:
            n = self.calls.get(verb, 0)
            self.calls[verb] = n + 1
            if verb in self._outages:
                return self._outages[verb]
            for key in (verb, "*"):
                script = self._scripts.get(key)
                if script:
                    return script.pop(0)
            rate = self._rates.get(verb)
        if rate is not None and self._rate_fires(verb, rate[0], n):
            return Fault(rate[1])
        return None

    def call_count(self, verb: str) -> int:
        with self._lock:
            return self.calls.get(verb, 0)

    def apply(self, verb: str, clock: Optional[FakeClock] = None) -> None:
        """Consume and apply this call's scripted outcome (raises when the
        script says so)."""
        fault = self.next(verb)
        if fault is not None:
            fault.apply(clock)


class FaultyClient:
    """Wrap any client (kube or metrics, real or fake): every public
    method consults the plan under its own name before delegating."""

    def __init__(self, inner: Any, plan: FaultPlan, clock: Optional[FakeClock] = None):
        self._inner = inner
        self.plan = plan
        self.clock = clock

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr):
            return attr

        def call(*args, **kwargs):
            self.plan.apply(name, self.clock)
            return attr(*args, **kwargs)

        call.__name__ = name
        return call


#: one shared NodeMetric per integer value, so publishing a large surface
#: does not parse a Quantity string per node (readers never mutate one);
#: bounded so a pathological value stream cannot grow it without limit
_INT_METRIC_MEMO: Dict[int, NodeMetric] = {}
_INT_METRIC_MEMO_MAX = 1 << 16


def int_node_metric(value: int) -> NodeMetric:
    value = int(value)
    metric = _INT_METRIC_MEMO.get(value)
    if metric is None:
        metric = NodeMetric(value=Quantity(str(value)))
        if len(_INT_METRIC_MEMO) < _INT_METRIC_MEMO_MAX:
            _INT_METRIC_MEMO[value] = metric
    return metric


class FakeMetricsClient:
    """In-memory custom-metrics API double speaking the
    ``tas.metrics.Client`` protocol, with the FaultPlan hook (verb
    ``get_node_metric``)."""

    def __init__(
        self,
        store: Optional[Dict[str, NodeMetricsInfo]] = None,
        plan: Optional[FaultPlan] = None,
        clock: Optional[FakeClock] = None,
    ):
        self.store: Dict[str, NodeMetricsInfo] = store if store is not None else {}
        self.fault_plan = plan
        self.fault_clock = clock
        self._lock = threading.Lock()

    def set(self, metric: str, node: str, value) -> None:
        with self._lock:
            self.store.setdefault(metric, {})[node] = NodeMetric(value=Quantity(str(value)))

    def set_all(self, metric: str, values: Dict[str, Any]) -> None:
        with self._lock:
            self.store[metric] = {node: NodeMetric(value=Quantity(str(v))) for node, v in values.items()}

    def set_all_metrics(self, metric: str, values: Dict[str, NodeMetric]) -> None:
        """``set_all`` with prebuilt (typically shared, see
        :func:`int_node_metric`) NodeMetric objects: one dict copy."""
        with self._lock:
            self.store[metric] = dict(values)

    def get_node_metric(self, metric_name: str) -> NodeMetricsInfo:
        if self.fault_plan is not None:
            self.fault_plan.apply("get_node_metric", self.fault_clock)
        with self._lock:
            info = self.store.get(metric_name)
            if not info:
                raise MetricsError(f"no metric {metric_name} found")
            return dict(info)
