"""TAS state cache: policies + refcounted, self-updating metrics.

The port's counterpart of ``platform_aware_scheduling_tpu/tas/cache.py``:
a mutex-guarded store with the write-nil-preserves rule, two keyspaces
``policies/<ns>/<name>`` and ``metrics/<metric>``, a refcount map so a
metric shared by several policies is evicted only when the last one goes,
and ``update_all_metrics`` re-fetching every registered metric each sync
period.  Mutation hooks let the tensor mirror (``ops/state.py``) follow
changes without polling.

Freshness bookkeeping (when each metric last carried data, when the last
refresh pass ended, the refresh period) feeds the ``/readyz``
``telemetry_fresh`` condition and the ``pas_telemetry_metric_age_seconds``
gauges.  With ``configure_history`` (the forecaster's), each
data-bearing write also appends one ``(stamp, {node: milli})`` sample to
its metric's bounded ring, and the ``on_refresh_pass`` hooks run once at
the end of every refresh pass, where the forecaster refits.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.kube.retry import CircuitOpenError
from platform_aware_scheduling_tpu_torch.tas.metrics import Client, NodeMetricsInfo
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.utils import klog
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

POLICY_PATH = "policies/{}/{}"
METRIC_PATH = "metrics/{}"


class CacheMissError(KeyError):
    pass


def _refresh_error_reason(exc: BaseException) -> str:
    """Bounded ``reason`` label for refresh errors: circuit_open /
    throttled / server_error / network / no_data / fetch_error — never a
    raw message.  Walks the ``__cause__`` chain first, since clients wrap
    the failure that carries the status."""
    seen = 0
    while exc.__cause__ is not None and seen < 8:
        exc = exc.__cause__
        seen += 1
    if isinstance(exc, CircuitOpenError):
        return "circuit_open"
    status = getattr(exc, "status", None)
    if isinstance(status, int) and status:
        if status == 429:
            return "throttled"
        if status >= 500:
            return "server_error"
        return "fetch_error"
    if isinstance(exc, (TimeoutError, OSError)):
        return "network"
    if "no metric" in str(exc) or "no metrics returned" in str(exc):
        return "no_data"
    return "fetch_error"


class _SerializedStore:
    """Serialized KV with the write-nil-preserves rule."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def add(self, key: str, payload: Any) -> None:
        with self._lock:
            if payload is None and key in self._data:
                return  # nil write preserves the existing value
            self._data[key] = payload

    def read(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class AutoUpdatingCache:
    """Reader/Writer/SelfUpdating cache."""

    def __init__(
        self,
        counters: Optional[CounterSet] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._store = _SerializedStore()
        self._metric_refcounts: Dict[str, int] = {}
        self._mtx = threading.Lock()
        self.counters = counters if counters is not None else CounterSet()
        # freshness bookkeeping, on an injectable monotonic clock
        self._clock = clock
        self._last_refresh: Dict[str, float] = {}  # metric -> stamp
        self._last_pass: Optional[float] = None
        self._refresh_period: Optional[float] = None
        self._synced_once = threading.Event()
        #: freshness bound override (seconds); None = 3x the refresh period
        self.freshness_max_age_s: Optional[float] = None
        # held across store mutation + hook delivery so mirror subscribers
        # observe mutations in store order
        self._mutation_lock = threading.RLock()
        self.on_metric_write: List[Callable[[str, Optional[NodeMetricsInfo]], None]] = []
        self.on_metric_delete: List[Callable[[str], None]] = []
        self.on_policy_write: List[Callable[[str, str, TASPolicy], None]] = []
        self.on_policy_delete: List[Callable[[str, str], None]] = []
        # run once at the END of each update_all_metrics pass, after every
        # metric write of the pass landed: the forecaster refits here, once
        # a pass instead of once a metric
        self.on_refresh_pass: List[Callable[[], None]] = []
        # refresh history: a bounded ring of the last W data-bearing writes
        # per metric, (stamp, {node: milli}).  A failed refresh appends
        # nothing, so gaps show in the stamps; delete_metric drops the ring
        # with its metric.  Off (window 0) until configure_history
        self._history_window = 0
        self._history: Dict[str, deque] = {}
        self._history_generation = 0

    # -- Reader ---------------------------------------------------------------

    def read_metric(self, metric_name: str) -> NodeMetricsInfo:
        value = self._store.read(METRIC_PATH.format(metric_name))
        if isinstance(value, dict) and value:
            return value
        raise CacheMissError(f"no metric {metric_name} found")

    def read_policy(self, namespace: str, policy_name: str) -> TASPolicy:
        value = self._store.read(POLICY_PATH.format(namespace, policy_name))
        if isinstance(value, TASPolicy):
            return value
        raise CacheMissError(f"no policy {policy_name} found")

    # -- Writer ---------------------------------------------------------------

    def write_policy(self, namespace: str, policy_name: str, policy: TASPolicy) -> None:
        with self._mutation_lock:
            self._store.add(POLICY_PATH.format(namespace, policy_name), policy)
            for hook in self.on_policy_write:
                hook(namespace, policy_name, policy)

    def write_metric(
        self, metric_name: str, data: Optional[NodeMetricsInfo] = None
    ) -> None:
        """Empty/None data registers the metric (incrementing its refcount)
        without clobbering current values."""
        payload = data if data else None
        with self._mutation_lock:
            self._store.add(METRIC_PATH.format(metric_name), payload)
            if payload is None:
                with self._mtx:
                    self._metric_refcounts[metric_name] = (
                        self._metric_refcounts.get(metric_name, 0) + 1
                    )
            else:
                # a data-bearing write IS a refresh: the clock this metric's
                # freshness is judged by
                stamp = self._clock()
                # the history sample (a milli conversion per node) is built
                # OUTSIDE the lock, so readers of metric_ages() and
                # history_snapshot() do not wait on it; the bare read of the
                # window races only configure_history, and the locked
                # re-check decides
                sample = None
                if self._history_window:
                    sample = {
                        node: metric.value.milli_value_exact()[0] for node, metric in payload.items()
                    }
                with self._mtx:
                    self._last_refresh[metric_name] = stamp
                    if self._history_window and sample is not None:
                        ring = self._history.get(metric_name)
                        if ring is None:
                            ring = deque(maxlen=self._history_window)
                            self._history[metric_name] = ring
                        ring.append((stamp, sample))
                        self._history_generation += 1
            for hook in self.on_metric_write:
                hook(metric_name, payload)

    def delete_policy(self, namespace: str, policy_name: str) -> None:
        klog.v(2).info_s(
            "deleting " + POLICY_PATH.format(namespace, policy_name),
            component="controller",
        )
        with self._mutation_lock:
            self._store.delete(POLICY_PATH.format(namespace, policy_name))
            for hook in self.on_policy_delete:
                hook(namespace, policy_name)

    def delete_metric(self, metric_name: str) -> None:
        """Refcounted delete: evicted only when the last registered policy
        using it is removed."""
        with self._mutation_lock:
            evicted = False
            with self._mtx:
                total = self._metric_refcounts.get(metric_name)
                if total == 1:
                    del self._metric_refcounts[metric_name]
                    self._store.delete(METRIC_PATH.format(metric_name))
                    self._last_refresh.pop(metric_name, None)
                    # the ring dies with its metric: a later registration
                    # must not forecast from a ghost series
                    if self._history.pop(metric_name, None) is not None:
                        self._history_generation += 1
                    evicted = True
                elif total is not None:
                    self._metric_refcounts[metric_name] = total - 1
                else:
                    self._metric_refcounts[metric_name] = -1
            if evicted:
                # the age gauge must not stay frozen for a metric that is gone
                self.counters.remove(
                    "pas_telemetry_metric_age_seconds",
                    labels={"metric": metric_name},
                    kind="gauge",
                )
                for hook in self.on_metric_delete:
                    hook(metric_name)

    # -- SelfUpdating -----------------------------------------------------------

    def registered_metric_names(self) -> List[str]:
        with self._mtx:
            return [name for name in self._metric_refcounts if name]

    def update_all_metrics(self, client: Client) -> None:
        """One refresh pass: re-fetch every registered metric.  A failed
        fetch keeps the last-known-good value and is counted by reason."""
        with self._mtx:
            names = list(self._metric_refcounts)
        errors: Dict[str, int] = {}
        for name in names:
            if not name:
                with self._mtx:
                    self._metric_refcounts.pop(name, None)
                continue
            try:
                self.write_metric(name, client.get_node_metric(name))
            except Exception as exc:  # noqa: BLE001 — any fetch failure keeps the old value
                reason = _refresh_error_reason(exc)
                errors[reason] = errors.get(reason, 0) + 1
                klog.v(2).info_s(str(exc), component="controller")
        # a failed fetch keeps the last-known-good value while the metric
        # keeps AGING (its stamp is untouched), so staleness stays visible
        now = self._clock()
        with self._mtx:
            self._last_pass = now
            ages = {
                name: now - stamp
                for name, stamp in self._last_refresh.items()
                if name in self._metric_refcounts
            }
        self._synced_once.set()
        self.counters.inc("pas_telemetry_refresh_total")
        for reason, count in errors.items():
            self.counters.inc(
                "pas_telemetry_refresh_errors_total", count, labels={"reason": reason}
            )
        for name, age in ages.items():
            self.counters.set_gauge(
                "pas_telemetry_metric_age_seconds", round(age, 6), labels={"metric": name}
            )
        # one end-of-pass notification, never one a metric: the forecaster
        # refits over the pass's complete sample set, in this thread
        for hook in list(self.on_refresh_pass):
            try:
                hook()
            except Exception as exc:  # noqa: BLE001 — a subscriber must not stop refreshes
                klog.error("refresh-pass subscriber failed: %r", exc)

    # -- refresh history --------------------------------------------------------

    def configure_history(self, window: int) -> None:
        """Enable (or re-bound) the per-metric refresh-history rings: each
        data-bearing write appends one ``(stamp, {node: milli})`` sample,
        bounded at the last ``window``.  Failed refreshes append nothing:
        a gap shows as stamp spacing, never as a made-up sample."""
        window = int(window)
        if window < 1:
            raise ValueError(f"history window must be >= 1, got {window}")
        with self._mtx:
            if window != self._history_window:
                self._history = {name: deque(ring, maxlen=window) for name, ring in self._history.items()}
                self._history_window = window
                self._history_generation += 1

    def history_window(self) -> int:
        with self._mtx:
            return self._history_window

    def history_generation(self) -> int:
        """Monotonic counter bumped on every history mutation: the
        forecaster refits only when it moves."""
        with self._mtx:
            return self._history_generation

    def history_snapshot(self) -> Tuple[int, Dict[str, List[Tuple[float, Dict[str, int]]]]]:
        """(generation, {metric: [(stamp, {node: milli}), ...]}) oldest
        first.  The sample dicts are shared read-only."""
        with self._mtx:
            return self._history_generation, {name: list(ring) for name, ring in self._history.items()}

    # -- freshness --------------------------------------------------------------

    def metric_ages(self) -> Dict[str, Optional[float]]:
        """Registered metric -> seconds since its last data-bearing write
        (None = never refreshed)."""
        now = self._clock()
        with self._mtx:
            return {
                name: (now - self._last_refresh[name] if name in self._last_refresh else None)
                for name in self._metric_refcounts
                if name
            }

    def telemetry_freshness(self) -> Tuple[bool, str]:
        """The /readyz ``telemetry_fresh`` condition: ok for a cache with
        no refresh loop (a static seed), else once a refresh pass has
        completed, the last pass is recent and every registered metric's
        age is within :meth:`freshness_bound`."""
        period = self._refresh_period
        if period is None:
            return True, "static cache (no refresh loop configured)"
        if not self._synced_once.is_set():
            return False, "telemetry cache has not completed a refresh pass"
        bound = self.freshness_bound()
        now = self._clock()
        with self._mtx:
            last_pass = self._last_pass
            stale = sorted(
                name
                for name in self._metric_refcounts
                if name
                and (name not in self._last_refresh or now - self._last_refresh[name] > bound)
            )
            registered = sum(1 for name in self._metric_refcounts if name)
        if last_pass is None or now - last_pass > bound:
            since = "never" if last_pass is None else f"{now - last_pass:.1f}s"
            return False, f"refresh loop stalled (last pass {since} ago, bound {bound:.1f}s)"
        if stale:
            return False, f"metrics stale past {bound:.1f}s: {stale[:5]}"
        return True, f"{registered} metrics fresh within {bound:.1f}s"

    def freshness_bound(self) -> Optional[float]:
        """The staleness bound in seconds (``freshness_max_age_s`` or 3x
        the refresh period, at least 1 s); None for a static cache."""
        period = self._refresh_period
        if period is None:
            return None
        if self.freshness_max_age_s is not None:
            return self.freshness_max_age_s
        return max(3.0 * period, 1.0)

    def periodic_update(
        self,
        period_seconds: float,
        client: Client,
        initial_data: Optional[Dict[str, Any]] = None,
        stop: Optional[threading.Event] = None,
    ) -> None:
        """Refresh every registered metric each period until ``stop`` is set
        (update first, then wait the tick)."""
        for key, value in (initial_data or {}).items():
            self._store.add(key, value)
        self._refresh_period = period_seconds
        stop = stop or threading.Event()
        while not stop.is_set():
            self.update_all_metrics(client)
            stop.wait(period_seconds)

    def start_periodic_update(
        self,
        period_seconds: float,
        client: Client,
        initial_data: Optional[Dict[str, Any]] = None,
        stop: Optional[threading.Event] = None,
    ) -> threading.Event:
        """Run :meth:`periodic_update` on a daemon thread; returns the stop
        event (caller-supplied ``stop`` is used when given)."""
        self._refresh_period = period_seconds
        stop = stop or threading.Event()
        thread = threading.Thread(
            target=self.periodic_update,
            args=(period_seconds, client, initial_data, stop),
            daemon=True,
        )
        thread.start()
        return stop
