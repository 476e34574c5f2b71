"""TAS state cache: policies + refcounted, self-updating metrics.

The port's counterpart of ``platform_aware_scheduling_tpu/tas/cache.py``:
a mutex-guarded store with the write-nil-preserves rule, two keyspaces
``policies/<ns>/<name>`` and ``metrics/<metric>``, a refcount map so a
metric shared by several policies is evicted only when the last one goes,
and ``update_all_metrics`` re-fetching every registered metric each sync
period.  Mutation hooks let the tensor mirror (``ops/state.py``) follow
changes without polling.

Refresh-history rings and the freshness bookkeeping of the JAX cache come
in a later slice with the forecast and readiness layers.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from platform_aware_scheduling_tpu_torch.tas.metrics import Client, NodeMetricsInfo
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.utils import klog
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

POLICY_PATH = "policies/{}/{}"
METRIC_PATH = "metrics/{}"


class CacheMissError(KeyError):
    pass


def _refresh_error_reason(exc: BaseException) -> str:
    """Bounded ``reason`` label for refresh errors: throttled /
    server_error / network / no_data / fetch_error — never a raw message.
    Walks the ``__cause__`` chain first, since clients wrap the failure
    that carries the status."""
    seen = 0
    while exc.__cause__ is not None and seen < 8:
        exc = exc.__cause__
        seen += 1
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

    def __init__(self, counters: Optional[CounterSet] = None):
        self._store = _SerializedStore()
        self._metric_refcounts: Dict[str, int] = {}
        self._mtx = threading.Lock()
        self.counters = counters if counters is not None else CounterSet()
        # held across store mutation + hook delivery so mirror subscribers
        # observe mutations in store order
        self._mutation_lock = threading.RLock()
        self.on_metric_write: List[Callable[[str, Optional[NodeMetricsInfo]], None]] = []
        self.on_metric_delete: List[Callable[[str], None]] = []
        self.on_policy_write: List[Callable[[str, str, TASPolicy], None]] = []
        self.on_policy_delete: List[Callable[[str, str], None]] = []

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
                    evicted = True
                elif total is not None:
                    self._metric_refcounts[metric_name] = total - 1
                else:
                    self._metric_refcounts[metric_name] = -1
            if evicted:
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
        self.counters.inc("pas_telemetry_refresh_total")
        for reason, count in errors.items():
            self.counters.inc(
                "pas_telemetry_refresh_errors_total", count, labels={"reason": reason}
            )

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
        stop = stop or threading.Event()
        thread = threading.Thread(
            target=self.periodic_update,
            args=(period_seconds, client, initial_data, stop),
            daemon=True,
        )
        thread.start()
        return stop
