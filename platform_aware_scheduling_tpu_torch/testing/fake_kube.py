"""In-memory fake Kubernetes API server.

The port's copy of ``platform_aware_scheduling_tpu/testing/fake_kube.py``:
the method surface of ``kube.client.KubeClient`` over dictionaries, with
live watch streams, JSON-patch support, conflict and failure injection,
and a custom-metrics backend.  It lives in the package so that the
service can be assembled and driven without a cluster (``chip_smoke.py``,
the tests, a local drive script).

The store holds JSON-shaped objects only (dicts, lists, strings, numbers,
booleans, None), and hands out copies so a caller never aliases it.  The
copies go through ``marshal``, which copies such data several times
faster than ``copy.deepcopy``; a cluster of 10,000 nodes and ~165,000
pods is listed in seconds.
"""

from __future__ import annotations

import copy
import marshal
import queue
import threading
from datetime import datetime, timezone
from typing import Any, Dict, Iterator, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.kube.client import (
    ConflictError,
    KubeError,
    NotFoundError,
)
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod


def _copy(obj):
    """A deep copy of a JSON-shaped object."""
    try:
        return marshal.loads(marshal.dumps(obj))
    except ValueError:  # not JSON-shaped after all
        return copy.deepcopy(obj)


def _unescape_pointer(token: str) -> str:
    if "~" not in token:
        return token
    return token.replace("~1", "/").replace("~0", "~")


def apply_json_patch(obj: Dict[str, Any], patch: List[Dict[str, Any]]) -> None:
    """Minimal RFC-6902 apply: add/remove/replace on nested dict paths."""
    for op in patch:
        tokens = [_unescape_pointer(t) for t in op["path"].lstrip("/").split("/")]
        target = obj
        for token in tokens[:-1]:
            if token not in target or target[token] is None:
                target[token] = {}
            target = target[token]
        leaf = tokens[-1]
        kind = op["op"]
        if kind in ("add", "replace"):
            target[leaf] = op.get("value")
        elif kind == "remove":
            if leaf not in target:
                raise KubeError(f"json patch remove: path not found: {op['path']}")
            del target[leaf]
        else:
            raise KubeError(f"unsupported json patch op: {kind}")


class _WatchHub:
    """Fan-out of watch events to subscriber queues."""

    def __init__(self):
        self._subscribers: List[queue.Queue] = []
        self._lock = threading.Lock()

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def publish(self, event_type: str, obj: Dict[str, Any]) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            q.put((event_type, _copy(obj)))


class FakeKubeClient:
    """Drop-in test double for ``kube.client.KubeClient``."""

    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._pods: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._policies: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._metrics: Dict[str, Dict[str, Dict[str, Any]]] = {}  # metric -> node -> item
        # Lease and ConfigMap stores: an update carrying a stale
        # resourceVersion answers 409, as the API server does
        self._leases: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._configmaps: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._hubs = {"nodes": _WatchHub(), "pods": _WatchHub(), "taspolicies": _WatchHub()}
        self.bindings: List[Dict[str, Any]] = []
        self.node_patches: List[Tuple[str, List[Dict[str, Any]]]] = []
        self.evictions: List[Dict[str, Any]] = []
        # (namespace, name) keys whose eviction the fake refuses with 409,
        # the API server's disruption-budget rejection
        self.evict_denials: set = set()
        # fault injection
        self.update_pod_conflicts_remaining = 0
        self.fail_next_bind: Optional[Exception] = None
        self.fail_metric_fetch: Optional[Exception] = None
        self.fail_next_evict: Optional[Exception] = None

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    # -- seeding helpers -----------------------------------------------------

    def add_node(self, node) -> None:
        raw = node.raw if isinstance(node, Node) else node
        with self._lock:
            raw.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
            self._nodes[raw["metadata"]["name"]] = _copy(raw)
        self._hubs["nodes"].publish("ADDED", raw)

    def add_pod(self, pod) -> None:
        raw = pod.raw if isinstance(pod, Pod) else pod
        meta = raw.setdefault("metadata", {})
        meta.setdefault("namespace", "default")
        with self._lock:
            meta["resourceVersion"] = self._next_rv()
            self._pods[(meta["namespace"], meta["name"])] = _copy(raw)
        self._hubs["pods"].publish("ADDED", raw)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            raw = self._pods.pop((namespace, name), None)
        if raw is not None:
            self._hubs["pods"].publish("DELETED", raw)

    def delete_node(self, name: str) -> None:
        with self._lock:
            raw = self._nodes.pop(name, None)
        if raw is not None:
            self._hubs["nodes"].publish("DELETED", raw)

    # -- nodes ---------------------------------------------------------------

    def list_nodes(self, label_selector: Optional[str] = None) -> List[Node]:
        # selector pushdown, like the real API server: match on the raw
        # labels first and copy only the hits.  ``k=v`` matches equality;
        # a bare ``k`` is the exists matcher.
        want: Dict[str, Optional[str]] = {}
        if label_selector:
            for part in label_selector.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" in part:
                    key, value = part.split("=", 1)
                    want[key] = value
                else:
                    want[part] = None
        with self._lock:
            if not want:
                return [Node(_copy(raw)) for raw in self._nodes.values()]
            matched = []
            if len(want) == 1:
                # the enforcer's label-exists query: one dict dig per node
                ((key, value),) = want.items()
                for raw in self._nodes.values():
                    meta = raw.get("metadata")
                    labels = meta.get("labels") if meta is not None else None
                    if not labels:
                        continue
                    if value is None:
                        if key in labels:
                            matched.append(Node(_copy(raw)))
                    elif labels.get(key) == value:
                        matched.append(Node(_copy(raw)))
                return matched
            for raw in self._nodes.values():
                labels = (raw.get("metadata") or {}).get("labels") or {}
                if all(
                    (key in labels if value is None else labels.get(key) == value)
                    for key, value in want.items()
                ):
                    matched.append(Node(_copy(raw)))
            return matched

    def get_node(self, name: str) -> Node:
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(f"node {name} not found", status=404)
            return Node(_copy(self._nodes[name]))

    def patch_node(self, name: str, json_patch: List[Dict[str, Any]]) -> Node:
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(f"node {name} not found", status=404)
            raw = self._nodes[name]
            apply_json_patch(raw, json_patch)
            raw["metadata"]["resourceVersion"] = self._next_rv()
            self.node_patches.append((name, _copy(json_patch)))
            snapshot = _copy(raw)
        self._hubs["nodes"].publish("MODIFIED", snapshot)
        return Node(snapshot)

    # -- pods ----------------------------------------------------------------

    def list_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        with self._lock:
            return [
                Pod(_copy(raw))
                for (ns, _), raw in self._pods.items()
                if namespace is None or ns == namespace
            ]

    def get_pod(self, namespace: str, name: str) -> Pod:
        with self._lock:
            raw = self._pods.get((namespace, name))
            if raw is None:
                raise NotFoundError(f"pod {namespace}/{name} not found", status=404)
            return Pod(_copy(raw))

    def update_pod(self, pod: Pod) -> Pod:
        with self._lock:
            key = (pod.namespace, pod.name)
            if key not in self._pods:
                raise NotFoundError(f"pod {pod.namespace}/{pod.name} not found", status=404)
            if self.update_pod_conflicts_remaining > 0:
                self.update_pod_conflicts_remaining -= 1
                raise ConflictError(
                    "Operation cannot be fulfilled: please apply your changes to "
                    "the latest version and try again",
                    status=409,
                )
            raw = _copy(pod.raw)
            raw.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
            self._pods[key] = raw
            snapshot = _copy(raw)
        self._hubs["pods"].publish("MODIFIED", snapshot)
        return Pod(snapshot)

    def bind_pod(self, namespace: str, pod_name: str, pod_uid: str, node: str) -> None:
        if self.fail_next_bind is not None:
            exc, self.fail_next_bind = self.fail_next_bind, None
            raise exc
        with self._lock:
            key = (namespace, pod_name)
            if key not in self._pods:
                raise NotFoundError(f"pod {namespace}/{pod_name} not found", status=404)
            self._pods[key].setdefault("spec", {})["nodeName"] = node
            self.bindings.append({"namespace": namespace, "pod": pod_name, "uid": pod_uid, "node": node})
            snapshot = _copy(self._pods[key])
        self._hubs["pods"].publish("MODIFIED", snapshot)

    def evict_pod(
        self, namespace: str, pod_name: str, grace_period_seconds: Optional[int] = None
    ) -> None:
        """pods/eviction subresource: a denied key answers 409; success
        records the eviction and deletes the pod (DELETED published)."""
        if self.fail_next_evict is not None:
            exc, self.fail_next_evict = self.fail_next_evict, None
            raise exc
        key = (namespace, pod_name)
        with self._lock:
            if key not in self._pods:
                raise NotFoundError(f"pod {namespace}/{pod_name} not found", status=404)
            if key in self.evict_denials:
                raise ConflictError(
                    "Cannot evict pod as it would violate the pod's disruption budget.",
                    status=409,
                )
            raw = self._pods.pop(key)
            self.evictions.append(
                {
                    "namespace": namespace,
                    "pod": pod_name,
                    "node": (raw.get("spec") or {}).get("nodeName", ""),
                    "grace_period_seconds": grace_period_seconds,
                }
            )
        self._hubs["pods"].publish("DELETED", raw)

    # -- TASPolicy CRD -------------------------------------------------------

    def list_taspolicies(self, namespace: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            items = [
                _copy(raw)
                for (ns, _), raw in self._policies.items()
                if namespace is None or ns == namespace
            ]
            return {
                "apiVersion": "telemetry.intel.com/v1alpha1",
                "kind": "TASPolicyList",
                "metadata": {"resourceVersion": str(self._rv)},
                "items": items,
            }

    def get_taspolicy(self, namespace: str, name: str) -> Dict[str, Any]:
        with self._lock:
            raw = self._policies.get((namespace, name))
            if raw is None:
                raise NotFoundError(f"taspolicy {namespace}/{name} not found", status=404)
            return _copy(raw)

    def create_taspolicy(self, policy: Dict[str, Any]) -> Dict[str, Any]:
        meta = policy.setdefault("metadata", {})
        meta.setdefault("namespace", "default")
        with self._lock:
            meta["resourceVersion"] = self._next_rv()
            self._policies[(meta["namespace"], meta["name"])] = _copy(policy)
        self._hubs["taspolicies"].publish("ADDED", policy)
        return _copy(policy)

    def update_taspolicy(self, policy: Dict[str, Any]) -> Dict[str, Any]:
        meta = policy.setdefault("metadata", {})
        meta.setdefault("namespace", "default")
        key = (meta["namespace"], meta["name"])
        with self._lock:
            if key not in self._policies:
                raise NotFoundError(f"taspolicy {key} not found", status=404)
            meta["resourceVersion"] = self._next_rv()
            self._policies[key] = _copy(policy)
        self._hubs["taspolicies"].publish("MODIFIED", policy)
        return _copy(policy)

    def delete_taspolicy(self, namespace: str, name: str) -> None:
        with self._lock:
            raw = self._policies.pop((namespace, name), None)
        if raw is None:
            raise NotFoundError(f"taspolicy {namespace}/{name} not found", status=404)
        self._hubs["taspolicies"].publish("DELETED", raw)

    # -- coordination.k8s.io leases + configmaps ------------------------------
    #
    # Optimistic-concurrency stores: creating an existing object and
    # updating with a stale resourceVersion both answer 409.

    def _oc_get(self, store, kind: str, namespace: str, name: str):
        with self._lock:
            raw = store.get((namespace, name))
            if raw is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found", status=404)
            return _copy(raw)

    def _oc_create(self, store, kind: str, obj: Dict[str, Any]):
        meta = obj.setdefault("metadata", {})
        meta.setdefault("namespace", "default")
        key = (meta["namespace"], meta["name"])
        with self._lock:
            if key in store:
                raise ConflictError(f"{kind} {key[0]}/{key[1]} already exists", status=409)
            meta["resourceVersion"] = self._next_rv()
            store[key] = _copy(obj)
        return _copy(obj)

    def _oc_update(self, store, kind: str, obj: Dict[str, Any]):
        meta = obj.setdefault("metadata", {})
        meta.setdefault("namespace", "default")
        key = (meta["namespace"], meta["name"])
        with self._lock:
            stored = store.get(key)
            if stored is None:
                raise NotFoundError(f"{kind} {key[0]}/{key[1]} not found", status=404)
            if meta.get("resourceVersion") != stored["metadata"]["resourceVersion"]:
                raise ConflictError(
                    "Operation cannot be fulfilled: please apply your "
                    "changes to the latest version and try again",
                    status=409,
                )
            meta["resourceVersion"] = self._next_rv()
            store[key] = _copy(obj)
        return _copy(obj)

    def get_lease(self, namespace: str, name: str) -> Dict[str, Any]:
        return self._oc_get(self._leases, "lease", namespace, name)

    def create_lease(self, lease: Dict[str, Any]) -> Dict[str, Any]:
        return self._oc_create(self._leases, "lease", lease)

    def update_lease(self, lease: Dict[str, Any]) -> Dict[str, Any]:
        return self._oc_update(self._leases, "lease", lease)

    def get_configmap(self, namespace: str, name: str) -> Dict[str, Any]:
        return self._oc_get(self._configmaps, "configmap", namespace, name)

    def create_configmap(self, configmap: Dict[str, Any]) -> Dict[str, Any]:
        return self._oc_create(self._configmaps, "configmap", configmap)

    def update_configmap(self, configmap: Dict[str, Any]) -> Dict[str, Any]:
        return self._oc_update(self._configmaps, "configmap", configmap)

    # -- watches -------------------------------------------------------------

    def _watch(self, hub_name: str, stop_sentinel_timeout: float = 0.1):
        hub = self._hubs[hub_name]
        q = hub.subscribe()

        def iterator() -> Iterator[Tuple[str, Dict[str, Any]]]:
            try:
                while True:
                    try:
                        yield q.get(timeout=stop_sentinel_timeout)
                    except queue.Empty:
                        continue
            finally:
                hub.unsubscribe(q)

        return iterator()

    def watch_nodes(self, **kw):
        return self._watch("nodes")

    def watch_pods(self, **kw):
        return self._watch("pods")

    def watch_taspolicies(self, namespace: Optional[str] = None, **kw):
        return self._watch("taspolicies")

    # -- custom metrics ------------------------------------------------------

    def set_node_metric(
        self,
        metric_name: str,
        node_name: str,
        value: str,
        window_seconds: Optional[int] = None,
        timestamp: Optional[str] = None,
    ) -> None:
        item = {
            "describedObject": {"kind": "Node", "name": node_name, "apiVersion": "/v1"},
            "metric": {"name": metric_name},
            # the API server's default stamp when the caller gives none
            "timestamp": timestamp or datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
            "value": value,
        }
        if window_seconds is not None:
            item["windowSeconds"] = window_seconds
        with self._lock:
            self._metrics.setdefault(metric_name, {})[node_name] = item

    def get_node_custom_metric(self, metric_name: str) -> Dict[str, Any]:
        if self.fail_metric_fetch is not None:
            raise self.fail_metric_fetch
        with self._lock:
            items = _copy(list(self._metrics.get(metric_name, {}).values()))
        return {
            "apiVersion": "custom.metrics.k8s.io/v1beta2",
            "kind": "MetricValueList",
            "metadata": {},
            "items": items,
        }
