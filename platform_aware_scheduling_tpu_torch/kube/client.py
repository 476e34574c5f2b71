"""Kubernetes REST client: config loading, core verbs, CRD access, watches.

The port's copy of ``platform_aware_scheduling_tpu/kube/client.py``.
Config resolution tries the in-cluster service account first and falls
back to a kubeconfig file.  The verb surface is what the schedulers
need: node list/get/patch, pod list/get/update/bind/evict, leases and
config maps, TASPolicy CRUD and watches, and the custom-metrics API.

Everything is JSON over HTTP(S) through ``urllib``; objects stay raw dicts
(wrapped by ``kube.objects``).  Watches are chunked JSON streams yielding
``(event_type, object)`` tuples.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import (
    GROUP as CRD_GROUP,
    PLURAL as CRD_PLURAL,
    VERSION as CRD_VERSION,
)
from platform_aware_scheduling_tpu_torch.utils import klog

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

CUSTOM_METRICS_GROUP = "custom.metrics.k8s.io"
CUSTOM_METRICS_VERSIONS = ("v1beta2", "v1beta1")


class KubeError(Exception):
    def __init__(self, message: str, status: int = 0, retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = status
        #: server-sent Retry-After in seconds (429/503), honoured as a
        #: backoff floor by kube.retry.RetryPolicy; None when absent
        self.retry_after = retry_after


class ConflictError(KubeError):
    """HTTP 409: an optimistic-concurrency conflict.  The message keeps
    the wording 'please apply your changes to the latest version' that
    conflict-retry loops match on."""


class NotFoundError(KubeError):
    """HTTP 404."""


@dataclass
class KubeConfig:
    host: str
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    insecure_skip_verify: bool = False

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host or not os.path.exists(token_path):
            raise KubeError("not running in a cluster")
        with open(token_path) as f:
            token = f.read().strip()
        return cls(
            host=f"https://{host}:{port}",
            token=token,
            ca_file=ca_path if os.path.exists(ca_path) else None,
        )

    @classmethod
    def from_kubeconfig(cls, path: str) -> "KubeConfig":
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f)
        current = cfg.get("current-context")
        contexts = {c["name"]: c["context"] for c in cfg.get("contexts", [])}
        ctx = contexts.get(current) or next(iter(contexts.values()), None)
        if ctx is None:
            raise KubeError(f"no context in kubeconfig {path}")
        clusters = {c["name"]: c["cluster"] for c in cfg.get("clusters", [])}
        users = {u["name"]: u.get("user", {}) for u in cfg.get("users", [])}
        cluster = clusters[ctx["cluster"]]
        user = users.get(ctx.get("user", ""), {})

        def _inline(data_key: str, file_key: str, blob: dict) -> Optional[str]:
            if blob.get(file_key):
                return blob[file_key]
            if blob.get(data_key):
                import base64
                import tempfile

                fd, p = tempfile.mkstemp()
                with os.fdopen(fd, "wb") as fh:
                    fh.write(base64.b64decode(blob[data_key]))
                return p
            return None

        return cls(
            host=cluster["server"],
            token=user.get("token"),
            ca_file=_inline("certificate-authority-data", "certificate-authority", cluster),
            client_cert_file=_inline("client-certificate-data", "client-certificate", user),
            client_key_file=_inline("client-key-data", "client-key", user),
            insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify")),
        )


def _parse_retry_after(headers) -> Optional[float]:
    """Seconds from a ``Retry-After`` header (delta-seconds form only, the
    form kube API throttling sends); None when absent or unparseable."""
    if headers is None:
        return None
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        value = float(str(raw).strip())
    except ValueError:
        return None
    return value if value >= 0 else None


def get_kube_client(kube_config_path: str) -> "KubeClient":
    """In-cluster config with kubeconfig-file fallback."""
    try:
        config = KubeConfig.in_cluster()
    except KubeError:
        klog.v(4).info_s("not in cluster - trying file-based configuration", component="controller")
        config = KubeConfig.from_kubeconfig(kube_config_path)
    return KubeClient(config)


class KubeClient:
    """The concrete REST client.  Its callers depend only on the methods
    they use, so tests swap in ``testing.fake_kube.FakeKubeClient``."""

    def __init__(self, config: KubeConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        self._ssl = self._build_ssl_context()
        self._lock = threading.Lock()

    def _build_ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.config.host.startswith("https"):
            return None
        ctx = ssl.create_default_context(cafile=self.config.ca_file)
        if self.config.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.config.client_cert_file:
            ctx.load_cert_chain(self.config.client_cert_file, self.config.client_key_file)
        return ctx

    # -- raw REST ------------------------------------------------------------

    def request(
        self,
        method: str,
        path: str,
        body: Optional[Any] = None,
        content_type: str = "application/json",
        stream: bool = False,
        timeout: Optional[float] = None,
    ):
        url = self.config.host.rstrip("/") + path
        data = None
        if body is not None:
            data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        try:
            resp = urllib.request.urlopen(req, timeout=timeout or self.timeout, context=self._ssl)
        except urllib.error.HTTPError as exc:
            msg = exc.read().decode(errors="replace")
            if exc.code == 409:
                # keep the wording conflict-retry loops match on
                raise ConflictError(
                    f"Operation cannot be fulfilled: please apply your changes "
                    f"to the latest version and try again: {msg}",
                    status=409,
                ) from exc
            if exc.code == 404:
                raise NotFoundError(msg or "not found", status=404) from exc
            raise KubeError(
                f"{method} {path}: HTTP {exc.code}: {msg}",
                status=exc.code,
                retry_after=_parse_retry_after(exc.headers),
            ) from exc
        except urllib.error.URLError as exc:
            raise KubeError(f"{method} {path}: {exc.reason}") from exc
        if stream:
            return resp
        payload = resp.read()
        resp.close()
        return json.loads(payload) if payload else None

    # -- nodes ---------------------------------------------------------------

    def list_nodes(self, label_selector: Optional[str] = None) -> List[Node]:
        qs = f"?labelSelector={urllib.parse.quote(label_selector)}" if label_selector else ""
        obj = self.request("GET", f"/api/v1/nodes{qs}")
        return [Node(item) for item in obj.get("items", [])]

    def get_node(self, name: str) -> Node:
        return Node(self.request("GET", f"/api/v1/nodes/{name}"))

    def patch_node(self, name: str, json_patch: List[Dict[str, Any]]) -> Node:
        """JSON-patch a node (the deschedule strategy's violation labels)."""
        return Node(
            self.request(
                "PATCH",
                f"/api/v1/nodes/{name}",
                body=json_patch,
                content_type="application/json-patch+json",
            )
        )

    # -- pods ----------------------------------------------------------------

    def list_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        path = f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"
        obj = self.request("GET", path)
        return [Pod(item) for item in obj.get("items", [])]

    def get_pod(self, namespace: str, name: str) -> Pod:
        return Pod(self.request("GET", f"/api/v1/namespaces/{namespace}/pods/{name}"))

    def update_pod(self, pod: Pod) -> Pod:
        return Pod(
            self.request(
                "PUT",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}",
                body=pod.raw,
            )
        )

    def bind_pod(self, namespace: str, pod_name: str, pod_uid: str, node: str) -> None:
        """POST the pods/binding subresource."""
        binding = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": pod_name, "uid": pod_uid},
            "target": {"kind": "Node", "name": node},
        }
        self.request("POST", f"/api/v1/namespaces/{namespace}/pods/{pod_name}/binding", body=binding)

    def evict_pod(
        self,
        namespace: str,
        pod_name: str,
        grace_period_seconds: Optional[int] = None,
    ) -> None:
        """POST the pods/eviction subresource (policy/v1 Eviction).  The API
        server enforces PodDisruptionBudgets here: a guarded pod answers
        409/429, raised as :class:`ConflictError`/`KubeError`."""
        eviction: Dict[str, Any] = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod_name, "namespace": namespace},
        }
        if grace_period_seconds is not None:
            eviction["deleteOptions"] = {"gracePeriodSeconds": int(grace_period_seconds)}
        self.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{pod_name}/eviction", body=eviction
        )

    # -- coordination.k8s.io leases -------------------------------------------

    def _lease_base(self, namespace: str) -> str:
        return f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"

    def get_lease(self, namespace: str, name: str) -> Dict[str, Any]:
        return self.request("GET", f"{self._lease_base(namespace)}/{name}")

    def create_lease(self, lease: Dict[str, Any]) -> Dict[str, Any]:
        ns = lease.get("metadata", {}).get("namespace", "default")
        return self.request("POST", self._lease_base(ns), body=lease)

    def update_lease(self, lease: Dict[str, Any]) -> Dict[str, Any]:
        meta = lease.get("metadata", {})
        return self.request(
            "PUT", f"{self._lease_base(meta.get('namespace', 'default'))}/{meta['name']}", body=lease
        )

    # -- configmaps -----------------------------------------------------------

    def _configmap_base(self, namespace: str) -> str:
        return f"/api/v1/namespaces/{namespace}/configmaps"

    def get_configmap(self, namespace: str, name: str) -> Dict[str, Any]:
        return self.request("GET", f"{self._configmap_base(namespace)}/{name}")

    def create_configmap(self, configmap: Dict[str, Any]) -> Dict[str, Any]:
        ns = configmap.get("metadata", {}).get("namespace", "default")
        return self.request("POST", self._configmap_base(ns), body=configmap)

    def update_configmap(self, configmap: Dict[str, Any]) -> Dict[str, Any]:
        meta = configmap.get("metadata", {})
        return self.request(
            "PUT",
            f"{self._configmap_base(meta.get('namespace', 'default'))}/{meta['name']}",
            body=configmap,
        )

    # -- TASPolicy CRD ----------------------------------------------------------

    def _crd_base(self, namespace: Optional[str]) -> str:
        if namespace:
            return f"/apis/{CRD_GROUP}/{CRD_VERSION}/namespaces/{namespace}/{CRD_PLURAL}"
        return f"/apis/{CRD_GROUP}/{CRD_VERSION}/{CRD_PLURAL}"

    def list_taspolicies(self, namespace: Optional[str] = None) -> Dict[str, Any]:
        return self.request("GET", self._crd_base(namespace))

    def get_taspolicy(self, namespace: str, name: str) -> Dict[str, Any]:
        return self.request("GET", f"{self._crd_base(namespace)}/{name}")

    def create_taspolicy(self, policy: Dict[str, Any]) -> Dict[str, Any]:
        ns = policy.get("metadata", {}).get("namespace", "default")
        return self.request("POST", self._crd_base(ns), body=policy)

    def update_taspolicy(self, policy: Dict[str, Any]) -> Dict[str, Any]:
        meta = policy.get("metadata", {})
        return self.request(
            "PUT", f"{self._crd_base(meta.get('namespace', 'default'))}/{meta['name']}", body=policy
        )

    def delete_taspolicy(self, namespace: str, name: str) -> None:
        self.request("DELETE", f"{self._crd_base(namespace)}/{name}")

    # -- watches -------------------------------------------------------------

    def watch(
        self,
        path: str,
        resource_version: str = "",
        timeout_seconds: int = 0,
    ) -> Iterator[Tuple[str, Dict[str, Any]]]:
        """Stream watch events as ``(type, object)``; type is
        ADDED/MODIFIED/DELETED/BOOKMARK/ERROR."""
        qs = {"watch": "true"}
        if resource_version:
            qs["resourceVersion"] = resource_version
        if timeout_seconds:
            qs["timeoutSeconds"] = str(timeout_seconds)
        full = f"{path}?{urllib.parse.urlencode(qs)}"
        resp = self.request("GET", full, stream=True, timeout=max(timeout_seconds + 30, 300))
        try:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                yield event.get("type", ""), event.get("object", {})
        finally:
            resp.close()

    def watch_taspolicies(self, namespace: Optional[str] = None, **kw):
        return self.watch(self._crd_base(namespace), **kw)

    def watch_pods(self, **kw):
        return self.watch("/api/v1/pods", **kw)

    def watch_nodes(self, **kw):
        return self.watch("/api/v1/nodes", **kw)

    # -- custom-metrics API ---------------------------------------------------

    def get_node_custom_metric(self, metric_name: str) -> Dict[str, Any]:
        """Root-scoped node metric for all nodes (empty selectors): the raw
        MetricValueList, from the first API version that answers."""
        last_err: Optional[Exception] = None
        for version in CUSTOM_METRICS_VERSIONS:
            path = (
                f"/apis/{CUSTOM_METRICS_GROUP}/{version}/nodes/*/"
                f"{urllib.parse.quote(metric_name, safe='')}"
            )
            try:
                return self.request("GET", path)
            except KubeError as exc:
                last_err = exc
        raise KubeError("unable to fetch metrics from custom metrics API: " + str(last_err))
