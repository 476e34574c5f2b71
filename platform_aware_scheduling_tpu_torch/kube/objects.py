"""Dict-backed Kubernetes object wrappers (the port's copy of
``platform_aware_scheduling_tpu/kube/objects.py``).

The scheduler-extender wire protocol carries full ``v1.Pod`` /
``v1.NodeList`` JSON.  Objects are kept as their raw JSON dicts with thin
accessors; ``FilterResult`` re-emits the same dicts so round-trips are
exact.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Optional


class KubeObject:
    """A wrapper over a raw k8s JSON object dict."""

    __slots__ = ("raw",)

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self.raw = raw if raw is not None else {}

    # -- metadata ------------------------------------------------------------

    @property
    def metadata(self) -> Dict[str, Any]:
        # a JSON null under "metadata" is the Go zero value: decoding null
        # into a struct field "has no effect", so the object behaves as if
        # metadata were empty — normalize in place to keep setdefault-style
        # mutation semantics for writers.  Other non-dict types are NOT
        # masked: the wire decode rejects them up front (Args.from_json,
        # matching Go's decode error), and internal objects should fail
        # loudly rather than silently lose their metadata.
        md = self.raw.get("metadata")
        if md is None:
            md = {}
            self.raw["metadata"] = md
        return md

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @name.setter
    def name(self, value: str) -> None:
        self.metadata["name"] = value

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "")

    @namespace.setter
    def namespace(self, value: str) -> None:
        self.metadata["namespace"] = value

    @property
    def uid(self) -> str:
        return self.metadata.get("uid", "")

    @property
    def resource_version(self) -> str:
        return self.metadata.get("resourceVersion", "")

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.setdefault("labels", {})

    def get_labels(self) -> Dict[str, str]:
        """Labels without mutating the underlying dict (None-safe read)."""
        return self.metadata.get("labels") or {}

    @property
    def annotations(self) -> Dict[str, str]:
        return self.metadata.setdefault("annotations", {})

    def get_annotations(self) -> Dict[str, str]:
        return self.metadata.get("annotations") or {}

    @property
    def deletion_timestamp(self) -> Optional[str]:
        return self.metadata.get("deletionTimestamp")

    def deep_copy(self):
        return type(self)(copy.deepcopy(self.raw))

    def __eq__(self, other) -> bool:
        return isinstance(other, KubeObject) and self.raw == other.raw

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.namespace}/{self.name})"


class Pod(KubeObject):
    @property
    def spec(self) -> Dict[str, Any]:
        return self.raw.setdefault("spec", {})

    @property
    def status(self) -> Dict[str, Any]:
        return self.raw.setdefault("status", {})

    @property
    def spec_node_name(self) -> str:
        return self.raw.get("spec", {}).get("nodeName", "")

    @property
    def phase(self) -> str:
        return self.raw.get("status", {}).get("phase", "")

    @property
    def containers(self) -> List[Dict[str, Any]]:
        return self.raw.get("spec", {}).get("containers") or []

    def container_resource_requests(self) -> Iterator[Dict[str, Any]]:
        """Yields each container's ``resources.requests`` dict (possibly {})."""
        for container in self.containers:
            yield (container.get("resources") or {}).get("requests") or {}


class Node(KubeObject):
    @property
    def status(self) -> Dict[str, Any]:
        return self.raw.setdefault("status", {})

    @property
    def allocatable(self) -> Dict[str, Any]:
        return self.raw.get("status", {}).get("allocatable") or {}


def object_key(obj: KubeObject) -> str:
    """Cache key ``<namespace>&<name>`` (reference
    gpu-aware-scheduling/pkg/gpuscheduler/node_resource_cache.go getKey)."""
    return f"{obj.namespace}&{obj.name}"
