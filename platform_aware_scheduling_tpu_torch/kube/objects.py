"""Dict-backed Kubernetes object wrappers (the port's copy of
``platform_aware_scheduling_tpu/kube/objects.py``).

Objects are kept as their raw JSON dicts with thin accessors, so the same
dict can be handed to the JAX package's wrappers and to these.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class KubeObject:
    """A wrapper over a raw k8s JSON object dict."""

    __slots__ = ("raw",)

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self.raw = raw if raw is not None else {}

    @property
    def metadata(self) -> Dict[str, Any]:
        # a JSON null under "metadata" is the Go zero value: the object
        # behaves as if metadata were empty
        md = self.raw.get("metadata")
        if md is None:
            md = {}
            self.raw["metadata"] = md
        return md

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "")

    def get_labels(self) -> Dict[str, str]:
        """Labels without mutating the underlying dict (None-safe read)."""
        return self.metadata.get("labels") or {}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.namespace}/{self.name})"


class Pod(KubeObject):
    @property
    def spec_node_name(self) -> str:
        return self.raw.get("spec", {}).get("nodeName", "")

    @property
    def phase(self) -> str:
        return self.raw.get("status", {}).get("phase", "")


class Node(KubeObject):
    @property
    def allocatable(self) -> Dict[str, Any]:
        return self.raw.get("status", {}).get("allocatable") or {}


def object_key(obj: KubeObject) -> str:
    """Cache key ``<namespace>&<name>``."""
    return f"{obj.namespace}&{obj.name}"
