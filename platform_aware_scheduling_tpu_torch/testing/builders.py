"""Builders for the k8s object dicts the tests and the smoke run use (the
port's copy of part of ``platform_aware_scheduling_tpu/testing/builders.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional

from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod


def make_node(
    name: str,
    labels: Optional[Dict[str, str]] = None,
    allocatable: Optional[Dict[str, str]] = None,
) -> Node:
    return Node(
        {
            "metadata": {"name": name, "labels": labels or {}},
            "status": {"allocatable": allocatable or {}},
        }
    )


def make_pod(
    name: str,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    container_requests: Optional[List[Dict[str, str]]] = None,
    node_name: str = "",
    phase: str = "Pending",
    uid: str = "",
) -> Pod:
    containers = [
        {"name": f"c{i}", "resources": {"requests": dict(reqs)}}
        for i, reqs in enumerate(container_requests or [{}])
    ]
    raw = {
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": labels or {},
            "uid": uid or f"uid-{namespace}-{name}",
        },
        "spec": {"containers": containers},
        "status": {"phase": phase},
    }
    if annotations:
        raw["metadata"]["annotations"] = dict(annotations)
    if node_name:
        raw["spec"]["nodeName"] = node_name
    return Pod(raw)


def make_policy(
    name: str,
    namespace: str = "default",
    strategies: Optional[Dict[str, List[Dict]]] = None,
) -> Dict:
    """A TASPolicy dict.  ``strategies`` maps strategy type -> list of
    (metricname, operator, target) rule dicts."""
    return {
        "apiVersion": "telemetry.intel.com/v1alpha1",
        "kind": "TASPolicy",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "strategies": {
                stype: {"policyName": name, "rules": list(rules)}
                for stype, rules in (strategies or {}).items()
            }
        },
    }


def rule(metricname: str, operator: str, target: int) -> Dict:
    return {"metricname": metricname, "operator": operator, "target": target}
