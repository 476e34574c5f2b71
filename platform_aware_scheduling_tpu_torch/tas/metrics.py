"""Node-metric types and clients (the port's copy of
``platform_aware_scheduling_tpu/tas/metrics.py``).

``NodeMetric`` carries timestamp / window / value; a ``Client`` fetches
one named metric for every node: ``CustomMetricsClient`` from the kube
custom-metrics API, ``DummyMetricsClient`` from a dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Protocol

from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity


@dataclass
class NodeMetric:
    """One piece of telemetry for one node."""

    value: Quantity
    timestamp: str = ""
    window_seconds: float = 60.0


# node name -> NodeMetric
NodeMetricsInfo = Dict[str, NodeMetric]


class MetricsError(Exception):
    pass


class Client(Protocol):
    """Knows how to fetch one named metric for every node."""

    def get_node_metric(self, metric_name: str) -> NodeMetricsInfo: ...


def wrap_metrics(metric_value_list: Dict[str, Any]) -> NodeMetricsInfo:
    """MetricValueList -> NodeMetricsInfo; the window defaults to one
    minute when ``windowSeconds`` is absent."""
    result: NodeMetricsInfo = {}
    for item in metric_value_list.get("items") or []:
        window = item.get("windowSeconds")
        result[(item.get("describedObject") or {}).get("name", "")] = NodeMetric(
            value=Quantity(str(item.get("value", "0"))),
            timestamp=item.get("timestamp", ""),
            window_seconds=float(window) if window is not None else 60.0,
        )
    return result


class CustomMetricsClient:
    """Live client over the kube custom-metrics API: root-scoped node
    metrics with empty selectors."""

    def __init__(self, kube_client):
        self._kube = kube_client

    def get_node_metric(self, metric_name: str) -> NodeMetricsInfo:
        try:
            value_list = self._kube.get_node_custom_metric(metric_name)
        except Exception as exc:
            raise MetricsError(
                "unable to fetch metrics from custom metrics API: " + str(exc)
            ) from exc
        if not (value_list.get("items") or []):
            raise MetricsError("no metrics returned from custom metrics API")
        return wrap_metrics(value_list)


class DummyMetricsClient:
    """Canned metrics client: serves whatever ``store`` holds."""

    def __init__(self, store: Dict[str, NodeMetricsInfo] | None = None):
        self.store: Dict[str, NodeMetricsInfo] = store if store is not None else {}

    def get_node_metric(self, metric_name: str) -> NodeMetricsInfo:
        if metric_name not in self.store:
            raise MetricsError(f"no metric {metric_name} found")
        return dict(self.store[metric_name])
