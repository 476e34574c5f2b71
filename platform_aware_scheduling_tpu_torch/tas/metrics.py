"""Node-metric types and clients (the port's copy of
``platform_aware_scheduling_tpu/tas/metrics.py``).

``NodeMetric`` carries timestamp / window / value; a ``Client`` fetches
one named metric for every node.  The live custom-metrics client needs
the kube layer and comes with it in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Protocol

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


class DummyMetricsClient:
    """Canned metrics client: serves whatever ``store`` holds."""

    def __init__(self, store: Dict[str, NodeMetricsInfo] | None = None):
        self.store: Dict[str, NodeMetricsInfo] = store if store is not None else {}

    def get_node_metric(self, metric_name: str) -> NodeMetricsInfo:
        if metric_name not in self.store:
            raise MetricsError(f"no metric {metric_name} found")
        return dict(self.store[metric_name])
