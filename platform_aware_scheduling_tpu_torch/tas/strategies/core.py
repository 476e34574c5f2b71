"""Rule math of the TAS strategies, exact host semantics.

The port's copy of the rule part of
``platform_aware_scheduling_tpu/tas/strategies/core.py``.
``evaluate_rule`` and ``ordered_list`` are the whole mathematical core of
TAS.  These host versions are the exact-semantics control; the batched
device versions live in ``ops/rules.py`` and ``ops/scoring.py`` and are
held against these in the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetricsInfo
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicyRule
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

OPERATOR_LESS_THAN = "LessThan"
OPERATOR_GREATER_THAN = "GreaterThan"
OPERATOR_EQUALS = "Equals"


def evaluate_rule(value: Quantity, rule: TASPolicyRule) -> bool:
    """True when ``value <op> target`` holds.  An unknown operator raises
    KeyError, as the reference's nil-map lookup panics."""
    operators = {
        OPERATOR_LESS_THAN: lambda v, t: v.cmp_int64(t) == -1,
        OPERATOR_GREATER_THAN: lambda v, t: v.cmp_int64(t) == 1,
        OPERATOR_EQUALS: lambda v, t: v.cmp_int64(t) == 0,
    }
    return operators[rule.operator](value, rule.target)


@dataclass
class NodeSortableMetric:
    node_name: str
    metric_value: Quantity


def ordered_list(metrics_info: NodeMetricsInfo, operator: str) -> List[NodeSortableMetric]:
    """Order nodes by metric value: GreaterThan -> descending, LessThan ->
    ascending, anything else -> input order."""
    mtrcs = [NodeSortableMetric(name, info.value) for name, info in metrics_info.items()]
    if operator == OPERATOR_GREATER_THAN:
        mtrcs.sort(key=lambda m: m.metric_value.value, reverse=True)
    elif operator == OPERATOR_LESS_THAN:
        mtrcs.sort(key=lambda m: m.metric_value.value)
    return mtrcs
