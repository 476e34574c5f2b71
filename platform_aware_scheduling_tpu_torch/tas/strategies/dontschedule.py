"""dontschedule strategy: nodes violating any rule are filtered out.

The port's copy of
``platform_aware_scheduling_tpu/tas/strategies/dontschedule.py``:
OR-semantics across rules, a node violating ANY rule is in the violation
set.  Its enforcement and cleanup do nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import (
    TASPolicyRule,
    TASPolicyStrategy,
)
from platform_aware_scheduling_tpu_torch.tas.strategies import core
from platform_aware_scheduling_tpu_torch.utils import decisions, klog, trace

STRATEGY_TYPE = "dontschedule"


@dataclass
class Strategy:
    policy_name: str = ""
    rules: List[TASPolicyRule] = field(default_factory=list)

    @classmethod
    def from_policy_strategy(cls, strat: TASPolicyStrategy) -> "Strategy":
        return cls(policy_name=strat.policy_name, rules=list(strat.rules))

    def violated(self, cache) -> Dict[str, None]:
        """Nodes whose current metric values violate any rule.  Unreadable
        metrics are skipped."""
        return {name: None for name in self.violated_details(cache)}

    def violated_details(self, cache) -> Dict[str, Tuple[int, str]]:
        """``{node: (first matching rule index, reason string)}``.  "First"
        is rule-list order, as in the device path's
        ``ops/rules.first_violated_rule``; the reason formats the SAME
        milli integers the mirror stores, so host and device FailedNodes
        values are byte-identical."""
        trace.COUNTERS.inc("pas_strategy_evaluations_total", labels={"strategy": STRATEGY_TYPE})
        violating: Dict[str, Tuple[int, str]] = {}
        for rule_index, rule in enumerate(self.rules):
            try:
                node_metrics = cache.read_metric(rule.metricname)
            except Exception as exc:
                klog.v(2).info_s(str(exc), component="controller")
                continue
            for node_name, node_metric in node_metrics.items():
                if node_name in violating:
                    continue  # an earlier rule already claimed this node
                if core.evaluate_rule(node_metric.value, rule):
                    klog.v(2).info_s(
                        f"{node_name} violating {self.policy_name}: "
                        f"{rule.metricname} {rule.operator} {rule.target}",
                        component="controller",
                    )
                    milli, exact = node_metric.value.milli_value_exact()
                    value_str = decisions.fmt_milli(milli) if exact else node_metric.value.as_dec()
                    violating[node_name] = (
                        rule_index,
                        decisions.rule_reason(
                            self.policy_name,
                            rule.metricname,
                            rule.operator,
                            value_str,
                            str(rule.target),
                        ),
                    )
        if violating:
            trace.COUNTERS.inc(
                "pas_strategy_violations_total",
                len(violating),
                labels={"strategy": STRATEGY_TYPE},
            )
        return violating

    def enforce(self, enforcer, cache) -> int:
        """Nothing to enforce: the verbs filter, nothing is labelled."""
        return 0

    def cleanup(self, enforcer, policy_name: str) -> None:
        return None

    def strategy_type(self) -> str:
        return STRATEGY_TYPE

    def equals(self, other) -> bool:
        return isinstance(other, Strategy) and core.rules_equal(self, other)

    def get_policy_name(self) -> str:
        return self.policy_name

    def set_policy_name(self, name: str) -> None:
        self.policy_name = name
