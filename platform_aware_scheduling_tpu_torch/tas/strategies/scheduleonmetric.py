"""scheduleonmetric strategy: a marker type whose first rule drives the
Prioritize order; its violation set and enforcement are empty.

The port's copy of
``platform_aware_scheduling_tpu/tas/strategies/scheduleonmetric.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import (
    TASPolicyRule,
    TASPolicyStrategy,
)
from platform_aware_scheduling_tpu_torch.tas.strategies import core
from platform_aware_scheduling_tpu_torch.utils import trace

STRATEGY_TYPE = "scheduleonmetric"


@dataclass
class Strategy:
    policy_name: str = ""
    rules: List[TASPolicyRule] = field(default_factory=list)

    @classmethod
    def from_policy_strategy(cls, strat: TASPolicyStrategy) -> "Strategy":
        return cls(policy_name=strat.policy_name, rules=list(strat.rules))

    def violated(self, cache) -> Dict[str, None]:
        # empty by contract, but the evaluation is counted
        trace.COUNTERS.inc("pas_strategy_evaluations_total", labels={"strategy": STRATEGY_TYPE})
        return {}

    def enforce(self, enforcer, cache) -> int:
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
