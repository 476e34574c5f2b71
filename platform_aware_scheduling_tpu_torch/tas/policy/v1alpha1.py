"""TASPolicy CRD schema, v1alpha1.

Mirrors the reference CRD (reference telemetry-aware-scheduling/pkg/
telemetrypolicy/api/v1alpha1/types.go:9-45): group ``telemetry.intel.com``,
version ``v1alpha1``, plural ``taspolicies``.  ``spec.strategies`` maps a
strategy-type name (scheduleonmetric / dontschedule / deschedule / labeling)
to a ``TASPolicyStrategy`` whose rules are ``{metricname, operator, target}``.
JSON uses the same lowercase field names as the reference's struct tags.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

GROUP = "telemetry.intel.com"
VERSION = "v1alpha1"
PLURAL = "taspolicies"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "TASPolicy"


@dataclass(frozen=True)
class TASPolicyRule:
    """One rule: a metric name, an operator (LessThan/GreaterThan/Equals) and
    an int64 target (reference types.go:31-36)."""

    metricname: str
    operator: str
    target: int

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "TASPolicyRule":
        return cls(
            metricname=obj.get("metricname", ""),
            operator=obj.get("operator", ""),
            target=int(obj.get("target", 0)),
        )

    def to_obj(self) -> Dict[str, Any]:
        return {
            "metricname": self.metricname,
            "operator": self.operator,
            "target": self.target,
        }


@dataclass
class TASPolicyStrategy:
    """A named set of rules (reference types.go:25-29)."""

    policy_name: str = ""
    rules: List[TASPolicyRule] = field(default_factory=list)

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "TASPolicyStrategy":
        return cls(
            policy_name=obj.get("policyName", ""),
            rules=[TASPolicyRule.from_obj(r) for r in obj.get("rules") or []],
        )

    def to_obj(self) -> Dict[str, Any]:
        return {
            "policyName": self.policy_name,
            "rules": [r.to_obj() for r in self.rules],
        }


@dataclass
class TASPolicy:
    """The policy object (reference types.go:16-23).  ``metadata`` is kept as
    the raw dict; ``strategies`` maps strategy type -> TASPolicyStrategy."""

    metadata: Dict[str, Any] = field(default_factory=dict)
    strategies: Dict[str, TASPolicyStrategy] = field(default_factory=dict)
    status: Dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "")

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "TASPolicy":
        spec = obj.get("spec") or {}
        strategies = {
            name: TASPolicyStrategy.from_obj(strat)
            for name, strat in (spec.get("strategies") or {}).items()
        }
        return cls(
            metadata=copy.deepcopy(obj.get("metadata") or {}),
            strategies=strategies,
            status=copy.deepcopy(obj.get("status") or {}),
        )

    def to_obj(self) -> Dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": KIND,
            "metadata": copy.deepcopy(self.metadata),
            "spec": {
                "strategies": {
                    name: strat.to_obj() for name, strat in self.strategies.items()
                }
            },
            "status": copy.deepcopy(self.status),
        }

    def deep_copy(self) -> "TASPolicy":
        return TASPolicy.from_obj(self.to_obj())
