"""Strategy contract, rule math and the periodic enforcer.

The port's copy of ``platform_aware_scheduling_tpu/tas/strategies/core.py``.
``evaluate_rule`` and ``ordered_list`` are the whole mathematical core of
TAS.  These host versions are the exact-semantics control; the batched
device versions live in ``ops/rules.py`` and ``ops/scoring.py`` and are
held against these in the tests.  :class:`MetricEnforcer` registers the
strategies by type and enforces them every sync period.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, runtime_checkable

from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetricsInfo
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicyRule
from platform_aware_scheduling_tpu_torch.utils import klog
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


@runtime_checkable
class StrategyInterface(Protocol):
    """What every strategy offers."""

    def violated(self, cache) -> Dict[str, None]: ...

    def strategy_type(self) -> str: ...

    def equals(self, other: "StrategyInterface") -> bool: ...

    def get_policy_name(self) -> str: ...

    def set_policy_name(self, name: str) -> None: ...


@runtime_checkable
class Enforceable(Protocol):
    """Strategies that act on the cluster each sync period."""

    def enforce(self, enforcer: "MetricEnforcer", cache) -> int: ...

    def cleanup(self, enforcer: "MetricEnforcer", policy_name: str) -> None: ...


def rules_equal(a, b) -> bool:
    """The shared ``equals`` of the three strategies: same policy name, a
    non-empty rule list, identical (metricname, operator, target) per
    index."""
    if a.get_policy_name() != b.get_policy_name():
        return False
    ra, rb = a.rules, b.rules
    if not ra or len(ra) != len(rb):
        return False
    return all(
        x.metricname == y.metricname and x.operator == y.operator and x.target == y.target
        for x, y in zip(ra, rb)
    )


class MetricEnforcer:
    """Registers strategies by type and enforces them periodically."""

    def __init__(self, kube_client=None, mirror=None):
        self.registered_strategies: Dict[str, Dict[int, StrategyInterface]] = {}
        self.kube_client = kube_client
        # the TensorStateMirror whose device runs ``violated_device`` for
        # the strategies that have it; None evaluates on the host
        self.mirror = mirror
        # per-cycle violation subscribers ``(strategy_type, {node:
        # [policy names]})``, called at the end of every enforcement pass
        self.violation_observers: List = []
        # the tas.degraded.DegradedModeController: while it reports
        # evictions suspended (stale telemetry, a kube circuit not closed),
        # the deschedule strategy skips its label pass
        self.degraded = None
        # the kube.lease.LeaseElector under --leaderElect: the label pass
        # runs on the leader only; followers evaluate and publish
        self.leadership = None
        # the registry lock: held across each enforcement pass, across a
        # removal and its cleanup, and by the controller across a policy
        # update, so a pass sees a policy wholly before or wholly after
        # any change (the JAX copy holds it only to read the registry;
        # ROADMAP §C)
        self.lock = threading.RLock()

    def publish_violations(self, strategy_type: str, violations: Dict[str, List[str]]) -> None:
        """Fan a finished enforcement cycle's violation map out to the
        observers; a failing observer never breaks the enforcement loop."""
        for observer in list(self.violation_observers):
            try:
                observer(strategy_type, violations)
            except Exception as exc:  # noqa: BLE001 — observer errors are theirs
                klog.error("violation observer failed: %r", exc)

    def register_strategy_type(self, strategy: StrategyInterface) -> None:
        with self.lock:
            self.registered_strategies[strategy.strategy_type()] = {}

    def registered_strategy_types(self) -> List[str]:
        with self.lock:
            return list(self.registered_strategies)

    def add_strategy(self, strategy: StrategyInterface, strategy_type: str) -> None:
        """Dedup by ``equals``; only Enforceable strategies under a
        registered type are stored, keyed by ``id``, so a type's
        strategies enforce in the order they were added."""
        with self.lock:
            registry = self.registered_strategies.get(strategy_type)
            if registry is not None:
                for existing in registry.values():
                    if existing.equals(strategy):
                        klog.v(2).info_s(
                            f"Duplicate strategy found. Not adding "
                            f"{existing.get_policy_name()}: {existing.strategy_type()} to registry",
                            component="controller",
                        )
                        return
            klog.v(2).info_s(
                f"Adding strategies: {strategy.strategy_type()} {strategy.get_policy_name()}",
                component="controller",
            )
            if registry is not None and isinstance(strategy, Enforceable):
                registry[id(strategy)] = strategy

    def remove_strategy(self, strategy: StrategyInterface, strategy_type: str) -> None:
        """Remove matching strategies, then run the strategy's cleanup, both
        under the registry lock: a pass in flight finishes first, so it
        cannot label a node for the policy after its cleanup."""
        with self.lock:
            registry = self.registered_strategies.get(strategy_type, {})
            for key, existing in list(registry.items()):
                if existing.equals(strategy):
                    del registry[key]
                    klog.v(2).info_s(
                        f"Removed {existing.get_policy_name()}: {strategy_type} "
                        "from strategy register",
                        component="controller",
                    )
            if isinstance(strategy, Enforceable):
                try:
                    strategy.cleanup(self, strategy.get_policy_name())
                except Exception as exc:  # noqa: BLE001 — a failed cleanup is logged, as in the reference
                    klog.v(2).info_s(f"Failed to remove strategy: {exc}", component="controller")

    def enforce_strategy(self, strategy_type: str, cache) -> None:
        """One enforcement pass over a type's strategies, under the
        registry lock."""
        with self.lock:
            for strategy in list(self.registered_strategies.get(strategy_type, {}).values()):
                if isinstance(strategy, Enforceable):
                    try:
                        strategy.enforce(self, cache)
                    except Exception as exc:  # noqa: BLE001 — one strategy must not stop the others
                        klog.error("Strategy was not enforceable. %s", exc)

    def enforce_registered_strategies(
        self, cache, period_seconds: float, stop: Optional[threading.Event] = None
    ) -> None:
        """The periodic enforcement loop: waits a tick, then enforces every
        registered type."""
        stop = stop or threading.Event()
        while not stop.wait(period_seconds):
            for strategy_type in self.registered_strategy_types():
                self.enforce_strategy(strategy_type, cache)

    def start_enforcing(
        self, cache, period_seconds: float, stop: Optional[threading.Event] = None
    ) -> threading.Event:
        stop = stop or threading.Event()
        thread = threading.Thread(
            target=self.enforce_registered_strategies,
            args=(cache, period_seconds, stop),
            daemon=True,
        )
        thread.start()
        return stop
