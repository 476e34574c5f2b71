"""deschedule strategy: violation detection and node-label enforcement.

The port's copy of ``platform_aware_scheduling_tpu/tas/strategies/
deschedule.py``.  Violating nodes get the label ``<policyName>=violating``
through a JSON patch; a node that no longer violates but still carries
the label gets it removed and re-added as "null" (the reference's quirk,
kept byte for byte: external deschedulers match on these labels).
Eviction itself is left to an external descheduler.

With a mirror on the enforcer, each policy's violation set comes from
``ops/rules.violated_nodes`` on the mirror's device
(:meth:`Strategy.violated_device`); the host evaluation
(:meth:`Strategy.violated`) is the exact control, and the fallback when
the device cannot serve a policy.  A fallback while a mirror is attached
counts on ``pas_deschedule_host_fallback_total``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from platform_aware_scheduling_tpu_torch.ops.rules import OP_IDS, violated_nodes
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import (
    TASPolicyRule,
    TASPolicyStrategy,
)
from platform_aware_scheduling_tpu_torch.tas.strategies import core
from platform_aware_scheduling_tpu_torch.utils import klog, trace

STRATEGY_TYPE = "deschedule"


class _BareNode:
    """A name-only stand-in for a node known to carry none of the
    registered policy labels (it matched no label-exists selector): the
    label pass needs only its name to add ``=violating``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def get_labels(self) -> Dict[str, str]:
        return {}


@dataclass
class Strategy:
    policy_name: str = ""
    rules: List[TASPolicyRule] = field(default_factory=list)

    @classmethod
    def from_policy_strategy(cls, strat: TASPolicyStrategy) -> "Strategy":
        return cls(policy_name=strat.policy_name, rules=list(strat.rules))

    # -- violation detection ---------------------------------------------------

    def violated(self, cache) -> Dict[str, None]:
        """Nodes whose current values violate any rule, on the host."""
        trace.COUNTERS.inc("pas_strategy_evaluations_total", labels={"strategy": STRATEGY_TYPE})
        violating: Dict[str, None] = {}
        for rule in self.rules:
            try:
                node_metrics = cache.read_metric(rule.metricname)
            except Exception as exc:  # noqa: BLE001 — an unreadable metric is skipped
                klog.v(2).info_s(str(exc), component="controller")
                continue
            for node_name, node_metric in node_metrics.items():
                if core.evaluate_rule(node_metric.value, rule):
                    klog.v(2).info_s(
                        f"{node_name} violating {self.policy_name}: "
                        f"{rule.metricname} {rule.operator} {rule.target}",
                        component="controller",
                    )
                    violating[node_name] = None
        if violating:
            trace.COUNTERS.inc(
                "pas_strategy_violations_total", len(violating), labels={"strategy": STRATEGY_TYPE}
            )
        return violating

    def violated_device(self, mirror) -> "Dict[str, None] | None":
        """The same set from one ``violated_nodes`` pass on the mirror's
        device; None means 'use the host path' (policy unknown, host-only
        values, or the mirror's compiled rules differ from this
        instance's)."""
        try:
            compiled, view = mirror.policy_with_view_by_name(self.policy_name)
            if compiled is None or compiled.deschedule is None:
                return None
            rs = compiled.deschedule
            if rs.host_only or not rs.active.any():
                return None
            if any(mirror.metric_host_only(m) for m in rs.metric_names):
                return None
            # the enforcer's instance and the mirror's compiled policy come
            # from the same CRD event by different paths: check that they
            # describe the same rules (from the host staging arrays, never
            # the device copies) before trusting the device result
            count = len(rs.metric_names)
            mine = tuple(
                (r.metricname, OP_IDS.get(r.operator, -1), r.target * 1000) for r in self.rules
            )
            theirs = tuple(
                zip(rs.metric_names, rs.op_ids[:count].tolist(), rs.targets[:count].tolist())
            )
            if mine != theirs:
                return None
            rules = compiled.device_rules("deschedule")
            mask = violated_nodes(view.values, view.present, rules).cpu().numpy()
            names = view.node_names
            violating = {names[i]: None for i in np.flatnonzero(mask) if i < len(names)}
            # the host path's counters: the evaluation happened, on the device
            trace.COUNTERS.inc("pas_strategy_evaluations_total", labels={"strategy": STRATEGY_TYPE})
            if violating:
                trace.COUNTERS.inc(
                    "pas_strategy_violations_total", len(violating), labels={"strategy": STRATEGY_TYPE}
                )
            return violating
        except Exception as exc:  # noqa: BLE001 — enforcement never fails on device trouble
            klog.error("device deschedule failed, host fallback: %s", exc)
            return None

    # -- enforcement ----------------------------------------------------------

    def enforce(self, enforcer: core.MetricEnforcer, cache) -> int:
        """Compute the violations of every registered deschedule policy,
        list the nodes whose labels can change, and patch them.

        With a leader elector on the enforcer, a follower evaluates and
        publishes the violations and writes no label, so N replicas make
        one stream of labels.  While the degraded-mode controller reports
        evictions suspended (telemetry stale, or the kube circuit not
        closed), the label pass is skipped: violations from data the
        service cannot trust never become ``=violating`` labels.  The
        cycle still publishes them, and makes one ``list_nodes`` call: with
        the label pass skipped nothing else may call the kube group, and a
        circuit leaves half-open only through a call.  An open circuit
        refuses it at once; once the reset timeout has passed it is the
        probe that closes the circuit and ends the suspension."""
        leadership = enforcer.leadership
        if leadership is not None and not leadership.is_leader():
            enforcer.publish_violations(STRATEGY_TYPE, self._node_status_for_strategy(enforcer, cache))
            return 0
        degraded = enforcer.degraded
        if degraded is not None:
            allowed, reason = degraded.evictions_allowed()
            if not allowed:
                klog.v(2).info_s(f"deschedule enforcement suspended: {reason}", component="controller")
                try:
                    enforcer.kube_client.list_nodes()
                except Exception as probe_exc:  # noqa: BLE001 — the probe's failure is the breaker's business
                    klog.v(4).info_s(f"suspended-cycle kube probe: {probe_exc}", component="controller")
                enforcer.publish_violations(STRATEGY_TYPE, self._node_status_for_strategy(enforcer, cache))
                return 0
        violations = self._node_status_for_strategy(enforcer, cache)
        try:
            nodes = self._nodes_needing_labels(enforcer, violations)
        except Exception as exc:
            klog.v(2).info_s(f"cannot list nodes: {exc}", component="controller")
            raise
        try:
            total = self._update_node_labels(enforcer, violations, nodes)
        finally:
            # every cycle publishes its full node -> [policies] map, the
            # empty one included, even when a patch failed
            enforcer.publish_violations(STRATEGY_TYPE, violations)
        trace.COUNTERS.inc("pas_strategy_enforcements_total", labels={"strategy": STRATEGY_TYPE})
        return total

    def cleanup(self, enforcer: core.MetricEnforcer, policy_name: str) -> None:
        """Remove the violation label from labelled nodes when the policy
        is deleted."""
        try:
            nodes = enforcer.kube_client.list_nodes(label_selector=f"{policy_name}=violating")
        except Exception as exc:
            klog.v(2).info_s(f"cannot list nodes: {exc}", component="controller")
            raise
        for node in nodes:
            payload = []
            if policy_name in node.get_labels():
                payload.append({"op": "remove", "path": "/metadata/labels/" + policy_name})
            try:
                self._patch_node(node.name, enforcer, payload)
            except Exception as exc:  # noqa: BLE001 — one node's failure is logged, the rest go on
                klog.v(2).info_s(str(exc), component="controller")
        klog.v(2).info_s(f"Remove the node label on policy {policy_name} deletion", component="controller")

    def _patch_node(self, node_name: str, enforcer: core.MetricEnforcer, payload: List[Dict]) -> None:
        enforcer.kube_client.patch_node(node_name, payload)

    def _nodes_needing_labels(self, enforcer: core.MetricEnforcer, violations: Dict[str, List[str]]):
        """Only the nodes whose label state can change this cycle: every
        node carrying a registered policy's label (the remove/re-add-"null"
        pass) plus the violating nodes.  A label-exists selector per policy
        asks the API server for exactly that set, where the reference lists
        every node; the final labels are the same, since a node in neither
        set got an empty, no-op patch."""
        candidates: Dict[str, object] = {}
        for policy_name in self._all_policies(enforcer):
            for node in enforcer.kube_client.list_nodes(label_selector=policy_name):
                candidates[node.name] = node
        for name in violations:
            if name not in candidates:
                candidates[name] = _BareNode(name)
        return list(candidates.values())

    def _all_policies(self, enforcer: core.MetricEnforcer) -> Dict[str, None]:
        return {
            strat.get_policy_name(): None
            for strat in enforcer.registered_strategies.get(STRATEGY_TYPE, {}).values()
        }

    def _node_status_for_strategy(self, enforcer: core.MetricEnforcer, cache) -> Dict[str, List[str]]:
        """node -> [policy names violated] over every registered deschedule
        strategy, in registration order."""
        violations: Dict[str, List[str]] = {}
        mirror = getattr(enforcer, "mirror", None)
        for strat in list(enforcer.registered_strategies.get(STRATEGY_TYPE, {}).values()):
            klog.v(2).info_s("Evaluating " + strat.get_policy_name(), component="controller")
            nodes = None
            if mirror is not None and hasattr(strat, "violated_device"):
                nodes = strat.violated_device(mirror)
                if nodes is None:
                    trace.COUNTERS.inc("pas_deschedule_host_fallback_total")
            if nodes is None:
                nodes = strat.violated(cache)
            for node in nodes:
                violations.setdefault(node, []).append(strat.get_policy_name())
        return violations

    def _update_node_labels(
        self, enforcer: core.MetricEnforcer, violations: Dict[str, List[str]], all_nodes
    ) -> int:
        """Patch the candidate nodes: each violated policy -> add
        ``=violating``; each registered, not violated policy whose label is
        present -> remove, then add it back as "null".  Empty payloads are
        skipped.  Returns the number of (node, violated policy) pairs."""
        total_violations = 0
        label_errs = ""
        for node in all_nodes:
            payload: List[Dict] = []
            non_violated = self._all_policies(enforcer)
            violated_policies = ""
            for policy_name in violations.get(node.name, []):
                non_violated.pop(policy_name, None)
                payload.append(
                    {"op": "add", "path": "/metadata/labels/" + policy_name, "value": "violating"}
                )
                violated_policies += policy_name + ", "
            for policy_name in non_violated:
                if policy_name in node.get_labels():
                    payload.append({"op": "remove", "path": "/metadata/labels/" + policy_name})
                    payload.append(
                        {"op": "add", "path": "/metadata/labels/" + policy_name, "value": "null"}
                    )
            total_violations += len(violations.get(node.name, []))
            if not payload:
                continue  # an empty JSON patch changes nothing
            try:
                self._patch_node(node.name, enforcer, payload)
            except Exception as exc:  # noqa: BLE001 — collected and raised after the pass
                if not label_errs:
                    label_errs = "could not label: "
                klog.v(4).info_s(str(exc), component="controller")
                label_errs += f"{node.name}: [ {violated_policies} ]; "
            if violated_policies:
                klog.v(2).info_s(f"Node {node.name} violating {violated_policies}", component="controller")
        if label_errs:
            raise RuntimeError(label_errs)
        return total_violations

    # -- identity ------------------------------------------------------------

    def strategy_type(self) -> str:
        return STRATEGY_TYPE

    def equals(self, other) -> bool:
        return isinstance(other, Strategy) and core.rules_equal(self, other)

    def get_policy_name(self) -> str:
        return self.policy_name

    def set_policy_name(self, name: str) -> None:
        self.policy_name = name
