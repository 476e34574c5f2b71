"""TASPolicy controller: CRD informer -> cache writes + enforcer registry.

The port's copy of ``platform_aware_scheduling_tpu/tas/controller.py``.
An informer watches ``taspolicies``.  On add, the controller caches the
policy, registers each strategy with the enforcer and each rule's metric
(refcounted) with the cache; on update it removes the old strategies and
metric references, then adds the new; on delete it unregisters the
strategies, drops the metric references and then the policy.
``cast_strategy`` maps a strategy-type name to its class.
"""

from __future__ import annotations

import threading
from typing import Optional

from platform_aware_scheduling_tpu_torch.kube.informer import (
    DeletedFinalStateUnknown,
    Informer,
    ListWatch,
)
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy, TASPolicyStrategy
from platform_aware_scheduling_tpu_torch.tas.strategies import (
    core,
    deschedule,
    dontschedule,
    scheduleonmetric,
)
from platform_aware_scheduling_tpu_torch.utils import klog

_STRATEGY_CLASSES = {
    scheduleonmetric.STRATEGY_TYPE: scheduleonmetric.Strategy,
    deschedule.STRATEGY_TYPE: deschedule.Strategy,
    dontschedule.STRATEGY_TYPE: dontschedule.Strategy,
}


class InvalidStrategyError(ValueError):
    pass


def cast_strategy(strategy_type: str, strat: TASPolicyStrategy):
    """Strategy-type name -> concrete strategy instance."""
    cls = _STRATEGY_CLASSES.get(strategy_type)
    if cls is None:
        raise InvalidStrategyError("strategy could not be added - invalid strategy type")
    return cls.from_policy_strategy(strat)


class TelemetryPolicyController:
    """Watches the TASPolicy CRD and keeps the cache and the enforcer in
    sync with it."""

    def __init__(
        self,
        kube_client,
        cache: AutoUpdatingCache,
        enforcer: core.MetricEnforcer,
        namespace: Optional[str] = None,
    ):
        self.kube_client = kube_client
        self.cache = cache
        self.enforcer = enforcer
        self.namespace = namespace
        #: the CRD informer once :meth:`run` starts it; the service main
        #: puts its ``has_synced`` on /readyz
        self.informer: Optional[Informer] = None

    def run(self, stop: Optional[threading.Event] = None) -> Informer:
        """Start the CRD informer and return it (the caller may wait for
        its sync).  A handler that raises is contained to its event.  The
        informer stops on ``stop`` itself: told by a thread waiting on it,
        an informer that took a watch event before that thread ran would
        wait for one more event before it saw the stop."""

        def list_policies():
            obj = self.kube_client.list_taspolicies(self.namespace)
            items = obj.get("items") or []
            rv = (obj.get("metadata") or {}).get("resourceVersion", "")
            return [TASPolicy.from_obj(item) for item in items], rv

        def watch_policies(resource_version):
            for event_type, raw in self.kube_client.watch_taspolicies(
                self.namespace, resource_version=resource_version
            ):
                yield event_type, TASPolicy.from_obj(raw)

        def key(policy: TASPolicy) -> str:
            return f"{policy.namespace}/{policy.name}"

        informer = Informer(
            ListWatch(list_policies, watch_policies, key),
            on_add=self._guarded(self.on_add),
            on_update=self._guarded(self.on_update),
            on_delete=self._guarded(self.on_delete),
            name="taspolicy",
            stop=stop,
        )
        self.informer = informer
        informer.start()
        return informer

    def _guarded(self, fn):
        def wrapped(*args):
            try:
                fn(*args)
            except Exception as exc:  # noqa: BLE001 — one bad event must not stop the informer
                klog.error("Recovered from policy event panic: %s", exc)

        return wrapped

    # -- handlers -------------------------------------------------------------

    def on_add(self, policy: TASPolicy) -> None:
        """Cache the policy, register its strategies and metrics."""
        if not isinstance(policy, TASPolicy):
            klog.v(4).info_s(
                "cannot add policy: not recognized as a telemetry policy", component="controller"
            )
            return
        pol = policy.deep_copy()
        self.cache.write_policy(pol.namespace, pol.name, pol)
        for name, strat in pol.strategies.items():
            klog.v(4).info_s(f"registering {name} from {pol.name}", component="controller")
            try:
                instance = cast_strategy(name, strat)
            except InvalidStrategyError as exc:
                klog.v(2).info_s(str(exc), component="controller")
                return
            instance.set_policy_name(pol.name)
            self.enforcer.add_strategy(instance, name)
            for rule in strat.rules:
                self.cache.write_metric(rule.metricname, None)
                klog.v(2).info_s(f"Added {rule.metricname}", component="controller")
        klog.v(2).info_s(f"Added policy, {pol.name}", component="controller")

    def on_update(self, old: TASPolicy, new: TASPolicy) -> None:
        """Swap the cached policy; per strategy type, remove the old
        registration and metric references, then add the new.  All of it
        under the enforcer's registry lock, so no enforcement pass sees the
        new policy in the cache beside the old strategy."""
        with self.enforcer.lock:
            self._update(old, new)

    def _update(self, old: TASPolicy, new: TASPolicy) -> None:
        pol = new.deep_copy()
        self.cache.write_policy(pol.namespace, pol.name, pol)
        klog.v(2).info_s(f"Policy: {pol.name} updated", component="controller")
        for name, strat in pol.strategies.items():
            old_strat = old.strategies.get(name, TASPolicyStrategy())
            try:
                old_instance = cast_strategy(name, old_strat)
            except InvalidStrategyError as exc:
                klog.v(2).info_s(str(exc), component="controller")
                return
            old_instance.set_policy_name(old.name)
            self.enforcer.remove_strategy(old_instance, old_instance.strategy_type())
            for rule in old_strat.rules:
                self.cache.delete_metric(rule.metricname)
            try:
                instance = cast_strategy(name, strat)
            except InvalidStrategyError as exc:
                klog.v(2).info_s(str(exc), component="controller")
                return
            instance.set_policy_name(pol.name)
            self.enforcer.add_strategy(instance, name)
            for rule in strat.rules:
                self.cache.write_metric(rule.metricname, None)

    def on_delete(self, policy: TASPolicy) -> None:
        """Unregister the strategies, drop the metric references and the
        policy."""
        if isinstance(policy, DeletedFinalStateUnknown):
            policy = policy.obj
        pol = policy.deep_copy()
        for name, strat in pol.strategies.items():
            try:
                instance = cast_strategy(name, strat)
            except InvalidStrategyError as exc:
                klog.v(2).info_s(str(exc), component="controller")
                return
            instance.set_policy_name(pol.name)
            self.enforcer.remove_strategy(instance, instance.strategy_type())
            for rule in strat.rules:
                self.cache.delete_metric(rule.metricname)
        self.cache.delete_policy(pol.namespace, pol.name)
        klog.v(2).info_s(f"Policy: {pol.name} deleted", component="controller")
