"""The port's TASPolicy controller, enforcer and deschedule strategy
(``tas/controller.py``, ``tas/strategies/{core,deschedule,
scheduleonmetric,dontschedule}.py``) held exactly against the JAX
package's.  Twin fake API servers receive the same CRD events and twin
caches the same metrics; the registered strategies, the caches' metric
refcounts, the node labels and every patch sent must be equal.
``violated_device`` on a CPU mirror is held against the host
``violated``."""

import json
import threading
import time

import numpy as np
import pytest

from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas import controller as jax_controller
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.policy import v1alpha1 as jax_v1alpha1
from platform_aware_scheduling_tpu.tas.strategies import core as jax_core
from platform_aware_scheduling_tpu.tas.strategies import deschedule as jax_deschedule
from platform_aware_scheduling_tpu.tas.strategies import dontschedule as jax_dontschedule
from platform_aware_scheduling_tpu.tas.strategies import scheduleonmetric as jax_scheduleonmetric
from platform_aware_scheduling_tpu.testing.fake_kube import FakeKubeClient as JaxFake
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.ops import rules as rule_ops
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas import controller
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache, CacheMissError
from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
from platform_aware_scheduling_tpu_torch.tas.policy import v1alpha1
from platform_aware_scheduling_tpu_torch.tas.strategies import (
    core,
    deschedule,
    dontschedule,
    scheduleonmetric,
)
from platform_aware_scheduling_tpu_torch.testing.builders import make_node, make_policy, rule
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
from platform_aware_scheduling_tpu_torch.utils import trace
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

POLICY = make_policy(
    "demo-policy",
    strategies={
        "dontschedule": [rule("memory", "GreaterThan", 80)],
        "deschedule": [rule("memory", "GreaterThan", 90)],
        "scheduleonmetric": [rule("cpu", "LessThan", 0)],
    },
)


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


class Side:
    """One package's controller stack over its own fake API server,
    registered in the service main's order."""

    def __init__(self, jax: bool, mirror: bool = False, nodes=()):
        self.jax = jax
        mods = (
            (JaxFake, JaxCache, jax_core, jax_deschedule, jax_scheduleonmetric, jax_dontschedule, jax_controller)
            if jax
            else (FakeKubeClient, AutoUpdatingCache, core, deschedule, scheduleonmetric, dontschedule, controller)
        )
        fake_cls, cache_cls, core_mod, desched, schedule, dont, ctl = mods
        self.kube = fake_cls()
        for name in nodes:
            self.kube.add_node(make_node(name).raw)
        self.cache = cache_cls()
        self.mirror = None
        if mirror:
            self.mirror = JaxMirror() if jax else TensorStateMirror(device="cpu")
            self.mirror.attach(self.cache)
        self.enforcer = core_mod.MetricEnforcer(self.kube, mirror=self.mirror)
        for mod in (desched, schedule, dont):
            self.enforcer.register_strategy_type(mod.Strategy())
        self.controller = ctl.TelemetryPolicyController(self.kube, self.cache, self.enforcer)
        self.informer = None

    def run(self):
        self.informer = self.controller.run()
        assert self.informer.wait_for_cache_sync(10)

    def metric(self, name, values):
        node_metric, quantity = (JaxNodeMetric, JaxQuantity) if self.jax else (NodeMetric, Quantity)
        self.cache.write_metric(name, {n: node_metric(value=quantity(str(v))) for n, v in values.items()})

    def snapshot(self):
        """Registered strategies per type in order, the metric refcounts
        and the cached policies, taken while no handler runs."""

        def take():
            strategies = {
                stype: [
                    (s.get_policy_name(), [(r.metricname, r.operator, r.target) for r in s.rules])
                    for s in registry.values()
                ]
                for stype, registry in self.enforcer.registered_strategies.items()
            }
            policies = sorted(
                key for key, value in self.cache._store._data.items() if key.startswith("policies/") and value
            )
            return strategies, dict(self.cache._metric_refcounts), policies

        return self.informer.serialized(take) if self.informer else take()

    def labels(self):
        return {n.name: n.get_labels() for n in self.kube.list_nodes()}


class Twins:
    def __init__(self, **kw):
        self.jax, self.port = Side(True, **kw), Side(False, **kw)
        self.sides = (self.jax, self.port)

    def run(self):
        for side in self.sides:
            side.run()

    def crd(self, op, *args):
        for side in self.sides:
            getattr(side.kube, op)(*[json.loads(json.dumps(a)) for a in args])

    def settle(self, pred):
        """Wait until ``pred(side)`` holds on both, then compare."""
        assert wait_until(lambda: all(side.informer.serialized(lambda s=side: pred(s)) for side in self.sides))
        assert self.port.snapshot() == self.jax.snapshot()
        return self.port.snapshot()

    def metric(self, name, values):
        for side in self.sides:
            side.metric(name, values)

    def enforce(self):
        for side in self.sides:
            side.enforcer.enforce_strategy("deschedule", side.cache)
        assert self.port.kube.node_patches == self.jax.kube.node_patches
        assert self.port.labels() == self.jax.labels()
        return self.port.labels()


def has_policy(side, name, target=None):
    try:
        pol = side.cache.read_policy("default", name)
    except Exception:  # noqa: BLE001 — either package's CacheMissError
        return False
    return target is None or pol.strategies["deschedule"].rules[0].target == target


# -- the JAX tests/test_controller.py cases, on twin stacks -------------------------------


class TestCastStrategy:
    def test_known_types(self):
        strat = v1alpha1.TASPolicyStrategy.from_obj({"policyName": "p", "rules": [rule("m", "LessThan", 1)]})
        jax_strat = jax_v1alpha1.TASPolicyStrategy.from_obj({"policyName": "p", "rules": [rule("m", "LessThan", 1)]})
        for name in ("dontschedule", "deschedule", "scheduleonmetric"):
            instance = controller.cast_strategy(name, strat)
            theirs = jax_controller.cast_strategy(name, jax_strat)
            assert instance.strategy_type() == theirs.strategy_type() == name
            assert type(instance).__module__.rsplit(".", 1)[1] == type(theirs).__module__.rsplit(".", 1)[1]
            assert instance.rules[0].metricname == "m"

    def test_unknown_type_raises(self):
        with pytest.raises(controller.InvalidStrategyError, match="invalid strategy type"):
            controller.cast_strategy("labeling-v2", v1alpha1.TASPolicyStrategy())


class TestControllerLive:
    def test_add_policy_via_watch(self):
        twins = Twins()
        twins.run()
        twins.crd("create_taspolicy", POLICY)
        strategies, refcounts, policies = twins.settle(
            lambda s: has_policy(s, "demo-policy") and len(s.enforcer.registered_strategies["deschedule"]) == 1
        )
        assert set(refcounts) == {"memory", "cpu"} and refcounts["memory"] == 2
        assert policies == ["policies/default/demo-policy"]
        assert [name for name, _rules in strategies["scheduleonmetric"]] == ["demo-policy"]

    def test_update_policy_reregisters(self):
        twins = Twins()
        twins.run()
        twins.crd("create_taspolicy", POLICY)
        twins.settle(lambda s: has_policy(s, "demo-policy"))
        updated = make_policy(
            "demo-policy",
            strategies={
                "dontschedule": [rule("disk", "GreaterThan", 70)],
                "deschedule": [rule("memory", "GreaterThan", 95)],
                "scheduleonmetric": [rule("cpu", "LessThan", 0)],
            },
        )
        updated["metadata"]["resourceVersion"] = "2"
        twins.crd("update_taspolicy", updated)
        strategies, refcounts, _ = twins.settle(lambda s: has_policy(s, "demo-policy", 95))
        assert "disk" in refcounts
        assert strategies["deschedule"] == [("demo-policy", [("memory", "GreaterThan", 95)])]

    def test_delete_policy_cleans_up(self):
        twins = Twins()
        twins.run()
        twins.crd("create_taspolicy", POLICY)
        twins.settle(lambda s: has_policy(s, "demo-policy"))
        twins.crd("delete_taspolicy", "default", "demo-policy")
        strategies, refcounts, policies = twins.settle(lambda s: not has_policy(s, "demo-policy"))
        assert strategies["deschedule"] == [] and policies == []
        assert twins.port.cache.registered_metric_names() == []

    def test_policies_present_before_start_are_replayed(self):
        twins = Twins()
        twins.crd("create_taspolicy", POLICY)
        twins.run()
        twins.settle(lambda s: has_policy(s, "demo-policy"))

    def test_invalid_strategy_type_stops_registration(self):
        twins = Twins()
        twins.run()
        bad = make_policy(
            "bad",
            strategies={
                "dontschedule": [rule("memory", "GreaterThan", 80)],
                "labeling": [rule("disk", "GreaterThan", 1)],
                "deschedule": [rule("memory", "GreaterThan", 90)],
            },
        )
        twins.crd("create_taspolicy", bad)
        twins.settle(lambda s: has_policy(s, "bad"))

    def test_mirror_follows_controller(self):
        side = Side(False, mirror=True)
        side.run()
        side.kube.create_taspolicy(dict(POLICY))
        assert wait_until(lambda: side.mirror.policy("default", "demo-policy") is not None)
        compiled = side.mirror.policy("default", "demo-policy")
        assert compiled.dontschedule is not None
        assert compiled.scheduleonmetric_metric == "cpu"


@pytest.mark.parametrize("seed", range(3))
def test_crd_churn_keeps_registries_equal(seed):
    """A seeded stream of creates, updates and deletes over four policies:
    after each event both controllers hold the same strategies (in the
    same order), refcounts and policies."""
    rng = np.random.default_rng(seed)
    twins = Twins()
    twins.run()
    live = {}
    for step in range(14):
        name = f"pol-{int(rng.integers(0, 4))}"
        target = int(rng.integers(1, 99))
        obj = make_policy(
            name,
            strategies={
                "deschedule": [rule(f"m{int(rng.integers(0, 3))}", "GreaterThan", target)],
                "dontschedule": [rule(f"m{int(rng.integers(0, 3))}", "LessThan", int(rng.integers(1, 99)))],
                "scheduleonmetric": [rule("m0", "GreaterThan", 0)],
            },
        )
        if name in live and rng.random() < 0.4:
            twins.crd("delete_taspolicy", "default", name)
            del live[name]
            twins.settle(lambda s, n=name: not has_policy(s, n))
        elif name in live:
            obj["metadata"]["resourceVersion"] = str(step + 100)
            twins.crd("update_taspolicy", obj)
            live[name] = target
            twins.settle(lambda s, n=name, t=target: has_policy(s, n, t))
        else:
            twins.crd("create_taspolicy", obj)
            live[name] = target
            twins.settle(lambda s, n=name, t=target: has_policy(s, n, t))


# -- the JAX tests/test_strategies.py deschedule cases, on twin stacks --------------------


class TestDescheduleEnforce:
    def setup(self, mirror=False, nodes=("node1", "node2")):
        twins = Twins(mirror=mirror, nodes=nodes)
        for side, mod, rule_cls in (
            (twins.jax, jax_deschedule, jax_v1alpha1.TASPolicyRule),
            (twins.port, deschedule, v1alpha1.TASPolicyRule),
        ):
            side.strategy = mod.Strategy(
                policy_name="deschedule-test", rules=[rule_cls("health_metric", "GreaterThan", 0)]
            )
            side.enforcer.add_strategy(side.strategy, "deschedule")
        for side in twins.sides:
            side.cache.write_metric("health_metric", None)
        return twins

    def test_enforce_labels_violating_node(self):
        twins = self.setup()
        twins.metric("health_metric", {"node1": "1", "node2": "0"})
        labels = twins.enforce()
        assert labels["node1"].get("deschedule-test") == "violating"
        assert "deschedule-test" not in labels["node2"]

    def test_enforce_relabels_recovered_node_null(self):
        twins = self.setup()
        twins.metric("health_metric", {"node1": "1", "node2": "0"})
        twins.enforce()
        twins.metric("health_metric", {"node1": "0", "node2": "0"})
        labels = twins.enforce()
        assert labels["node1"].get("deschedule-test") == "null"
        assert twins.port.kube.node_patches[-1] == (
            "node1",
            [
                {"op": "remove", "path": "/metadata/labels/deschedule-test"},
                {"op": "add", "path": "/metadata/labels/deschedule-test", "value": "null"},
            ],
        )

    def test_cleanup_removes_labels(self):
        twins = self.setup()
        twins.metric("health_metric", {"node1": "1", "node2": "0"})
        twins.enforce()
        for side in twins.sides:
            side.strategy.cleanup(side.enforcer, "deschedule-test")
        assert twins.port.kube.node_patches == twins.jax.kube.node_patches
        assert "deschedule-test" not in twins.port.labels()["node1"]

    def test_enforce_returns_actual_violation_count(self):
        twins = self.setup(nodes=("node1", "node2", "node3"))
        for values, want in (
            ({"node1": "1", "node2": "0", "node3": "0"}, 1),
            ({"node1": "1", "node2": "1", "node3": "0"}, 2),
            ({"node1": "0", "node2": "0", "node3": "0"}, 0),
        ):
            twins.metric("health_metric", values)
            got = [side.strategy.enforce(side.enforcer, side.cache) for side in twins.sides]
            assert got == [want, want]

    def test_enforce_publishes_violations_each_cycle(self):
        twins = self.setup()
        seen = {True: [], False: []}
        for side in twins.sides:
            side.enforcer.violation_observers.append(lambda st, v, s=side: seen[s.jax].append((st, v)))
        for values in ({"node1": "1", "node2": "0"}, {"node1": "0", "node2": "0"}):
            twins.metric("health_metric", values)
            for side in twins.sides:
                side.strategy.enforce(side.enforcer, side.cache)
        assert seen[False] == seen[True] == [("deschedule", {"node1": ["deschedule-test"]}), ("deschedule", {})]

    def test_periodic_enforcement_loop(self):
        twins = self.setup()
        twins.metric("health_metric", {"node1": "1", "node2": "0"})
        side = twins.port
        stop = side.enforcer.start_enforcing(side.cache, 0.02)
        try:
            assert wait_until(lambda: side.labels()["node1"].get("deschedule-test") == "violating", 5)
        finally:
            stop.set()

    def test_removal_waits_for_the_pass_in_flight(self):
        """A policy removed while an enforcement pass is patching its
        violators is cleaned up after that pass, so no ``=violating``
        label outlives the policy.  (The JAX enforcer runs the cleanup
        at once, and the pass then re-labels the node: ROADMAP §C.)"""
        twins = self.setup()
        twins.metric("health_metric", {"node1": "1", "node2": "0"})
        side = twins.port
        patching, release = threading.Event(), threading.Event()
        patch_node = side.kube.patch_node

        def held_patch(name, payload):
            patching.set()
            assert release.wait(10)
            return patch_node(name, payload)

        side.kube.patch_node = held_patch
        passes = threading.Thread(target=side.enforcer.enforce_strategy, args=("deschedule", side.cache))
        passes.start()
        assert patching.wait(10)
        side.kube.patch_node = patch_node
        removal = threading.Thread(target=side.enforcer.remove_strategy, args=(side.strategy, "deschedule"))
        removal.start()
        removal.join(0.2)
        assert removal.is_alive()  # waiting for the pass
        release.set()
        passes.join(10)
        removal.join(10)
        assert side.enforcer.registered_strategies["deschedule"] == {}
        assert "deschedule-test" not in side.labels()["node1"]

    def test_registry_dedup_and_remove(self):
        for mod, core_mod, rule_cls in (
            (deschedule, core, v1alpha1.TASPolicyRule),
            (jax_deschedule, jax_core, jax_v1alpha1.TASPolicyRule),
        ):
            enforcer = core_mod.MetricEnforcer()
            strategy = mod.Strategy(policy_name="p1", rules=[rule_cls("m", "GreaterThan", 1)])
            enforcer.register_strategy_type(strategy)
            enforcer.add_strategy(strategy, "deschedule")
            enforcer.add_strategy(mod.Strategy(policy_name="p1", rules=[rule_cls("m", "GreaterThan", 1)]), "deschedule")
            assert len(enforcer.registered_strategies["deschedule"]) == 1
            enforcer.add_strategy(strategy, "dontschedule")  # type never registered
            assert "dontschedule" not in enforcer.registered_strategies
            enforcer.remove_strategy(strategy, "deschedule")
            assert enforcer.registered_strategies["deschedule"] == {}
            # empty rule lists are never equal (the reference's quirk)
            assert not mod.Strategy(policy_name="x").equals(mod.Strategy(policy_name="x"))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mirror", [False, True], ids=["host", "cpu-mirror"])
def test_multi_policy_enforcement_patch_sequence(seed, mirror):
    """Three policies with two rules each over 40 nodes and four cycles of
    seeded values: every patch, in order, and every label equal; with a
    mirror the port's enforcer evaluates on it and never falls back."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:02d}" for i in range(40)]
    twins = Twins(mirror=mirror, nodes=nodes)
    twins.run()
    for k in range(3):
        twins.crd(
            "create_taspolicy",
            make_policy(
                f"pol-{k}",
                strategies={
                    "deschedule": [rule(f"m{k}", "GreaterThan", 70), rule(f"m{(k + 1) % 3}", "LessThan", 5)],
                    "scheduleonmetric": [rule(f"m{k}", "GreaterThan", 0)],
                },
            ),
        )
    twins.settle(lambda s: len(s.enforcer.registered_strategies["deschedule"]) == 3)
    fallbacks = trace.COUNTERS.get("pas_deschedule_host_fallback_total")
    calls = rule_ops.violated_nodes.CALLS
    for _cycle in range(4):
        for j in range(3):
            values = rng.integers(0, 100, size=len(nodes))
            twins.metric(f"m{j}", {n: int(v) for n, v in zip(nodes, values) if rng.random() > 0.1})
        twins.enforce()
    assert trace.COUNTERS.get("pas_deschedule_host_fallback_total") == fallbacks
    # each enforce of a type evaluates every registered policy once per
    # registered strategy of that type (the reference's loop)
    assert rule_ops.violated_nodes.CALLS - calls == (4 * 3 * 3 if mirror else 0)
    labels = twins.port.labels()
    assert any(v.get("pol-0") == "null" for v in labels.values())
    for k in range(3):
        twins.crd("delete_taspolicy", "default", f"pol-{k}")
    twins.settle(lambda s: not s.enforcer.registered_strategies["deschedule"])
    assert twins.port.kube.node_patches == twins.jax.kube.node_patches
    assert twins.port.labels() == twins.jax.labels()
    assert not any(k.startswith("pol-") and v == "violating" for lab in twins.port.labels().values() for k, v in lab.items())


# -- violated_device against violated -----------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_violated_device_matches_host(seed):
    rng = np.random.default_rng(seed)
    nodes = [f"node-{i}" for i in range(57)]
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    jax_cache = JaxCache()
    jax_mirror = JaxMirror()
    jax_mirror.attach(jax_cache)
    ops = ["GreaterThan", "LessThan", "Equals"]
    rules = [rule(f"m{j}", str(rng.choice(ops)), int(rng.integers(0, 100))) for j in range(3)]
    obj = make_policy("pol", strategies={"deschedule": rules})
    cache.write_policy("default", "pol", v1alpha1.TASPolicy.from_obj(obj))
    jax_cache.write_policy("default", "pol", jax_v1alpha1.TASPolicy.from_obj(obj))
    for j in range(3):
        values = {n: int(v) for n, v in zip(nodes, rng.integers(0, 100, size=len(nodes))) if rng.random() > 0.2}
        cache.write_metric(f"m{j}", {n: NodeMetric(value=Quantity(str(v))) for n, v in values.items()})
        jax_cache.write_metric(f"m{j}", {n: JaxNodeMetric(value=JaxQuantity(str(v))) for n, v in values.items()})
    strategy = deschedule.Strategy("pol", [v1alpha1.TASPolicyRule.from_obj(r) for r in rules])
    jax_strategy = jax_deschedule.Strategy("pol", [jax_v1alpha1.TASPolicyRule.from_obj(r) for r in rules])
    calls = rule_ops.violated_nodes.CALLS
    on_device = strategy.violated_device(mirror)
    assert rule_ops.violated_nodes.CALLS == calls + 1
    assert on_device is not None
    assert set(on_device) == set(strategy.violated(cache))
    assert list(on_device) == list(jax_strategy.violated_device(jax_mirror))


def test_violated_device_defers_to_the_host():
    """Unknown policy, or rules that differ from the mirror's compiled
    ones: None (the host path), with no evaluation on the mirror."""
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    obj = make_policy("pol", strategies={"deschedule": [rule("m", "GreaterThan", 5)]})
    cache.write_policy("default", "pol", v1alpha1.TASPolicy.from_obj(obj))
    cache.write_metric("m", {"a": NodeMetric(value=Quantity("9"))})
    calls = rule_ops.violated_nodes.CALLS
    stale = deschedule.Strategy("pol", [v1alpha1.TASPolicyRule("m", "GreaterThan", 6)])
    assert stale.violated_device(mirror) is None
    assert deschedule.Strategy("ghost", list(stale.rules)).violated_device(mirror) is None
    assert rule_ops.violated_nodes.CALLS == calls
    assert deschedule.Strategy("pol", [v1alpha1.TASPolicyRule("m", "GreaterThan", 5)]).violated_device(
        mirror
    ) == {"a": None}
    assert mirror.policy_with_view_by_name("ghost") == (None, None)


def test_update_during_a_pass_keeps_the_device_path():
    """A policy update that lands while an enforcement pass runs waits for
    the pass, so none of its cycles sets the old strategy against the new
    compiled policy (a host fallback), and the next pass follows the
    update on the mirror.  (The JAX controller writes the new policy
    into the cache at once: ROADMAP §C.)"""
    side = Side(False, mirror=True, nodes=("node1", "node2"))
    objs = {name: make_policy(name, strategies={"deschedule": [rule("health", "GreaterThan", 5)]}) for name in ("pa", "pb")}
    for obj in objs.values():
        side.controller.on_add(v1alpha1.TASPolicy.from_obj(obj))
    side.metric("health", {"node1": "9", "node2": "1"})
    patching, release = threading.Event(), threading.Event()
    patch_node = side.kube.patch_node

    def held_patch(name, payload):
        patching.set()
        assert release.wait(10)
        return patch_node(name, payload)

    side.kube.patch_node = held_patch
    fallbacks = trace.COUNTERS.get("pas_deschedule_host_fallback_total")
    passes = threading.Thread(target=side.enforcer.enforce_strategy, args=("deschedule", side.cache))
    passes.start()
    assert patching.wait(10)
    side.kube.patch_node = patch_node
    updated = json.loads(json.dumps(objs["pa"]))
    updated["spec"]["strategies"]["deschedule"]["rules"][0]["target"] = 0
    update = threading.Thread(
        target=side.controller.on_update,
        args=(v1alpha1.TASPolicy.from_obj(objs["pa"]), v1alpha1.TASPolicy.from_obj(updated)),
    )
    update.start()
    update.join(0.2)
    assert update.is_alive()  # waiting for the pass
    release.set()
    passes.join(10)
    update.join(10)
    side.enforcer.enforce_strategy("deschedule", side.cache)
    assert trace.COUNTERS.get("pas_deschedule_host_fallback_total") == fallbacks
    assert {n: lab.get("pa") for n, lab in side.labels().items()} == {"node1": "violating", "node2": "violating"}


def test_dontschedule_and_scheduleonmetric_enforce_nothing():
    kube = FakeKubeClient()
    kube.add_node(make_node("n").raw)
    enforcer = core.MetricEnforcer(kube)
    for mod in (scheduleonmetric, dontschedule):
        strategy = mod.Strategy(policy_name="p", rules=[v1alpha1.TASPolicyRule("m", "GreaterThan", 1)])
        enforcer.register_strategy_type(strategy)
        enforcer.add_strategy(strategy, mod.STRATEGY_TYPE)
        assert strategy.enforce(enforcer, AutoUpdatingCache()) == 0
        strategy.cleanup(enforcer, "p")
        enforcer.enforce_strategy(mod.STRATEGY_TYPE, AutoUpdatingCache())
        assert isinstance(strategy, core.Enforceable) and isinstance(strategy, core.StrategyInterface)
        strategy.set_policy_name("q")
        assert strategy.get_policy_name() == "q"
    assert kube.node_patches == []
    with pytest.raises(CacheMissError):
        AutoUpdatingCache().read_policy("default", "p")
