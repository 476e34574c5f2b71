"""The slice as a whole: the same policies, metrics, node allocatables and
pods go into the JAX stack (AutoUpdatingCache + TensorStateMirror +
BatchPlanner) and into the port's on the CPU.  Both replan, and every
plan must match exactly."""

import numpy as np
import pytest

from platform_aware_scheduling_tpu.kube.objects import Node as JaxNode
from platform_aware_scheduling_tpu.kube.objects import Pod as JaxPod
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.planner import BatchPlanner as JaxPlanner
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicy as JaxPolicy
from platform_aware_scheduling_tpu.testing.builders import make_node, make_policy, make_pod, rule
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity


class Twin:
    """One JAX stack and one port stack, fed the same events."""

    def __init__(self, node_capacity=1, solver="greedy"):
        self.jax_cache = JaxCache()
        self.jax_mirror = JaxMirror()
        self.jax_mirror.attach(self.jax_cache)
        self.jax = JaxPlanner(self.jax_cache, self.jax_mirror, node_capacity=node_capacity, solver=solver)
        self.cache = AutoUpdatingCache()
        self.mirror = TensorStateMirror(device="cpu")
        self.mirror.attach(self.cache)
        self.port = BatchPlanner(
            self.cache, self.mirror, node_capacity=node_capacity, solver=solver, device="cpu"
        )

    def policy(self, name, strategies, namespace="default"):
        obj = make_policy(name, namespace=namespace, strategies=strategies)
        self.jax_cache.write_policy(namespace, name, JaxPolicy.from_obj(obj))
        self.cache.write_policy(namespace, name, TASPolicy.from_obj(obj))

    def metric(self, name, values):
        self.jax_cache.write_metric(
            name, {n: JaxNodeMetric(value=JaxQuantity(str(v))) for n, v in values.items()}
        )
        self.cache.write_metric(
            name, {n: NodeMetric(value=Quantity(str(v))) for n, v in values.items()}
        )

    def delete_metric(self, name):
        self.jax_cache.delete_metric(name)
        self.cache.delete_metric(name)

    def node(self, name, **allocatable):
        raw = make_node(name, allocatable=allocatable).raw
        self.jax.node_changed(JaxNode(raw))
        self.port.node_changed(Node(raw))

    def observe(self, pod_raw, deleted=False):
        self.jax.pod_observed(JaxPod(pod_raw), deleted=deleted)
        self.port.pod_observed(Pod(pod_raw), deleted=deleted)

    def add(self, pod_raw):
        self.jax.pod_added(JaxPod(pod_raw))
        self.port.pod_added(Pod(pod_raw))

    def bound(self, pod_raw):
        self.jax.pod_bound(JaxPod(pod_raw))
        self.port.pod_bound(Pod(pod_raw))

    def replan(self):
        planned = self.port.replan()
        assert planned == self.jax.replan()
        return planned

    def planned(self, pod_raw):
        got = self.port.planned_node(Pod(pod_raw))
        assert got == self.jax.planned_node(JaxPod(pod_raw))
        return got

    def plans_match(self, pod_raws):
        return {p["metadata"]["name"]: self.planned(p) for p in pod_raws}


def pending(name, policy="plan-pol", namespace="default"):
    return make_pod(name, namespace=namespace, labels={"telemetry-policy": policy}).raw


def built(node_capacity=1):
    """The JAX planner tests' fixture, on both stacks."""
    twin = Twin(node_capacity=node_capacity)
    twin.policy(
        "plan-pol",
        {
            "scheduleonmetric": [rule("m", "GreaterThan", 0)],
            "dontschedule": [rule("m", "GreaterThan", 900)],
        },
    )
    twin.metric("m", {"n1": 100, "n2": 50, "n3": 10})
    return twin


class TestReplan:
    def test_capacity_one_spreads_pods(self):
        twin = built(node_capacity=1)
        pods = [pending(f"p{i}") for i in range(3)]
        for pod in pods:
            twin.add(pod)
        assert twin.replan() == 3
        assert twin.plans_match(pods) == {"p0": "n1", "p1": "n2", "p2": "n3"}

    def test_dontschedule_respected(self):
        twin = built(node_capacity=5)
        twin.metric("m", {"n1": 1000, "n2": 50, "n3": 10})
        twin.add(pending("p0"))
        twin.replan()
        assert twin.planned(pending("p0")) == "n2"

    def test_bound_pod_leaves_plan(self):
        twin = built()
        twin.add(pending("p0"))
        twin.replan()
        assert twin.planned(pending("p0")) == "n1"
        twin.bound(pending("p0"))
        assert twin.planned(pending("p0")) is None

    def test_stale_plan_invalidated_by_state_change(self):
        twin = built()
        twin.add(pending("p0"))
        twin.replan()
        assert twin.planned(pending("p0")) == "n1"
        twin.metric("m", {"n1": 1, "n2": 50, "n3": 10})
        assert twin.planned(pending("p0")) is None
        twin.replan()
        assert twin.planned(pending("p0")) == "n2"

    def test_unlabelled_or_bound_pods_ignored(self):
        twin = built()
        twin.add(make_pod("nolabel").raw)
        twin.add(make_pod("bound", labels={"telemetry-policy": "x"}, node_name="n1").raw)
        assert twin.port.pending_count() == twin.jax.pending_count() == 0

    def test_empty_pending_set_clears_plan(self):
        twin = built()
        twin.add(pending("p0"))
        twin.replan()
        twin.bound(pending("p0"))
        assert twin.port.solve_inputs() is None
        assert twin.replan() == 0

    def test_solve_inputs_are_what_replan_solves(self):
        from platform_aware_scheduling_tpu_torch.models.batch_scheduler import scheduling_step

        twin = built(node_capacity=1)
        pods = [pending(f"p{i}") for i in range(3)]
        for pod in pods:
            twin.add(pod)
        inputs = twin.port.solve_inputs()
        assert inputs.keys == [f"default&p{i}" for i in range(3)]
        assert inputs.state.metric_values.shape[1] == inputs.view.node_capacity == 64
        assert inputs.pods.candidates[:, :3].all() and not inputs.pods.candidates[:, 3:].any()
        assigned = scheduling_step(inputs.state, inputs.pods).assignment.node_for_pod
        twin.replan()
        names = [inputs.view.node_names[i] for i in assigned.tolist()]
        assert names == [twin.planned(pod) for pod in pods]


class TestCapacityFidelity:
    def test_full_node_stops_receiving_assignments(self):
        twin = built(node_capacity=5)
        twin.node("n1", pods="2")
        twin.observe(make_pod("b0", node_name="n1").raw)
        twin.observe(make_pod("b1", node_name="n1").raw)
        twin.add(pending("p0"))
        assert twin.replan() == 1
        assert twin.planned(pending("p0")) == "n2"

    def test_terminated_pod_frees_its_slot(self):
        twin = built(node_capacity=5)
        twin.node("n1", pods="1")
        twin.observe(make_pod("b0", node_name="n1").raw)
        twin.add(pending("p0"))
        twin.replan()
        assert twin.planned(pending("p0")) == "n2"
        twin.observe(make_pod("b0", node_name="n1", phase="Succeeded").raw)
        twin.replan()
        assert twin.planned(pending("p0")) == "n1"

    def test_unobserved_nodes_fall_back_to_default(self):
        twin = built(node_capacity=1)
        for i in range(3):
            twin.add(pending(f"p{i}"))
        assert twin.replan() == 3

    def test_deleted_node_and_pod_fall_back(self):
        twin = built(node_capacity=5)
        twin.node("n1", pods="0")
        twin.add(pending("p0"))
        twin.replan()
        assert twin.planned(pending("p0")) == "n2"
        twin.jax.node_changed(JaxNode(make_node("n1").raw), deleted=True)
        twin.port.node_changed(Node(make_node("n1").raw), deleted=True)
        twin.replan()
        assert twin.planned(pending("p0")) == "n1"


class TestPolicies:
    def test_host_only_metric_skipped(self):
        """An inexact value (sub-milli) makes the metric host-only: pods
        scheduling on it are left to the per-request path."""
        twin = built(node_capacity=5)
        twin.metric("m", {"n1": "0.0001", "n2": 50, "n3": 10})
        twin.add(pending("p0"))
        assert twin.replan() == 0
        assert twin.planned(pending("p0")) is None

    def test_unknown_operator_dontschedule_ignored(self):
        twin = Twin(node_capacity=5)
        twin.policy(
            "odd",
            {
                "scheduleonmetric": [rule("m", "LessThan", 0)],
                "dontschedule": [rule("m", "Between", 5)],
            },
        )
        twin.metric("m", {"a": 3, "b": 1, "c": 2})
        twin.add(pending("p0", policy="odd"))
        twin.replan()
        assert twin.planned(pending("p0", policy="odd")) == "b"

    def test_metric_delete_and_row_reuse(self):
        twin = Twin(node_capacity=5)
        twin.policy("first", {"scheduleonmetric": [rule("x", "GreaterThan", 0)]})
        twin.policy("second", {"scheduleonmetric": [rule("y", "LessThan", 0)]})
        twin.metric("x", {"a": 1, "b": 9})
        twin.metric("y", {"a": 1, "b": 9})
        twin.add(pending("p0", policy="first"))
        twin.add(pending("p1", policy="second"))
        twin.replan()
        assert twin.plans_match([pending("p0", "first"), pending("p1", "second")]) == {
            "p0": "b",
            "p1": "a",
        }
        twin.jax_cache.write_metric("x")  # refcount 1, as a controller would
        twin.cache.write_metric("x")
        twin.delete_metric("x")
        twin.metric("z", {"a": 5, "b": 2})
        twin.replan()
        twin.plans_match([pending("p0", "first"), pending("p1", "second")])


class TestSinkhornPlanner:
    def test_sinkhorn_solver_coordinates(self):
        """The JAX planner test's case: two pods, capacity one, n1 a shade
        better than n2; both packages place one pod on each."""
        twin = Twin(node_capacity=1, solver="sinkhorn")
        twin.policy("plan-pol", {"scheduleonmetric": [rule("m", "GreaterThan", 0)]})
        twin.metric("m", {"n1": 100, "n2": 99})
        pods = [pending("p0"), pending("p1")]
        for pod in pods:
            twin.add(pod)
        assert twin.replan() == 2
        assert set(twin.plans_match(pods).values()) == {"n1", "n2"}

    def test_unknown_solver_refused(self):
        cache = AutoUpdatingCache()
        mirror = TensorStateMirror(device="cpu")
        with pytest.raises(ValueError, match="not one of greedy, sinkhorn"):
            BatchPlanner(cache, mirror, solver="auction", device="cpu")

    @pytest.mark.parametrize("seed", range(2))
    def test_seeded_world(self, seed):
        """The seeded world below with the Sinkhorn solver: every plan
        equal to the JAX planner's."""
        _seeded_world(seed, solver="sinkhorn")


@pytest.mark.parametrize("seed", range(2))
def test_seeded_cluster_with_churn(seed):
    """A few hundred nodes and pods over four policies, with metric churn,
    bound pods and allocatables across several replans."""
    _seeded_world(seed)


def _seeded_world(seed, solver="greedy"):
    rng = np.random.default_rng(seed)
    nodes = [f"node-{i:03d}" for i in range(int(rng.integers(200, 320)))]
    metrics = [f"metric{j}" for j in range(5)]
    twin = Twin(solver=solver)
    ops = ["LessThan", "GreaterThan"]
    for k in range(4):
        dont = [rule(metrics[(k + 1) % 5], ops[k % 2], int(rng.integers(200, 800)))]
        if k % 2:
            dont.append(rule(metrics[(k + 3) % 5], "GreaterThan", int(rng.integers(600, 990))))
        twin.policy(
            f"pol-{k}",
            {
                "scheduleonmetric": [rule(metrics[k], ops[(k + 1) % 2], 0)],
                "dontschedule": dont,
            },
            namespace=f"ns{k % 2}",
        )
    for name in nodes[: len(nodes) // 2]:
        twin.node(name, pods=str(int(rng.integers(0, 4))))
    for i, name in enumerate(nodes[::7]):
        twin.observe(make_pod(f"bound-{i}", node_name=name).raw)
    pods = [
        pending(f"pod-{i}", policy=f"pol-{i % 4}", namespace=f"ns{(i % 4) % 2}")
        for i in range(int(rng.integers(150, 300)))
    ]
    for pod in pods:
        twin.add(pod)
    values = {m: rng.integers(0, 1000, size=len(nodes)) for m in metrics}
    for sync in range(4):
        for m in metrics:
            churn = rng.random(len(nodes)) < 0.3
            values[m] = np.where(churn, rng.integers(0, 1000, size=len(nodes)), values[m])
            present = rng.random(len(nodes)) > 0.03
            twin.metric(
                m, {n: f"{int(v)}m" if v % 3 else int(v) for n, v, ok in zip(nodes, values[m], present) if ok}
            )
        planned = twin.replan()
        assert planned > 0
        plan = twin.plans_match(pods)
        assert sum(node is not None for node in plan.values()) == planned
        for pod in pods[sync * 10 : sync * 10 + 5]:
            twin.bound(pod)
