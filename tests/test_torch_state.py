"""The port's cache + tensor mirror held against the JAX package's on the CPU:
the same sequence of policy and metric writes and deletes goes into both,
and the published views, versions, compiled policies and host-only marks
must agree exactly."""

import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import DummyMetricsClient as JaxClient
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicy as JaxPolicy
from platform_aware_scheduling_tpu.testing.builders import make_policy, rule
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache, CacheMissError
from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient, NodeMetric
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity


class Pair:
    def __init__(self, node_capacity=4, metric_capacity=2):
        self.jax_cache = JaxCache()
        self.jax = JaxMirror(node_capacity=node_capacity, metric_capacity=metric_capacity)
        self.jax.attach(self.jax_cache)
        self.cache = AutoUpdatingCache()
        self.port = TensorStateMirror(
            node_capacity=node_capacity, metric_capacity=metric_capacity, device="cpu"
        )
        self.port.attach(self.cache)

    def metric(self, name, values=None):
        if values is None:
            self.jax_cache.write_metric(name)
            self.cache.write_metric(name)
            return
        self.jax_cache.write_metric(
            name, {n: JaxNodeMetric(value=JaxQuantity(str(v))) for n, v in values.items()}
        )
        self.cache.write_metric(
            name, {n: NodeMetric(value=Quantity(str(v))) for n, v in values.items()}
        )

    def policy(self, name, strategies):
        obj = make_policy(name, strategies=strategies)
        self.jax_cache.write_policy("default", name, JaxPolicy.from_obj(obj))
        self.cache.write_policy("default", name, TASPolicy.from_obj(obj))

    def delete_policy(self, name):
        self.jax_cache.delete_policy("default", name)
        self.cache.delete_policy("default", name)

    def delete_metric(self, name):
        self.jax_cache.delete_metric(name)
        self.cache.delete_metric(name)

    def agree(self):
        want, got = self.jax.device_view(), self.port.device_view()
        assert got.version == want.version == self.port.version == self.jax.version
        assert got.node_names == want.node_names
        assert got.node_index == want.node_index
        assert got.values.dtype == torch.int64
        np.testing.assert_array_equal(got.values.numpy(), jax_i64.to_int64_np(want.values))
        np.testing.assert_array_equal(got.present.numpy(), np.asarray(want.present))
        for key, compiled in self.jax._policies.items():
            ours = self.port.policy(*key)
            for field in ("scheduleonmetric_row", "scheduleonmetric_op", "scheduleonmetric_metric"):
                assert getattr(ours, field) == getattr(compiled, field)
            for strategy in ("dontschedule", "deschedule"):
                a, b = getattr(ours, strategy), getattr(compiled, strategy)
                assert (a is None) == (b is None)
                if a is None:
                    continue
                assert a.host_only == b.host_only and a.metric_names == b.metric_names
                for array in ("metric_rows", "op_ids", "targets", "active"):
                    np.testing.assert_array_equal(getattr(a, array), getattr(b, array))
        assert set(self.port._policies) == set(self.jax._policies)
        for name in set(self.jax._host_only_metrics) | set(self.port._host_only_metrics):
            assert self.port.metric_host_only(name) == self.jax.metric_host_only(name)
        return got


def test_writes_growth_and_memoized_view():
    pair = Pair()
    pair.metric("health", {"node1": "10", "node2": "3500m"})
    view = pair.agree()
    assert view.values[0, view.node_index["node2"]] == 3500
    assert pair.port.device_view() is view
    pair.metric("health", {f"n{i}": f"{i}Ki" for i in range(20)})
    grown = pair.agree()
    assert grown.node_capacity == 32 and grown is not view
    # the old snapshot is untouched (copy-on-write)
    assert view.values[0, view.node_index["node2"]] == 3500


def test_unchanged_rewrite_keeps_version():
    pair = Pair()
    pair.metric("m", {"a": 1, "b": 2})
    before = pair.port.version
    pair.metric("m", {"a": 1, "b": 2})
    pair.agree()
    assert pair.port.version == before


def test_policies_rows_and_reuse():
    pair = Pair()
    pair.policy(
        "p1",
        {
            "scheduleonmetric": [rule("x", "GreaterThan", 0)],
            "dontschedule": [rule("y", "LessThan", 5), rule("z", "Equals", 7)],
            "deschedule": [rule("y", "GreaterThan", 2**62)],
        },
    )
    pair.policy("p2", {"dontschedule": [rule("w", "Between", 1)]})
    for name in "xyzw":
        pair.metric(name)
        pair.metric(name, {"a": 1, "b": "0.0005"} if name == "w" else {"a": 3, "b": 4})
    pair.agree()
    assert pair.port.policy("default", "p2").dontschedule.host_only
    assert pair.port.policy("default", "p1").deschedule.host_only  # target overflows milli
    assert pair.port.metric_host_only("w")
    pair.delete_metric("z")
    pair.metric("v", {"c": 9})  # reuses z's freed row
    pair.agree()
    pair.delete_policy("p2")
    pair.agree()
    assert pair.port.policy("default", "p2") is None


def test_policies_with_view_is_one_snapshot():
    pair = Pair()
    pair.policy("p", {"scheduleonmetric": [rule("m", "LessThan", 0)]})
    pair.metric("m", {"a": "1.0001"})
    policies, view, host_only = pair.port.policies_with_view([("default", "p"), ("default", "q")])
    want = pair.jax.policies_with_view([("default", "p"), ("default", "q")])
    assert policies[("default", "q")] is None
    assert host_only == want[2] == frozenset({"m"})
    assert view is pair.port.device_view()


class TestCache:
    def test_refcounted_delete_and_nil_write(self):
        pair = Pair()
        pair.metric("m")
        pair.metric("m")
        pair.metric("m", {"a": 5})
        pair.metric("m")  # a nil write keeps the value and registers again
        assert pair.cache.read_metric("m")["a"].value == 5
        for _ in range(2):
            pair.delete_metric("m")
            assert pair.cache.read_metric("m")["a"].value == 5
        pair.delete_metric("m")
        with pytest.raises(CacheMissError):
            pair.cache.read_metric("m")
        assert pair.cache.registered_metric_names() == pair.jax_cache.registered_metric_names()
        pair.agree()

    def test_update_all_metrics_refreshes_and_counts_errors(self):
        pair = Pair()
        for name in ("good", "missing"):
            pair.metric(name)
        values = {"good": {"a": JaxNodeMetric(value=JaxQuantity("7"))}}
        pair.jax_cache.update_all_metrics(JaxClient(values))
        pair.cache.update_all_metrics(
            DummyMetricsClient({"good": {"a": NodeMetric(value=Quantity("7"))}})
        )
        pair.agree()
        assert pair.cache.counters.get("pas_telemetry_refresh_total") == 1
        assert (
            pair.cache.counters.get("pas_telemetry_refresh_errors_total", {"reason": "no_data"})
            == 1
        )


QUANTITY_TEXTS = [
    "0", "0m", "110", "12345m", "00012m", "99999m", "1000m", "9223372036854775807",
    "9223372036854775807m", "9223372036854775808m", "9223372036854776", "99999999999999999999m",
    "+5", "-5m", " 7", "7 ", "1.5", "0.001", "5k", "1Ki", "1e3", "12M", "3u", "m", "", "1.2.3", "١٢",
]


@pytest.mark.parametrize("text", QUANTITY_TEXTS)
def test_quantity_parse_matches_the_jax_quantity(text):
    """The plain-integer parse the mirror's refresh takes agrees with the
    general grammar and with the JAX package's Quantity: value, the
    fixed-point milli form the mirror stores, int64 view and text."""
    try:
        want = JaxQuantity(text)
    except ValueError:
        with pytest.raises(ValueError):
            Quantity(text)
        return
    got = Quantity(text)
    assert got.value == want.value
    assert got.milli_value_exact() == want.milli_value_exact()
    assert got.as_int64() == want.as_int64()
    assert str(got) == str(want)
    assert got.cmp_int64(97) == want.cmp_int64(97)
