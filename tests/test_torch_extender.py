"""The port's TAS extender (``tas/telemetryscheduler.py`` over
``tas/fastpath.py`` and ``ops/scoring.py``), held byte for byte against
the JAX package's.  The same cache writes and the same request bodies go
to both extenders; every response must carry the same status, headers
and body.  The JAX side runs its pure-Python wire path
(``PAS_TPU_NO_NATIVE=1``), the path the port serves."""

import json
import os

import numpy as np
import pytest

from platform_aware_scheduling_tpu.extender.server import HTTPRequest as JaxRequest
from platform_aware_scheduling_tpu.kube.objects import Node as JaxNode
from platform_aware_scheduling_tpu.kube.objects import Pod as JaxPod
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.planner import BatchPlanner as JaxPlanner
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicy as JaxPolicy
from platform_aware_scheduling_tpu.tas.telemetryscheduler import MetricsExtender as JaxExtender
from platform_aware_scheduling_tpu.testing.builders import make_node, make_policy, make_pod, rule
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
from platform_aware_scheduling_tpu_torch.kube.objects import Node, Pod
from platform_aware_scheduling_tpu_torch.ops import scoring
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
from platform_aware_scheduling_tpu_torch.utils import decisions, trace
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


class Stacks:
    """The JAX extender and the port's, fed the same cache writes."""

    def __init__(self, mirror=True, node_cache_capable=True, planner=False):
        self.jax_cache = JaxCache()
        self.cache = AutoUpdatingCache()
        jax_mirror = port_mirror = None
        if mirror:
            jax_mirror = JaxMirror()
            jax_mirror.attach(self.jax_cache)
            port_mirror = TensorStateMirror(device="cpu")
            port_mirror.attach(self.cache)
        self.jax_planner = self.planner = None
        if planner:
            self.jax_planner = JaxPlanner(self.jax_cache, jax_mirror, node_capacity=1)
            self.planner = BatchPlanner(self.cache, port_mirror, node_capacity=1, device="cpu")
        self.jax = JaxExtender(
            self.jax_cache, mirror=jax_mirror, planner=self.jax_planner,
            node_cache_capable=node_cache_capable,
        )
        self.port = MetricsExtender(
            self.cache, mirror=port_mirror, planner=self.planner,
            node_cache_capable=node_cache_capable,
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

    def post(self, verb, body):
        """The port's response, after checking it equals the JAX one."""
        headers = {"Content-Type": "application/json"}
        want = getattr(self.jax, verb)(JaxRequest("POST", f"/scheduler/{verb}", headers, body))
        got = getattr(self.port, verb)(HTTPRequest("POST", f"/scheduler/{verb}", headers, body))
        assert (got.status, got.headers, got.body) == (want.status, want.headers, want.body)
        return got


@pytest.fixture(autouse=True)
def _pure_python_wire(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")


def request_body(names, labels=None, nodes=True, namespace="default", pod="p"):
    """An extender Args body: Nodes mode with full node objects, or
    NodeNames mode."""
    metadata = {"name": pod, "namespace": namespace, "labels": labels or {}}
    body = {"Pod": {"metadata": metadata}}
    if nodes:
        body["Nodes"] = {
            "items": [
                {"metadata": {"name": n, "labels": {"zone": f"z{i % 3}"}},
                 "status": {"allocatable": {"pods": "110"}}}
                for i, n in enumerate(names)
            ]
        }
    else:
        body["NodeNames"] = list(names)
    return json.dumps(body).encode()


def policy_body(policy, names, nodes=True, **kw):
    return request_body(names, {"telemetry-policy": policy}, nodes=nodes, **kw)


# -- the golden fixtures ---------------------------------------------------------

GOLDEN_CASES = [
    (verb, req, f"{verb}_{mode}_response.golden")
    for verb in ("prioritize", "filter")
    for req, mode in (
        ("prioritize_request_upstream.json", "nodes"),
        ("prioritize_request_upstream_nodenames.json", "nodenames"),
        ("prioritize_request_reference_style.json", "nodes"),
        ("prioritize_request_reference_style_nodenames.json", "nodenames"),
    )
]


def read_fixture(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def golden_stacks():
    """The canned state of tests/golden/README.md on both stacks."""
    stacks = Stacks()
    stacks.policy(
        "golden-pol",
        {
            "scheduleonmetric": [rule("golden_metric", "GreaterThan", 0)],
            "dontschedule": [rule("golden_metric", "GreaterThan", 80)],
        },
    )
    stacks.metric("golden_metric", {"gw-a": 50, "gw-b": 90, "gw-c": 10, "gw-d": 70})
    return stacks


@pytest.mark.parametrize("verb,request_file,golden", GOLDEN_CASES)
def test_golden_fixture(verb, request_file, golden):
    got = golden_stacks().post(verb, read_fixture(request_file))
    assert got.status == 200
    assert got.body == read_fixture(golden)


# -- wire quirks -----------------------------------------------------------------

QUIRK_BODIES = {
    "empty": b"",
    "not_json": b"{not json",
    "json_array": b"[1, 2]",
    "pod_not_object": b'{"Pod": 5, "NodeNames": ["n1"]}',
    "no_candidates_field": b'{"Pod": {"metadata": {"name": "p", "labels": {"telemetry-policy": "pol"}}}}',
    "nodes_null": b'{"Pod": {"metadata": {"name": "p"}}, "Nodes": null}',
    "nodes_empty": policy_body("pol", []),
    "node_names_empty": policy_body("pol", [], nodes=False),
    "no_policy_label": request_body(["n1", "n2", "n3"]),
    "no_policy_label_names": request_body(["n1", "n2"], nodes=False),
    "unknown_policy": policy_body("nope", ["n1", "n2"]),
    "other_namespace": policy_body("pol", ["n1", "n2"], namespace="elsewhere"),
    "no_scheduleonmetric": policy_body("filter-only", ["n1", "n2", "n3"]),
    "no_dontschedule": policy_body("rank-only", ["n1", "n2", "n3"], nodes=False),
    "metric_never_written": policy_body("absent", ["n1", "n2"]),
    "unknown_nodes": policy_body("pol", ["x1", "n2", "x2"], nodes=False),
    "lowercase_keys": json.dumps(
        {"pod": {"metadata": {"name": "p", "labels": {"telemetry-policy": "pol"}}},
         "nodenames": ["n3", "n1"]}
    ).encode(),
}


def quirk_stacks(node_cache_capable=True):
    stacks = Stacks(node_cache_capable=node_cache_capable)
    stacks.policy(
        "pol",
        {
            "scheduleonmetric": [rule("m", "LessThan", 0)],
            "dontschedule": [rule("m", "GreaterThan", 60)],
        },
    )
    stacks.policy("filter-only", {"dontschedule": [rule("m", "LessThan", 20)]})
    stacks.policy("rank-only", {"scheduleonmetric": [rule("m", "GreaterThan", 0)]})
    stacks.policy(
        "absent",
        {
            "scheduleonmetric": [rule("never", "GreaterThan", 0)],
            "dontschedule": [rule("never", "GreaterThan", 0)],
        },
    )
    stacks.metric("m", {"n1": 10, "n2": 70, "n3": 40})
    return stacks


@pytest.mark.parametrize("verb", ["prioritize", "filter"])
@pytest.mark.parametrize("quirk", sorted(QUIRK_BODIES))
def test_wire_quirk(verb, quirk):
    quirk_stacks().post(verb, QUIRK_BODIES[quirk])


@pytest.mark.parametrize("verb", ["prioritize", "filter"])
def test_node_names_ignored_without_node_cache_capable(verb):
    got = quirk_stacks(node_cache_capable=False).post(
        verb, policy_body("pol", ["n1", "n2"], nodes=False)
    )
    assert (got.status, got.body) == (200, b"")


def test_quirk_responses_are_the_reference_ones():
    """The documented quirks, spelled out once on the port alone."""
    stacks = quirk_stacks()
    assert stacks.post("prioritize", QUIRK_BODIES["empty"]).body == b""
    unlabelled = stacks.post("prioritize", QUIRK_BODIES["no_policy_label"])
    assert (unlabelled.status, unlabelled.body) == (400, b"[]\n")
    missing = stacks.post("filter", QUIRK_BODIES["unknown_policy"])
    assert (missing.status, missing.body) == (404, b"null\n")
    legacy = json.loads(stacks.post("filter", policy_body("pol", ["n1", "n2", "n3"])).body)
    assert legacy["NodeNames"] == ["n1", "n3", ""]
    cache_capable = json.loads(stacks.post("filter", policy_body("pol", ["n1", "n2"], nodes=False)).body)
    assert cache_capable["NodeNames"] == ["n1"] and cache_capable["Nodes"] is None


BIND_BODIES = {
    "empty": b"",
    "garbage": b"{oops",
    "upstream": read_fixture("bind_request_upstream.json"),
    "reference": b'{"PodName": "p", "PodNamespace": "default", "PodUID": "u", "Node": "n1"}',
    "no_node": b'{"PodName": "p", "PodNamespace": "default"}',
}


@pytest.mark.parametrize("body", sorted(BIND_BODIES))
def test_bind_is_404(body):
    got = quirk_stacks().post("bind", BIND_BODIES[body])
    assert (got.status, got.body) == (404, b"")


# -- random states in both wire modes -------------------------------------------


def random_state(seed, n=40):
    rng = np.random.default_rng(seed)
    names = [f"node-{i:03d}" for i in range(n)]
    values = {
        metric: {name: int(rng.integers(-30, 100)) for name in names if rng.random() > 0.15}
        for metric in ("cpu", "mem", "net")
    }
    return rng, names, values


@pytest.mark.parametrize("nodes", [True, False], ids=["nodes", "node_names"])
@pytest.mark.parametrize("operator", ["GreaterThan", "LessThan", "Equals"])
@pytest.mark.parametrize("seed", range(2))
def test_prioritize_random_state(seed, operator, nodes):
    rng, names, values = random_state(seed)
    stacks = Stacks()
    stacks.policy("pol", {"scheduleonmetric": [rule("cpu", operator, 0)]})
    for metric, vals in values.items():
        stacks.metric(metric, vals)
    # candidates: a shuffled subset plus names the mirror has never seen
    candidates = list(rng.permutation(names)[:30]) + ["stranger-1", "stranger-2"]
    got = stacks.post("prioritize", policy_body("pol", candidates, nodes=nodes))
    scores = [entry["Score"] for entry in json.loads(got.body)]
    assert scores == list(range(10, 10 - len(scores), -1)) and min(scores) < 0


@pytest.mark.parametrize("nodes", [True, False], ids=["nodes", "node_names"])
@pytest.mark.parametrize("seed", range(3))
def test_filter_random_state(seed, nodes):
    rng, names, values = random_state(seed)
    stacks = Stacks()
    stacks.policy(
        "pol",
        {
            "dontschedule": [
                rule("cpu", "GreaterThan", 60),
                rule("mem", "LessThan", 0),
                rule("net", "Equals", int(rng.integers(-30, 100))),
            ]
        },
    )
    for metric, vals in values.items():
        stacks.metric(metric, vals)
    candidates = list(rng.permutation(names)) + ["stranger"]
    got = stacks.post("filter", policy_body("pol", candidates, nodes=nodes))
    assert json.loads(got.body)["FailedNodes"]


def test_state_changes_between_requests():
    """Churn, a metric delete and a policy rewrite between requests: each
    answer must follow the current state on both stacks."""
    rng, names, values = random_state(7)
    stacks = Stacks()
    strategies = {
        "scheduleonmetric": [rule("cpu", "GreaterThan", 0)],
        "dontschedule": [rule("mem", "GreaterThan", 50)],
    }
    stacks.policy("pol", strategies)
    for metric, vals in values.items():
        stacks.metric(metric, vals)
    body = policy_body("pol", names, nodes=False)
    for _ in range(3):
        for verb in ("prioritize", "filter"):
            stacks.post(verb, body)
        churned = {n: v + int(rng.integers(-5, 6)) for n, v in values["cpu"].items()}
        stacks.metric("cpu", churned)
        stacks.metric("mem", {n: int(rng.integers(0, 100)) for n in names[:30]})
    stacks.delete_metric("mem")
    stacks.policy("pol", {**strategies, "dontschedule": [rule("net", "LessThan", 10)]})
    for verb in ("prioritize", "filter"):
        stacks.post(verb, body)


# -- host-only metrics and rule sets ---------------------------------------------


@pytest.mark.parametrize("verb", ["prioritize", "filter"])
def test_host_only_metric(verb):
    """A sub-milli value makes the metric host-only: both stacks answer on
    their exact host path."""
    stacks = Stacks()
    stacks.policy(
        "pol",
        {
            "scheduleonmetric": [rule("fine", "LessThan", 0)],
            "dontschedule": [rule("fine", "GreaterThan", 1)],
        },
    )
    stacks.metric("fine", {"n1": "100500u", "n2": "2", "n3": "1500m", "n4": "999u"})
    assert stacks.port.mirror.metric_host_only("fine")
    got = stacks.post(verb, policy_body("pol", ["n1", "n2", "n3", "n4"], nodes=False))
    assert got.status == 200


def test_unknown_operator_rule_set_is_host_only():
    stacks = Stacks()
    stacks.policy("pol", {"dontschedule": [rule("m", "Between", 5), rule("m", "GreaterThan", 50)]})
    stacks.metric("m", {"n1": 10, "n2": 70})
    assert stacks.port.mirror.policy("default", "pol").device_rules("dontschedule") is None
    # the host path raises on the unknown operator, as the reference panics
    # on its nil operator map; the server turns that into a 500
    body = policy_body("pol", ["n1", "n2"])
    headers = {"Content-Type": "application/json"}
    with pytest.raises(KeyError, match="Between"):
        stacks.jax.filter(JaxRequest("POST", "/scheduler/filter", headers, body))
    with pytest.raises(KeyError, match="Between"):
        stacks.port.filter(HTTPRequest("POST", "/scheduler/filter", headers, body))


@pytest.mark.parametrize("mode", ["device", "host_only"])
def test_without_a_mirror_or_on_it(mode):
    stacks = Stacks(mirror=mode == "device")
    stacks.policy(
        "pol",
        {
            "scheduleonmetric": [rule("m", "GreaterThan", 0)],
            "dontschedule": [rule("m", "GreaterThan", 60)],
        },
    )
    stacks.metric("m", {f"n{i}": (i * 37) % 101 for i in range(25)})
    for verb in ("prioritize", "filter"):
        stacks.post(verb, policy_body("pol", [f"n{i}" for i in range(25)], nodes=False))


# -- the batch planner's plan on the wire ----------------------------------------


def planned_stacks():
    stacks = Stacks(planner=True)
    stacks.policy(
        "plan-pol",
        {
            "scheduleonmetric": [rule("m", "GreaterThan", 0)],
            "dontschedule": [rule("m", "GreaterThan", 900)],
        },
    )
    stacks.metric("m", {"n1": 100, "n2": 50, "n3": 10, "n4": 5})
    for name in ("n1", "n2", "n3", "n4"):
        raw = make_node(name, allocatable={"pods": "1"}).raw
        stacks.jax_planner.node_changed(JaxNode(raw))
        stacks.planner.node_changed(Node(raw))
    pods = [make_pod(f"p{i}", labels={"telemetry-policy": "plan-pol"}).raw for i in range(3)]
    for raw in pods:
        stacks.jax_planner.pod_added(JaxPod(raw))
        stacks.planner.pod_added(Pod(raw))
    assert stacks.planner.replan() == stacks.jax_planner.replan() == 3
    return stacks, pods


@pytest.mark.parametrize("nodes", [True, False], ids=["nodes", "node_names"])
def test_planned_node_is_promoted(nodes):
    stacks, pods = planned_stacks()
    for raw in pods:
        planned = stacks.planner.planned_node(Pod(raw))
        body = policy_body("plan-pol", ["n4", "n3", "n2", "n1"], nodes=nodes, pod=raw["metadata"]["name"])
        ranked = json.loads(stacks.post("prioritize", body).body)
        assert ranked[0] == {"Host": planned, "Score": 10}
    # the third pod's plan (n3) is no node's first choice on the metric
    assert stacks.planner.planned_node(Pod(pods[2])) == "n3"


def test_stale_plan_is_not_promoted():
    stacks, pods = planned_stacks()
    stacks.metric("m", {"n1": 100, "n2": 50, "n3": 11, "n4": 5})
    assert stacks.planner.planned_node(Pod(pods[2])) is None
    body = policy_body("plan-pol", ["n1", "n2", "n3"], pod="p2")
    assert json.loads(stacks.post("prioritize", body).body)[0]["Host"] == "n1"


# -- the port's device path against its own host path ----------------------------


def port_pair():
    """The port's extender over a CPU mirror and a host-only one, over one
    cache (after test_telemetryscheduler.py::TestDeviceHostEquivalence)."""
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    return cache, MetricsExtender(cache, mirror=mirror), MetricsExtender(cache)


def port_post(ext, verb, body):
    return getattr(ext, verb)(
        HTTPRequest("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body)
    )


@pytest.mark.parametrize("operator", ["GreaterThan", "LessThan"])
def test_port_device_equals_host_prioritize(operator):
    rng = np.random.default_rng(42)
    cache, device, host = port_pair()
    names = [f"node{i}" for i in range(50)]
    # distinct values: the order of equal values is the one thing the two
    # paths may differ in (index order against input order)
    vals = rng.permutation(np.arange(-25_000, 25_000, 1000))[: len(names)]
    cache.write_policy(
        "default", "p",
        TASPolicy.from_obj(make_policy("p", strategies={"scheduleonmetric": [rule("m", operator, 0)]})),
    )
    cache.write_metric("m", {n: NodeMetric(value=Quantity(str(int(v)))) for n, v in zip(names, vals)})
    body = request_body(names[:40], {"telemetry-policy": "p"})
    assert port_post(device, "prioritize", body).body == port_post(host, "prioritize", body).body


def test_port_device_equals_host_filter():
    rng = np.random.default_rng(43)
    cache, device, host = port_pair()
    cache.write_policy(
        "default", "p",
        TASPolicy.from_obj(make_policy("p", strategies={"dontschedule": [
            rule("m1", "GreaterThan", 50), rule("m2", "LessThan", -10)]})),
    )
    names = [f"node{i}" for i in range(60)]
    for metric, low, high in (("m1", 0, 100), ("m2", -50, 50)):
        cache.write_metric(metric, {
            n: NodeMetric(value=Quantity(str(int(rng.integers(low, high)))))
            for n in names if rng.random() > 0.2
        })
    body = request_body(names, {"telemetry-policy": "p"})
    assert port_post(device, "filter", body).body == port_post(host, "filter", body).body


def test_device_path_served_from_the_warm_pass():
    """With the warm pass done, Prioritize and Filter never read the
    cache's metric values and never run a scoring function again."""
    cache, device, _host = port_pair()
    cache.write_policy("default", "policy1", TASPolicy.from_obj(make_policy(
        "policy1", strategies={
            "scheduleonmetric": [rule("metric1", "GreaterThan", 0)],
            "dontschedule": [rule("metric1", "GreaterThan", 40)],
        })))
    cache.write_metric("metric1", {"node A": NodeMetric(value=Quantity("100")),
                                   "node B": NodeMetric(value=Quantity("20"))})
    calls = (scoring.batch_prioritize.CALLS, scoring.filter_explain.CALLS, scoring.prioritize.CALLS)
    fallbacks = trace.COUNTERS.get("pas_prioritize_host_fallback_total")
    cache.read_metric = lambda name: (_ for _ in ()).throw(AssertionError(name))
    body = request_body(["node A", "node B"], {"telemetry-policy": "policy1"})
    assert json.loads(port_post(device, "prioritize", body).body) == [
        {"Host": "node A", "Score": 10}, {"Host": "node B", "Score": 9}]
    assert json.loads(port_post(device, "filter", body).body)["FailedNodes"] == {
        "node A": "policy policy1: metric metric1=100 > threshold 40"}
    assert (scoring.batch_prioritize.CALLS, scoring.filter_explain.CALLS,
            scoring.prioritize.CALLS) == calls
    assert trace.COUNTERS.get("pas_prioritize_host_fallback_total") == fallbacks
    assert device.readiness_conditions()[0][1]() == (True, "fastpath warmed")


def test_warm_pass_counts_one_ranking_and_one_explain_per_policy():
    cache, device, _host = port_pair()
    for name, metric in (("a", "m1"), ("b", "m2")):
        cache.write_policy("default", name, TASPolicy.from_obj(make_policy(name, strategies={
            "scheduleonmetric": [rule(metric, "GreaterThan", 0)],
            "dontschedule": [rule(metric, "LessThan", 5)],
        })))
    for metric in ("m1", "m2"):
        cache.write_metric(metric, {f"n{i}": NodeMetric(value=Quantity(str(i))) for i in range(9)})
    before = (scoring.batch_prioritize.CALLS, scoring.filter_explain.CALLS)
    cache.write_metric("m1", {f"n{i}": NodeMetric(value=Quantity(str(i + 1))) for i in range(9)})
    after = (scoring.batch_prioritize.CALLS, scoring.filter_explain.CALLS)
    # one state change: one batched ranking (only m1's pair moved), one
    # explain (only policy a's rule row moved)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    # a rewrite with the same values is no state change: no device work
    cache.write_metric("m1", {f"n{i}": NodeMetric(value=Quantity(str(i + 1))) for i in range(9)})
    assert (scoring.batch_prioritize.CALLS, scoring.filter_explain.CALLS) == after


def test_filter_records_bypass_decisions():
    """A served Filter (one with a span) is a cache bypass: its span, the
    counter and its decision record say so."""
    stacks = quirk_stacks()
    bypass = trace.COUNTERS.get("pas_filter_cache_bypass_total")
    decisions.DECISIONS.clear()
    span = trace.Span("POST /scheduler/filter")
    body = policy_body("pol", ["n1", "n2", "n3"], nodes=False, pod="rec")
    stacks.port.filter(HTTPRequest("POST", "/scheduler/filter", {"Content-Type": "application/json"}, body, span=span))
    assert trace.COUNTERS.get("pas_filter_cache_bypass_total") == bypass + 1
    assert span.attrs["filter_cache"] == "bypass"
    record = json.loads(decisions.DECISIONS.to_json(pod="rec"))["records"][0]
    assert (record["verb"], record["path"], record["filtered"]) == ("filter", "bypass", 1)


def filter_with_span(ext, body):
    span = trace.Span("POST /scheduler/filter")
    response = ext.filter(
        HTTPRequest("POST", "/scheduler/filter", {"Content-Type": "application/json"}, body, span=span)
    )
    return response, span


@pytest.mark.parametrize("verb", ["prioritize", "filter"])
def test_device_trouble_is_a_visible_host_fallback(verb):
    """A device path that raises still answers with the host path's bytes,
    and says so: the span's path is ``host`` and the verb's fallback
    counter moves by one."""
    stacks = quirk_stacks()
    body = policy_body("pol", ["n1", "n2", "n3"], nodes=False)
    want = stacks.post(verb, body).body  # the JAX package's bytes
    counter = f"pas_{verb}_host_fallback_total"

    def served():
        span = trace.Span(f"POST /scheduler/{verb}")
        request = HTTPRequest(
            "POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body, span=span
        )
        before = trace.COUNTERS.get(counter)
        assert getattr(stacks.port, verb)(request).body == want
        return span.attrs["path"], trace.COUNTERS.get(counter) - before

    assert served() == ("device", 0)

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    stacks.port.fastpath.prioritize_bytes = broken
    stacks.port.fastpath.violation_reasons = broken
    assert served() == ("host", 1)


def test_filter_span_path_is_host_without_device_rules():
    """A host-only extender's Filter says ``host`` on its span and counts
    no fallback."""
    stacks = Stacks(mirror=False)
    stacks.policy("pol", {"dontschedule": [rule("m", "GreaterThan", 60)]})
    stacks.metric("m", {"n1": 10, "n2": 70})
    before = trace.COUNTERS.get("pas_filter_host_fallback_total")
    response, span = filter_with_span(stacks.port, policy_body("pol", ["n1", "n2"], nodes=False))
    assert json.loads(response.body)["NodeNames"] == ["n1"]
    assert span.attrs["path"] == "host"
    assert trace.COUNTERS.get("pas_filter_host_fallback_total") == before


def test_failed_warm_pass_clears_readiness():
    """kernels_warmed reports the LATEST warm pass: one that raises turns
    it off until a later pass succeeds."""
    stacks = quirk_stacks()
    warmed = stacks.port.readiness_conditions()[0][1]
    assert warmed() == (True, "fastpath warmed")
    precompute = stacks.port.fastpath.precompute

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    stacks.port.fastpath.precompute = broken
    stacks.metric("m", {"n1": 11, "n2": 70, "n3": 40})
    assert warmed() == (False, "fastpath warm has not completed")
    stacks.port.fastpath.precompute = precompute
    stacks.metric("m", {"n1": 12, "n2": 70, "n3": 40})
    assert warmed() == (True, "fastpath warmed")


# -- /readyz telemetry freshness ---------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_telemetry_freshness_like_jax():
    """The same refresh history on a fake clock: both caches report the
    same freshness verdict, reason string and metric ages at every step."""
    from platform_aware_scheduling_tpu.tas.metrics import DummyMetricsClient as JaxClient
    from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient

    clock = FakeClock()
    caches = [JaxCache(clock=clock), AutoUpdatingCache(clock=clock)]
    clients = [JaxClient(), DummyMetricsClient()]
    clients[0].store["a"] = {"n1": JaxNodeMetric(value=JaxQuantity("1"))}
    clients[1].store["a"] = {"n1": NodeMetric(value=Quantity("1"))}
    seen = []

    def observe():
        seen.append([(c.telemetry_freshness(), c.metric_ages(), c.freshness_bound()) for c in caches])
        assert seen[-1][0] == seen[-1][1]

    for cache in caches:
        for metric in ("a", "b"):  # "b" never has data: it stays stale
            cache.write_metric(metric)
    observe()  # static: no refresh loop
    stopped = __import__("threading").Event()
    stopped.set()
    for cache, client in zip(caches, clients):
        cache.periodic_update(5.0, client, stop=stopped)  # configures the period only
    observe()  # never refreshed
    for cache, client in zip(caches, clients):
        cache.update_all_metrics(client)
    observe()  # "b" has no data
    for cache in caches:
        cache.delete_metric("b")
    clock.now += 4
    for cache, client in zip(caches, clients):
        cache.update_all_metrics(client)
    observe()  # fresh
    clock.now += 16
    observe()  # the loop stalled past 3 periods
    for cache in caches:
        cache.freshness_max_age_s = 30.0
    observe()
    assert [verdict[0][0][0] for verdict in seen] == [True, False, False, True, False, True]


def test_decision_records_like_jax():
    """Prioritize, Filter and the Bind that closes them leave the same
    decision records in both packages' logs (ids and clocks aside)."""
    from platform_aware_scheduling_tpu.utils import decisions as jax_decisions

    def records(log):
        out = []
        for record in json.loads(log.to_json(pod="golden-pod"))["records"]:
            record = {k: v for k, v in record.items() if k not in ("seq", "ts", "request_id")}
            if record.get("outcome"):
                record["outcome"] = {k: v for k, v in record["outcome"].items() if k != "bound_at"}
            out.append(record)
        return out

    stacks = golden_stacks()
    jax_decisions.DECISIONS.clear()
    decisions.DECISIONS.clear()
    body = read_fixture("prioritize_request_upstream_nodenames.json")
    stacks.post("prioritize", body)
    stacks.post("filter", body)
    assert records(decisions.DECISIONS) == records(jax_decisions.DECISIONS)
    stacks.post("bind", read_fixture("bind_request_upstream.json"))
    got = records(decisions.DECISIONS)
    assert got == records(jax_decisions.DECISIONS)
    assert [r["verb"] for r in got] == ["filter", "prioritize"]
    assert all(r["outcome"]["bound_node"] == "gw-b" for r in got)


def test_violation_sets_like_jax():
    stacks = golden_stacks()
    jax_compiled, jax_view = stacks.jax.mirror.policy_with_view("default", "golden-pol")
    compiled, view = stacks.port.mirror.policy_with_view("default", "golden-pol")
    assert stacks.port.fastpath.violation_set(compiled, view) == stacks.jax.fastpath.violation_set(
        jax_compiled, jax_view
    )
    assert stacks.port.fastpath.violation_rule_map(compiled, view) == {1: 0}
    assert stacks.port.fastpath.violation_reasons(compiled, view, "golden-pol")[1:] == (
        stacks.jax.fastpath.violation_reasons(jax_compiled, jax_view, "golden-pol")[1:]
    )
    # every pair is warm: a batched re-warm ranks nothing
    pair = (compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
    calls = scoring.batch_prioritize.CALLS
    assert stacks.port.fastpath.warm_rankings_batched(view, [pair]) == 0
    assert scoring.batch_prioritize.CALLS == calls


def test_requests_that_beat_the_warm_pass():
    """With empty fast-path caches (a request ahead of the warm pass), the
    verbs rank and explain on demand, with the same bytes."""
    from platform_aware_scheduling_tpu_torch.tas.fastpath import PrioritizeFastPath

    stacks = quirk_stacks()
    stacks.port.fastpath = PrioritizeFastPath()
    ranked, explained = scoring.prioritize.CALLS, scoring.filter_explain.CALLS
    body = policy_body("pol", ["n3", "n2", "n1"], nodes=False)
    stacks.post("prioritize", body)
    stacks.post("filter", body)
    assert (scoring.prioritize.CALLS - ranked, scoring.filter_explain.CALLS - explained) == (1, 1)
    stacks.post("prioritize", body)  # now cached
    assert scoring.prioritize.CALLS - ranked == 1
