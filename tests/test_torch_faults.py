"""The port's fault planes (``testing/faults.py``, ``tas/degraded.py``, the
degraded verbs of ``tas/telemetryscheduler.py`` and the suspended and
follower branches of deschedule ``enforce``), held exactly against the
JAX package's on seeded inputs: fault sequences, decisions, reason
strings, gauges, wire bytes, patches and ``/readyz`` bodies are equal.
Both sides run on FakeClocks stepped alike; nothing sleeps."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from platform_aware_scheduling_tpu.extender import server as jax_server
from platform_aware_scheduling_tpu.kube import lease as jax_lease
from platform_aware_scheduling_tpu.kube import retry as jax_retry
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas import cache as jax_cache
from platform_aware_scheduling_tpu.tas import degraded as jax_degraded
from platform_aware_scheduling_tpu.tas import telemetryscheduler as jax_ts
from platform_aware_scheduling_tpu.tas.policy import v1alpha1 as jax_policy
from platform_aware_scheduling_tpu.tas.strategies import core as jax_core
from platform_aware_scheduling_tpu.tas.strategies import deschedule as jax_deschedule
from platform_aware_scheduling_tpu.testing import builders as jax_builders
from platform_aware_scheduling_tpu.testing import fake_kube as jax_fake
from platform_aware_scheduling_tpu.testing import faults as jax_faults
from platform_aware_scheduling_tpu.utils import decisions as jax_decisions
from platform_aware_scheduling_tpu.utils import trace as jax_trace
from platform_aware_scheduling_tpu.utils import tracing as jax_tracing
from platform_aware_scheduling_tpu_torch.extender import server
from platform_aware_scheduling_tpu_torch.kube import lease, retry
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas import cache, degraded, telemetryscheduler
from platform_aware_scheduling_tpu_torch.tas.policy import v1alpha1
from platform_aware_scheduling_tpu_torch.tas.strategies import core, deschedule
from platform_aware_scheduling_tpu_torch.testing import builders, fake_kube, faults
from platform_aware_scheduling_tpu_torch.utils import decisions, trace, tracing

SEED = 7
PERIOD_S = 1.0  # freshness bound 3 s, last-known-good bound 9 s
NODES = [f"n{i}" for i in range(8)]
METRICS = ("m0", "m1")


def package(jax: bool) -> SimpleNamespace:
    """The modules of one package under common names."""
    if jax:
        return SimpleNamespace(
            faults=jax_faults, retry=jax_retry, cache=jax_cache, degraded=jax_degraded, ts=jax_ts,
            policy=jax_policy, core=jax_core, deschedule=jax_deschedule, fake=jax_fake,
            builders=jax_builders, lease=jax_lease, server=jax_server, decisions=jax_decisions,
            trace=jax_trace, tracing=jax_tracing, mirror=JaxMirror,
        )
    return SimpleNamespace(
        faults=faults, retry=retry, cache=cache, degraded=degraded, ts=telemetryscheduler,
        policy=v1alpha1, core=core, deschedule=deschedule, fake=fake_kube, builders=builders,
        lease=lease, server=server, decisions=decisions, trace=trace, tracing=tracing,
        mirror=lambda: TensorStateMirror(device="cpu"),
    )


@pytest.fixture(autouse=True)
def _pure_python_wire(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")  # the JAX wire path the port serves


# -- FaultPlan --------------------------------------------------------------------------


def plan_outcomes(pkg, script, calls):
    """Each call's outcome under a plan built by ``script``: (faulted,
    status, fault-clock advance, truncate), plus the call counts."""
    clock = pkg.faults.FakeClock(start=100.0)
    plan = script(pkg.faults.FaultPlan(seed=SEED))
    out = []
    for verb in calls:
        before = clock.now()
        fault = plan.next(verb)
        status = None
        if fault is not None:
            try:
                fault.apply(clock)
            except Exception as exc:  # noqa: BLE001 — the scripted error is the outcome
                status = getattr(exc, "status", type(exc).__name__)
        out.append((fault is not None, status, clock.now() - before, None if fault is None else fault.truncate))
    return out, dict(plan.calls)


PLAN_SCRIPTS = {
    "error_rate": (lambda p: p.error_rate("get_node_metric", 0.3), ["get_node_metric"] * 200),
    "error_rate_two_verbs": (
        lambda p: p.error_rate("list_nodes", 0.5).error_rate("patch_node", 0.2, status=429),
        ["list_nodes", "patch_node"] * 100,
    ),
    "flap": (lambda p: p.flap("v", ok=2, fail=3, cycles=4), ["v"] * 24),
    "fail_latency_truncate": (
        lambda p: p.fail("v", 2, status=500).latency("v", 2, 2.5).truncate("v", 2, keep=3),
        ["v"] * 8,
    ),
    "outage_wins_and_keeps_the_script": (lambda p: p.fail("v", 2).outage("v"), ["v"] * 5),
    "wildcard_after_verb_script": (lambda p: p.fail("v", 1).fail("*", 2, status=502), ["v", "w", "v", "w", "v"]),
    "script_then_rate": (lambda p: p.fail("v", 3).error_rate("v", 0.5), ["v"] * 40),
}


@pytest.mark.parametrize("name", sorted(PLAN_SCRIPTS))
def test_fault_plan_outcomes_equal_the_jax_plan(name):
    script, calls = PLAN_SCRIPTS[name]
    assert plan_outcomes(package(False), script, calls) == plan_outcomes(package(True), script, calls)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_error_rate_is_a_pure_function_of_seed_verb_and_index(seed):
    def fired(pkg):
        plan = pkg.faults.FaultPlan(seed=seed).error_rate("get_lease", 0.25)
        return [plan.next("get_lease") is not None for _ in range(300)]

    assert fired(package(False)) == fired(package(True))
    assert 0.1 < sum(fired(package(False))) / 300 < 0.4


def test_clear_ends_outage_rate_and_script():
    for jax in (True, False):
        plan = package(jax).faults.FaultPlan().outage("a").error_rate("b", 1.0).fail("c", 3)
        plan.clear("a")
        assert plan.next("a") is None and plan.next("b") is not None
        plan.clear()
        assert [plan.next(v) for v in "abc"] == [None, None, None]


def test_faulty_client_intercepts_public_methods_by_name():
    for jax in (True, False):
        pkg = package(jax)
        kube = pkg.fake.FakeKubeClient()
        kube.add_node(pkg.builders.make_node("n1"))
        wrapped = pkg.faults.FaultyClient(kube, pkg.faults.FaultPlan().fail("list_nodes", 1))
        with pytest.raises(pkg.faults.KubeError) as err:
            wrapped.list_nodes()
        assert err.value.status == 503
        assert [n.name for n in wrapped.list_nodes()] == ["n1"]
        assert wrapped.plan.call_count("list_nodes") == 2 and wrapped._lock is kube._lock


def test_fake_metrics_client_and_int_node_metric():
    for jax in (True, False):
        pkg = package(jax)
        client = pkg.faults.FakeMetricsClient()
        client.set_all("m", {"a": 1, "b": "250m"})
        client.set("m", "c", 3)
        client.set_all_metrics("k", {"a": pkg.faults.int_node_metric(7)})
        got = client.get_node_metric("m")
        assert {n: m.value.milli_value_exact()[0] for n, m in got.items()} == {"a": 1000, "b": 250, "c": 3000}
        assert pkg.faults.int_node_metric(7) is pkg.faults.int_node_metric(7)
        with pytest.raises(Exception, match="no metric missing found"):
            client.get_node_metric("missing")


# -- the degraded-mode controller on twin caches and breakers ----------------------------


class Side:
    """One package's telemetry cache fed through a fault-tolerant client
    over a FakeMetricsClient, with its breakers and a degraded-mode
    controller, every clock one FakeClock."""

    def __init__(self, jax: bool, mode: str, counters=None):
        self.pkg = pkg = package(jax)
        self.clock = pkg.faults.FakeClock()
        self.plan = pkg.faults.FaultPlan(seed=SEED)
        self.cache = pkg.cache.AutoUpdatingCache(counters=pkg.tracing.CounterSet(), clock=self.clock.now)
        self.cache._refresh_period = PERIOD_S
        rng = np.random.default_rng(SEED)
        self.metrics = pkg.faults.FakeMetricsClient(plan=self.plan, clock=self.clock)
        for metric in METRICS:
            self.metrics.set_all(metric, dict(zip(NODES, rng.integers(0, 100, len(NODES)).tolist())))
        self.breakers = pkg.retry.CircuitBreakerRegistry(
            failure_threshold=3, reset_timeout_s=5.0, clock=self.clock.now, counters=pkg.tracing.CounterSet()
        )
        self.client = pkg.retry.FaultTolerantClient(
            self.metrics,
            policy=pkg.retry.RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=0.5, deadline_s=10.0),
            breakers=self.breakers,
            clock=self.clock.now,
            sleep=self.clock.sleep,
            counters=pkg.tracing.CounterSet(),
        )
        self.counters = counters if counters is not None else pkg.tracing.CounterSet()
        self.degraded = pkg.degraded.DegradedModeController(
            self.cache, breakers=self.breakers, mode=mode, counters=self.counters
        )

    def register(self):
        for metric in METRICS:
            self.cache.write_metric(metric)

    def step(self, action):
        kind, _, arg = action.partition(":")
        if kind == "refresh":
            self.clock.advance(PERIOD_S)
            self.cache.update_all_metrics(self.client)
        elif kind == "advance":
            self.clock.advance(float(arg))
        elif kind == "outage":
            self.plan.outage("get_node_metric")
        elif kind == "rate":
            self.plan.error_rate("get_node_metric", float(arg))
        elif kind == "clear":
            self.plan.clear("get_node_metric")
        elif kind == "kube_fail":
            self.breakers.breaker("kube").record_failure()
        elif kind == "kube_ok":
            self.breakers.breaker("kube").record_success()
        else:
            raise ValueError(action)

    def snapshot(self):
        ctl = self.degraded
        return {
            "filter": ctl.filter_decision(),
            "prioritize": ctl.prioritize_decision(),
            "evictions": ctl.evictions_allowed(),
            "ready": ctl.readiness_condition(),
            "status": ctl.status(),
            "gauges": self.counters.prometheus_text(),
            "cache": self.cache.counters.prometheus_text(),
            "client": self.client.counters.prometheus_text(),
        }


DEGRADED_SCENARIOS = {
    # a metrics outage through the last-known-good window to neutral and
    # fail-open, then recovery through the half-open probe
    "metrics_outage": ["refresh", "refresh", "outage"] + ["refresh"] * 12 + ["clear"] + ["refresh"] * 8,
    # telemetry fresh, the kube circuit open, half-open, closed
    "kube_circuit": ["refresh"] + ["kube_fail"] * 3 + ["refresh"] * 3 + ["advance:5", "refresh", "kube_ok", "refresh"],
    # the refresh loop stalls: no pass for 12 s
    "stalled_loop": ["refresh", "refresh"] + ["advance:1"] * 12 + ["refresh"],
    # a seeded 50% error rate: the circuit flaps as the seed dictates
    "error_rate": ["refresh", "rate:0.5"] + ["refresh"] * 20 + ["clear"] + ["refresh"] * 6,
    # never refreshed: registered metrics with no data
    "never_refreshed": ["advance:1", "refresh", "outage", "advance:20"],
}


def degraded_trace(jax, mode, scenario):
    side = Side(jax, mode)
    side.register()
    out = [side.snapshot()]
    for action in DEGRADED_SCENARIOS[scenario]:
        side.step(action)
        out.append(side.snapshot())
    return out


@pytest.mark.parametrize("scenario", sorted(DEGRADED_SCENARIOS))
@pytest.mark.parametrize("mode", ["fail-open", "fail-closed", "last-known-good"])
def test_degraded_decisions_equal_the_jax_controller(mode, scenario):
    got, want = degraded_trace(False, mode, scenario), degraded_trace(True, mode, scenario)
    for step, (mine, theirs) in enumerate(zip(got, want)):
        assert mine == theirs, (step, mine, theirs)
    assert len(got) == len(want)
    if scenario == "metrics_outage":
        actions = {(s["filter"][0], s["prioritize"][0]) for s in got}
        want_filter = {"fail-open": "fail_open", "fail-closed": "fail_closed", "last-known-good": "fail_open"}[mode]
        assert ("normal", "normal") in actions and (want_filter, "neutral") in actions
        assert got[-1]["evictions"][0] is True


@pytest.mark.parametrize("state", ["closed", "open", "half-open"])
@pytest.mark.parametrize("group", ["kube", "metrics"])
def test_circuit_states_reach_the_decisions_alike(group, state):
    def run(jax):
        side = Side(jax, "last-known-good")
        side.register()
        side.step("refresh")
        breaker = side.breakers.breaker(group)
        if state != "closed":
            for _ in range(3):
                breaker.record_failure()
        if state == "half-open":
            side.clock.advance(5.0)
        assert breaker.state == state
        return side.snapshot(), side.degraded.degraded_subsystems(), side.degraded.kube_status()

    assert run(False) == run(True)


def test_explicit_lkg_bound_and_multiple():
    def run(jax):
        side = Side(jax, "last-known-good")
        side.register()
        side.step("refresh")
        side.step("advance:4")  # stale past the 3 s bound
        out = [side.degraded.prioritize_decision()]
        side.degraded.lkg_bound_multiple = 1.0  # 3 s: past it
        out.append(side.degraded.prioritize_decision())
        side.degraded.lkg_max_age_s = 10.0
        out.append(side.degraded.prioritize_decision())
        return out

    got = run(False)
    assert got == run(True)
    assert [a for a, _ in got] == ["last_known_good", "neutral", "last_known_good"]


def test_unknown_mode_is_refused():
    with pytest.raises(ValueError, match="unknown degraded mode"):
        degraded.DegradedModeController(mode="on")
    assert degraded.MODES == jax_degraded.MODES
    assert degraded.DEFAULT_LKG_BOUND_MULTIPLE == jax_degraded.DEFAULT_LKG_BOUND_MULTIPLE


# -- the degraded verbs, byte for byte ---------------------------------------------------


POLICY = {
    "dontschedule": [{"metricname": "m0", "operator": "GreaterThan", "target": 50}],
    "scheduleonmetric": [{"metricname": "m1", "operator": "LessThan", "target": 0}],
}


class ExtenderSide(Side):
    """A Side with a mirror and an extender over its cache; the default
    ``counters`` are the package's process-wide ones, as in a service."""

    def __init__(self, jax: bool, mode: str, mirror: bool = True):
        super().__init__(jax, mode, counters=package(jax).trace.COUNTERS)
        pkg = self.pkg
        self.mirror = pkg.mirror() if mirror else None
        if mirror:
            self.mirror.attach(self.cache)
        self.extender = pkg.ts.MetricsExtender(self.cache, mirror=self.mirror, node_cache_capable=True)
        self.extender.degraded = self.degraded
        obj = pkg.builders.make_policy("pol", strategies=POLICY)
        self.cache.write_policy("default", "pol", pkg.policy.TASPolicy.from_obj(obj))
        self.register()
        self.server = pkg.server.Server(self.extender, metrics_provider=self.extender.metrics_text)

    def verb(self, verb, body):
        pkg = self.pkg
        request = pkg.server.HTTPRequest("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body)
        request.span = pkg.trace.Span(verb)
        response = getattr(self.extender, verb)(request)
        records = pkg.decisions.DECISIONS.snapshot(limit=1)["records"]
        # the span's path is the port's own for Filter (the JAX exact
        # path leaves it unset), so only the degraded tag is compared
        self.last_path = request.span.attrs.get("path")
        return (response.status, response.body), request.span.attrs.get("degraded"), records[-1]["path"] if records else None

    def get(self, path):
        response = self.server.route(self.pkg.server.HTTPRequest("GET", path, {}, b""))
        return response.status, response.body


def args_body(nodes_mode: bool, labelled: bool = True) -> bytes:
    labels = {"telemetry-policy": "pol"} if labelled else {}
    body = {"Pod": {"metadata": {"name": "p", "namespace": "default", "labels": labels}}}
    if nodes_mode:
        body["Nodes"] = {"items": [{"metadata": {"name": n}} for n in NODES + ["unknown-node"]]}
    else:
        body["NodeNames"] = NODES + ["unknown-node"]
    return json.dumps(body).encode()


def twin_extenders(mode, mirror=True):
    return ExtenderSide(True, mode, mirror), ExtenderSide(False, mode, mirror)


def step_both(sides, actions):
    for action in actions:
        for side in sides:
            side.step(action)


# the states the verbs are asked in: (name, actions to reach it from the last)
VERB_STATES = [
    ("healthy", ["refresh", "refresh"]),
    ("last_known_good", ["outage", "refresh", "refresh"]),
    ("past_the_window", ["refresh"] * 10),
    ("recovered", ["clear"] + ["refresh"] * 8),
]


@pytest.mark.parametrize("mirror", [True, False], ids=["device", "host-only"])
@pytest.mark.parametrize("nodes_mode", [True, False], ids=["nodes", "nodenames"])
@pytest.mark.parametrize("mode", ["fail-open", "fail-closed", "last-known-good"])
def test_degraded_verbs_equal_the_jax_extender(mode, nodes_mode, mirror):
    jax_side, port_side = twin_extenders(mode, mirror)
    sides = (jax_side, port_side)
    seen = {}
    for state, actions in VERB_STATES:
        step_both(sides, actions)
        for verb in ("filter", "prioritize"):
            for labelled in (True, False):
                body = args_body(nodes_mode, labelled)
                got, want = port_side.verb(verb, body), jax_side.verb(verb, body)
                assert got == want, (state, verb, labelled)
                seen[(state, verb, labelled)] = (*got, port_side.last_path)
    filter_past = json.loads(seen[("past_the_window", "filter", True)][0][1])
    if mode == "fail-closed":
        assert set(filter_past["FailedNodes"]) == set(NODES) | {"unknown-node"}
        assert set(filter_past["FailedNodes"].values()) == {decisions.REASON_FAIL_CLOSED}
        assert seen[("past_the_window", "filter", True)][2] == "fail_closed"
    else:
        assert filter_past["FailedNodes"] == {}
        assert seen[("past_the_window", "filter", True)][2] == "fail_open"
    neutral = seen[("past_the_window", "prioritize", True)]
    assert {e["Score"] for e in json.loads(neutral[0][1])} == {0}
    assert neutral[3] == "neutral" and neutral[1] and neutral[2] == "neutral"
    lkg = seen[("last_known_good", "prioritize", True)]
    assert lkg[0] == seen[("healthy", "prioritize", True)][0]
    assert lkg[3] == ("device" if mirror else "host") and lkg[1].startswith("metrics-API circuit")
    assert seen[("recovered", "prioritize", True)][0] == seen[("healthy", "prioritize", True)][0]
    assert seen[("healthy", "prioritize", True)][1] is None


def test_fail_closed_counts_its_filtered_nodes_under_its_reason():
    jax_side, port_side = twin_extenders("fail-closed")
    step_both((jax_side, port_side), ["refresh", "outage"] + ["refresh"] * 12)

    def delta(side):
        labels = {"reason": "fail_closed"}
        before = side.pkg.trace.COUNTERS.get("pas_decision_filtered_nodes_total", labels=labels)
        side.verb("filter", args_body(False))
        return side.pkg.trace.COUNTERS.get("pas_decision_filtered_nodes_total", labels=labels) - before

    assert delta(port_side) == delta(jax_side) == len(NODES) + 1


@pytest.mark.parametrize("mode", ["fail-open", "last-known-good"])
def test_readyz_bodies_and_degraded_gauges_equal_the_jax_server(mode):
    jax_side, port_side = twin_extenders(mode)
    sides = (jax_side, port_side)
    steps = [("healthy", ["refresh"]), ("outage", ["outage", "refresh"]), ("neutral", ["refresh"] * 12),
             ("kube_open", ["clear"] + ["refresh"] * 7 + ["kube_fail"] * 3), ("closed", ["advance:5", "kube_ok", "refresh"])]
    for state, actions in steps:
        step_both(sides, actions)
        got, want = port_side.get("/readyz"), jax_side.get("/readyz")
        assert got == want, state
        conditions = [c["name"] for c in json.loads(got[1])["conditions"]]
        assert conditions == ["kernels_warmed", "telemetry_fresh", "degraded_mode"]
        lines = []
        for side in (port_side, jax_side):
            side.degraded.evictions_allowed()  # every subsystem's gauge current
            text = side.get("/metrics")[1].decode()
            lines.append([line for line in text.splitlines() if "pas_degraded" in line])
        assert lines[0] == lines[1] and len(lines[0]) == 6, state


# -- the suspended and follower branches of deschedule enforce ---------------------------


DESCHEDULE_RULES = [{"metricname": "m0", "operator": "GreaterThan", "target": 50}]


class EnforcerSide(Side):
    """A Side with a fake API server and a MetricEnforcer over the
    fault-tolerant client that shares the controller's breakers; a
    FaultPlan with no faults between that client and the fake counts the
    enforcer's calls by verb."""

    def __init__(self, jax: bool, branch: str):
        super().__init__(jax, "last-known-good")
        pkg = self.pkg
        self.kube = pkg.fake.FakeKubeClient()
        for i, name in enumerate(NODES):
            labels = {"pol": "violating"} if i % 3 == 0 else {}
            self.kube.add_node({"metadata": {"name": name, "labels": labels}})
        self.calls = pkg.faults.FaultPlan()
        api = pkg.retry.FaultTolerantClient(
            pkg.faults.FaultyClient(self.kube, self.calls),
            policy=pkg.retry.RetryPolicy(max_attempts=2, base_delay_s=0.05, max_delay_s=0.1, deadline_s=5.0),
            breakers=self.breakers,
            clock=self.clock.now,
            sleep=self.clock.sleep,
            counters=pkg.tracing.CounterSet(),
        )
        self.mirror = pkg.mirror()
        self.mirror.attach(self.cache)
        obj = pkg.builders.make_policy("pol", strategies={"deschedule": DESCHEDULE_RULES})
        self.cache.write_policy("default", "pol", pkg.policy.TASPolicy.from_obj(obj))
        self.register()
        self.enforcer = pkg.core.MetricEnforcer(api, mirror=self.mirror)
        self.strategy = pkg.deschedule.Strategy(
            policy_name="pol", rules=[pkg.policy.TASPolicyRule.from_obj(r) for r in DESCHEDULE_RULES]
        )
        self.enforcer.register_strategy_type(self.strategy)
        self.enforcer.add_strategy(self.strategy, "deschedule")
        self.enforcer.degraded = self.degraded
        self.published = []
        self.enforcer.violation_observers.append(lambda kind, v: self.published.append((kind, dict(v))))
        if branch in ("leader", "follower"):
            self.holder = pkg.lease.LeaseElector(self.kube, "other", lease_name="l", clock=self.clock.now)
            self.enforcer.leadership = pkg.lease.LeaseElector(self.kube, "me", lease_name="l", clock=self.clock.now)
            (self.enforcer.leadership if branch == "leader" else self.holder).tick()
            self.enforcer.leadership.tick()
        self.step("refresh")
        if branch == "suspended_stale":
            self.step("advance:4")
        elif branch in ("suspended_kube_open", "suspended_kube_half_open"):
            for _ in range(3):
                self.step("kube_fail")
            if branch == "suspended_kube_half_open":
                # past the reset timeout, with telemetry refreshed
                self.step("advance:4")
                self.step("refresh")

    def enforce(self):
        self.calls.calls.clear()
        patches_before = len(self.kube.node_patches)
        returned = self.strategy.enforce(self.enforcer, self.cache)
        return {
            "returned": returned,
            "patches": self.kube.node_patches[patches_before:],
            "calls": dict(self.calls.calls),
            "published": self.published[-1:],
            "circuits": self.breakers.states(),
            "labels": {n.name: n.get_labels() for n in self.kube.list_nodes()},
        }


BRANCHES = ["leader", "follower", "suspended_stale", "suspended_kube_open", "suspended_kube_half_open"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_deschedule_branches_equal_the_jax_enforcer(branch):
    sides = EnforcerSide(True, branch), EnforcerSide(False, branch)
    first = [side.enforce() for side in sides]
    second = [side.enforce() for side in sides]
    assert first[1] == first[0] and second[1] == second[0]
    got = first[1]
    violators = {name for name, v in zip(NODES, sides[1].metrics.store["m0"].values()) if v.value.milli_value_exact()[0] > 50_000}
    assert violators and got["published"] == [("deschedule", {n: ["pol"] for n in NODES if n in violators})]
    if branch == "leader":
        assert got["patches"] and got["calls"]["list_nodes"] == 1
        return
    assert got["returned"] == 0 and got["patches"] == []
    probes = {"follower": 0, "suspended_stale": 1, "suspended_kube_open": 0, "suspended_kube_half_open": 1}
    assert got["calls"].get("list_nodes", 0) == probes[branch] and set(got["calls"]) <= {"list_nodes"}
    if branch == "suspended_kube_half_open":
        # the probe closed the circuit: the next cycle labels
        assert got["circuits"]["kube"] == "closed" and second[1]["patches"]
    elif branch == "suspended_kube_open":
        assert got["circuits"]["kube"] == "open" and second[1]["patches"] == []


def test_neutral_bytes_equal_the_generic_encoder():
    """The fragment-joined neutral body, for names the view holds and names
    it does not, with characters JSON escapes."""
    from platform_aware_scheduling_tpu_torch.extender.types import HostPriority, encode_host_priority_list
    from platform_aware_scheduling_tpu_torch.tas.fastpath import PrioritizeFastPath
    from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
    from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

    held = ['n"1', "ü-node", "plain", "tab\there"]
    store = cache.AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(store)
    store.write_metric("m", {name: NodeMetric(value=Quantity(str(i))) for i, name in enumerate(held)})
    names = ["plain", "absent\\node", 'n"1', "ü-node", "☃", "tab\there", "plain"]
    got = PrioritizeFastPath().neutral_bytes(mirror.device_view(), names)
    assert got == encode_host_priority_list([HostPriority(host=n, score=0) for n in names])
    assert PrioritizeFastPath().neutral_bytes(mirror.device_view(), []) == encode_host_priority_list([])
