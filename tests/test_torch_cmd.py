"""The port's service main (``cmd/tas.py``, ``cmd/common.py``) and the
planner's informers (``BatchPlanner.watch``), held against the JAX
package's.  The flag surface keeps the JAX names and defaults and refuses
every flag of an unported plane; ``main`` obeys the device rule; the four
scenarios of ``tests/test_e2e.py`` run on twin fake API servers, one
under each package's ``assemble`` wired as its ``main`` wires it (a
fault-tolerant client and its circuit breakers), and every response byte
and node label must be equal; two replicas with leader election on one
fake label the cluster as a JAX pair does, through a failover.  Every
test that assembles a service stops it and joins its threads."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from platform_aware_scheduling_tpu.cmd import tas as jax_tas
from platform_aware_scheduling_tpu.kube.lease import LeaseElector as JaxElector
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import CustomMetricsClient as JaxMetricsClient
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.planner import BatchPlanner as JaxPlanner
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicy as JaxPolicy
from platform_aware_scheduling_tpu.testing import builders as jax_builders
from platform_aware_scheduling_tpu.testing.fake_kube import FakeKubeClient as JaxFake
from platform_aware_scheduling_tpu.testing.faults import FakeClock as JaxClock
from platform_aware_scheduling_tpu.testing.faults import FaultPlan as JaxPlan
from platform_aware_scheduling_tpu.testing.faults import FaultyClient as JaxFaulty
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.cmd import common, tas
from platform_aware_scheduling_tpu_torch.kube.lease import LeaseElector
from platform_aware_scheduling_tpu_torch.kube.objects import Pod
from platform_aware_scheduling_tpu_torch.kube.retry import FaultTolerantClient
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import CustomMetricsClient, NodeMetric
from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
from platform_aware_scheduling_tpu_torch.testing import builders
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
from platform_aware_scheduling_tpu_torch.testing.faults import FakeClock, FaultPlan, FaultyClient
from platform_aware_scheduling_tpu_torch.utils import decisions, events
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

REPO = Path(__file__).resolve().parent.parent

#: the flags the port offers, each the JAX main's
PORTED = [
    "--kubeConfig", "--port", "--cert", "--key", "--cacert", "--unsafe", "--syncPeriod", "--v",
    "--batchPlanner", "--batchSolver", "--nodeCacheCapable", "--serving",
    "--retryMaxAttempts", "--retryBaseDelay", "--retryMaxDelay", "--retryDeadline",
    "--circuitFailureThreshold", "--circuitResetTimeout",
    "--decisionLog", "--decisionLogSize", "--events", "--eventsSize",
    "--degradedMode",
    "--forecast", "--forecastWindow", "--forecastHorizon", "--forecastBandBound",
    "--leaderElect", "--leaseName", "--leaseNamespace", "--leaseDuration", "--leaseRenewPeriod", "--replicaId",
]


def _actions(parser):
    return {opt: action for action in parser._actions for opt in action.option_strings if opt.startswith("--")}


JAX_ACTIONS = _actions(jax_tas.build_arg_parser())
UNPORTED = sorted(set(JAX_ACTIONS) - set(PORTED) - {"--help"})


# -- the flag surface -----------------------------------------------------------------


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_keeps_the_jax_name_default_and_dest(flag):
    mine, theirs = _actions(tas.build_arg_parser())[flag], JAX_ACTIONS[flag]
    assert (mine.dest, mine.default, type(mine).__name__, mine.type) == (
        theirs.dest,
        theirs.default,
        type(theirs).__name__,
        theirs.type,
    )
    if theirs.choices is not None:
        assert set(mine.choices) <= set(theirs.choices)


def test_defaults_parse_alike():
    mine = vars(tas.build_arg_parser().parse_args([]))
    theirs = vars(jax_tas.build_arg_parser().parse_args([]))
    assert mine == {k: theirs[k] for k in mine}


@pytest.mark.parametrize("flag", UNPORTED)
def test_unported_flag_is_refused(flag, capsys):
    value = [] if JAX_ACTIONS[flag].nargs == 0 else ["x"]
    with pytest.raises(SystemExit) as exit_info:
        tas.build_arg_parser().parse_args([flag, *value])
    assert exit_info.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--batchSolver=auction"], ["--serving=async"], ["--degradedMode=on"]])
def test_unported_choice_is_refused(argv):
    with pytest.raises(SystemExit):
        tas.build_arg_parser().parse_args(argv)


def test_help_lists_exactly_the_ported_flags():
    out = subprocess.run(
        [sys.executable, "-m", "platform_aware_scheduling_tpu_torch.cmd.tas", "--help"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    listed = {word.split("=")[0].rstrip(",") for word in out.stdout.split() if word.startswith("--")}
    assert listed == set(PORTED) | {"--help"}


def test_main_without_a_gpu_exits_before_reading_a_kubeconfig(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_kubeconfig(path):
        raise AssertionError(f"main read the kubeconfig {path}")

    monkeypatch.setattr(tas, "get_kube_client", no_kubeconfig)
    assert tas.main(["--unsafe", "--batchPlanner", "--nodeCacheCapable"]) != 0
    assert "no CUDA device is available" in capsys.readouterr().err


def test_main_serves_tunes_after_the_initial_syncs_and_stops_on_sigterm(monkeypatch):
    """``main`` on a fake cluster (the device rule answered with the CPU):
    the GC posture is applied once, after the CRD, pod and node informers
    have listed; ``/readyz`` carries the CRD informer's condition; SIGTERM
    ends it with 0."""
    kube = FakeKubeClient()
    kube.add_node(builders.make_node("n0"))
    kube.add_pod(builders.make_pod("p0", labels={"telemetry-policy": "pol"}))
    list_pods = kube.list_pods
    # a pod list that takes a while, as ~165,000 pods do
    kube.list_pods = lambda *args, **kwargs: (time.sleep(0.5), list_pods(*args, **kwargs))[1]
    parts, servers, handlers, synced_at_tune = [], [], {}, []
    real_assemble, real_build_server = tas.assemble, tas.build_server

    def assemble(*args, **kwargs):
        parts.extend(real_assemble(*args, **kwargs))
        return tuple(parts)

    def tune():
        extender, controller = parts[2], parts[3]
        informers = [controller.informer, *extender.planner.feed.informers]
        synced_at_tune.append([informer.has_synced() for informer in informers])

    monkeypatch.setattr(tas, "resolve_device", lambda _device: torch.device("cpu"))
    monkeypatch.setattr(tas, "get_kube_client", lambda _path: kube)
    monkeypatch.setattr(tas, "assemble", assemble)
    monkeypatch.setattr(tas, "build_server", lambda ext: servers.append(real_build_server(ext)) or servers[-1])
    monkeypatch.setattr(tas, "tune_for_serving", tune)
    monkeypatch.setattr(tas.signal, "signal", lambda sig, handler: handlers.__setitem__(sig, handler))
    readyz = []

    def operator():
        try:
            if wait_until(lambda: synced_at_tune and servers and servers[0].wait_ready(0.01), 30):
                url = f"http://127.0.0.1:{servers[0].port}/readyz"
                try:
                    with urllib.request.urlopen(url, timeout=10) as resp:
                        readyz.append(resp.read())
                except urllib.error.HTTPError as err:  # a 503 /readyz is still an answer
                    readyz.append(err.read())
        finally:
            wait_until(lambda: tas.signal.SIGTERM in handlers, 30)
            handlers[tas.signal.SIGTERM](tas.signal.SIGTERM, None)

    helper = threading.Thread(target=operator, daemon=True)
    helper.start()
    verbosity = tas.klog._verbosity
    try:
        assert tas.main(["--unsafe", "--port=0", "--syncPeriod=50ms", "--batchPlanner", "--nodeCacheCapable"]) == 0
    finally:
        tas.klog.set_verbosity(verbosity)
        if parts:
            parts[5].set()
    helper.join(10)
    assert synced_at_tune == [[True, True, True]]
    conditions = {c["name"]: c for c in json.loads(readyz[0])["conditions"]}
    assert conditions["policy_informer_synced"]["ok"] is True


def test_main_stops_on_sigterm_while_an_initial_list_hangs(monkeypatch):
    """An API server that never answers the pod list (the informers
    never sync) does not hold ``main`` past SIGTERM, and the GC posture
    is not applied to a service that is going away."""
    kube = FakeKubeClient()
    kube.add_node(builders.make_node("n0"))
    released = threading.Event()
    list_pods = kube.list_pods
    kube.list_pods = lambda *args, **kwargs: (released.wait(60), list_pods(*args, **kwargs))[1]
    parts, handlers, tuned = [], {}, []
    real_assemble = tas.assemble

    def assemble(*args, **kwargs):
        parts.extend(real_assemble(*args, **kwargs))
        return tuple(parts)

    monkeypatch.setattr(tas, "resolve_device", lambda _device: torch.device("cpu"))
    monkeypatch.setattr(tas, "get_kube_client", lambda _path: kube)
    monkeypatch.setattr(tas, "assemble", assemble)
    monkeypatch.setattr(tas, "tune_for_serving", lambda: tuned.append(True))
    monkeypatch.setattr(tas.signal, "signal", lambda sig, handler: handlers.__setitem__(sig, handler))

    def operator():
        wait_until(lambda: tas.signal.SIGTERM in handlers, 30)
        handlers[tas.signal.SIGTERM](tas.signal.SIGTERM, None)

    threading.Thread(target=operator, daemon=True).start()
    verbosity = tas.klog._verbosity
    start = time.monotonic()
    try:
        assert tas.main(["--unsafe", "--port=0", "--syncPeriod=50ms", "--batchPlanner", "--nodeCacheCapable"]) == 0
        assert time.monotonic() - start < 30
    finally:
        tas.klog.set_verbosity(verbosity)
        released.set()
        if parts:
            parts[5].set()
    assert tuned == []


def test_decision_and_event_flags_configure_the_logs():
    try:
        args = tas.build_arg_parser().parse_args(
            ["--decisionLog=off", "--decisionLogSize=7", "--events=off", "--eventsSize=9"]
        )
        common.configure_decisions(args)
        common.configure_events(args)
        assert not decisions.DECISIONS.enabled and decisions.DECISIONS.capacity == 7
        assert not events.JOURNAL.enabled and events.JOURNAL.capacity == 9
        snapshot = decisions.DECISIONS.snapshot()
        assert snapshot["enabled"] is False and snapshot["records"] == []
    finally:
        defaults = tas.build_arg_parser().parse_args([])
        common.configure_decisions(defaults)
        common.configure_events(defaults)
    assert decisions.DECISIONS.enabled and decisions.DECISIONS.capacity == 512
    assert events.JOURNAL.enabled and events.JOURNAL.capacity == 4096


def test_fault_tolerance_from_the_flags():
    args = tas.build_arg_parser().parse_args(["--retryMaxAttempts=2", "--retryBaseDelay=5ms"])
    policy, breakers = common.build_fault_tolerance(args)
    jax_policy, jax_breakers = jax_tas.common.build_fault_tolerance(jax_tas.build_arg_parser().parse_args(
        ["--retryMaxAttempts=2", "--retryBaseDelay=5ms"]
    ))
    assert (policy.max_attempts, policy.base_delay_s, policy.max_delay_s, policy.deadline_s) == (
        jax_policy.max_attempts,
        jax_policy.base_delay_s,
        jax_policy.max_delay_s,
        jax_policy.deadline_s,
    )
    assert (breakers.failure_threshold, breakers.reset_timeout_s) == (
        jax_breakers.failure_threshold,
        jax_breakers.reset_timeout_s,
    )
    wrapped = common.wrap_kube_client(FakeKubeClient(), policy, breakers)
    assert isinstance(wrapped, FaultTolerantClient) and wrapped.list_nodes() == []


# -- the tests/test_e2e.py scenarios on twin assemblies -------------------------------------

SYNC_PERIOD_S = 0.05
NODES = ("kind-worker", "kind-worker2", "kind-worker3")
METRICS = {
    "filter1_metric": {"kind-worker": 90, "kind-worker2": 20, "kind-worker3": 70},
    "prioritize1_metric": {"kind-worker": 10, "kind-worker2": 9999, "kind-worker3": 50},
    "deschedule1_metric": {"kind-worker": 1, "kind-worker2": 9, "kind-worker3": 2},
}


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def fake_world(jax: bool):
    """A fake API server holding the three nodes and their metrics."""
    fake_cls, make_node = (JaxFake, jax_builders.make_node) if jax else (FakeKubeClient, builders.make_node)
    kube = fake_cls()
    for name in NODES:
        kube.add_node(make_node(name))
    for metric, per_node in METRICS.items():
        for node, value in per_node.items():
            kube.set_node_metric(metric, node, str(value))
    return kube


def join_threads_started_since(before, fakes, timeout=20.0):
    """Join every thread started since the snapshot ``before``; none may
    outlive its stop.  A fake's idle watch blocks its informer until the
    next event, so each hub first gets one event that a stopped informer
    returns on before reading it."""
    for kube in fakes:
        for hub in kube._hubs.values():
            hub.publish("BOOKMARK", {})
    deadline = time.monotonic() + timeout
    started = [t for t in threading.enumerate() if t not in before]
    for thread in started:
        thread.join(max(0.0, deadline - time.monotonic()))
    assert not [t for t in started if t.is_alive()], "threads still running after their stop"


LEASE_S = 15.0


class Service:
    """One package's service over a fake API server, assembled as its
    ``main`` assembles it: a fault-tolerant client with the circuit
    breakers of the default flags, the degraded-mode controller over them
    and, given an ``identity``, a lease elector on ``clock``, which the
    test ticks.  A FaultPlan with no faults between the fault-tolerant
    client and the fake counts this replica's calls by verb."""

    def __init__(self, jax: bool, kube=None, identity=None, clock=None):
        self.kube = fake_world(jax) if kube is None else kube
        pkg = jax_tas if jax else tas
        args = pkg.build_arg_parser().parse_args([])
        policy, self.breakers = pkg.common.build_fault_tolerance(args)
        self.calls = JaxPlan() if jax else FaultPlan()
        api = pkg.common.wrap_kube_client((JaxFaulty if jax else FaultyClient)(self.kube, self.calls), policy, self.breakers)
        self.elector = None
        if identity is not None:
            self.elector = (JaxElector if jax else LeaseElector)(
                api, identity, lease_name="tas", lease_duration_s=LEASE_S, clock=clock.now
            )
        wiring = {"breakers": self.breakers, "degraded_mode": args.degradedMode, "leadership": self.elector}
        if jax:
            parts = jax_tas.assemble(api, JaxMetricsClient(api), SYNC_PERIOD_S, **wiring)
            self.server = jax_tas.build_server(parts[2])
        else:
            parts = tas.assemble(api, CustomMetricsClient(api), SYNC_PERIOD_S, device="cpu", **wiring)
            self.server = tas.build_server(parts[2])
        self.cache, self.mirror, self.extender, self.controller, self.enforcer, self.stop = parts
        # the 1 s freshness bound of a 50 ms period is shorter than a loaded
        # test worker may starve the refresh thread; a starved side would
        # degrade while its twin does not
        self.cache.freshness_max_age_s = 10.0
        self.cycles = []  # one entry a deschedule cycle, published by every branch
        self.enforcer.violation_observers.append(lambda kind, violations: self.cycles.append(dict(violations)))
        threading.Thread(
            target=lambda: self.server.start_server(port="0", unsafe=True, host="127.0.0.1", block=True),
            daemon=True,
        ).start()
        assert self.server.wait_ready()

    def call(self, verb, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.server.port}/scheduler/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            resp = urllib.request.urlopen(req, timeout=10)
            return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def label(self, node, policy):
        return self.kube.get_node(node).get_labels().get(policy)

    def close(self):
        self.stop.set()
        self.server.shutdown()


class TwinServices:
    def __init__(self):
        self.threads = set(threading.enumerate())
        self.jax, self.port = Service(True), Service(False)
        self.sides = (self.jax, self.port)

    def close(self):
        for side in self.sides:
            side.close()
        join_threads_started_since(self.threads, [side.kube for side in self.sides])

    def crd(self, op, *args):
        for side in self.sides:
            getattr(side.kube, op)(*[json.loads(json.dumps(a)) for a in args])

    def call(self, verb, payload):
        """The port's answer, after checking it equals the JAX one."""
        got, want = self.port.call(verb, payload), self.jax.call(verb, payload)
        assert got == want, (verb, got, want)
        return got

    def until(self, pred, timeout=30.0):
        return all(wait_until(lambda s=side: pred(s), timeout) for side in self.sides)

    def labels(self):
        got = {n: self.port.kube.get_node(n).get_labels() for n in NODES}
        assert got == {n: self.jax.kube.get_node(n).get_labels() for n in NODES}
        return got


@pytest.fixture()
def twins(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")  # the JAX wire path the port serves
    services = TwinServices()
    yield services
    services.close()


def sched_args(policy_name):
    return {
        "Pod": {"metadata": {"name": "demo-pod", "namespace": "default", "labels": {"telemetry-policy": policy_name}}},
        "Nodes": {"items": [{"metadata": {"name": n}} for n in NODES]},
    }


def demo_policy(name="e2e-policy"):
    return builders.make_policy(
        name,
        strategies={
            "dontschedule": [builders.rule("filter1_metric", "GreaterThan", 40)],
            "scheduleonmetric": [builders.rule("prioritize1_metric", "GreaterThan", 0)],
            "deschedule": [builders.rule("deschedule1_metric", "GreaterThan", 8)],
        },
    )


def policy_ready(side, name="e2e-policy"):
    status, body = side.call("filter", sched_args(name))
    return status == 200 and json.loads(body).get("FailedNodes")


class TestE2EParity:
    def test_filter(self, twins):
        twins.crd("create_taspolicy", demo_policy())
        assert twins.until(policy_ready)
        status, body = twins.call("filter", sched_args("e2e-policy"))
        assert status == 200
        out = json.loads(body)
        assert out["NodeNames"] == ["kind-worker2", ""]
        assert set(out["FailedNodes"]) == {"kind-worker", "kind-worker3"}

    def test_prioritize(self, twins):
        twins.crd("create_taspolicy", demo_policy())
        assert twins.until(policy_ready)
        assert twins.until(lambda s: json.loads(s.call("prioritize", sched_args("e2e-policy"))[1]))
        status, body = twins.call("prioritize", sched_args("e2e-policy"))
        assert status == 200
        out = json.loads(body)
        assert out[0] == {"Host": "kind-worker2", "Score": 10} and len(out) == 3

    def test_deschedule_labels_node_then_clears(self, twins):
        twins.crd("create_taspolicy", demo_policy())
        assert twins.until(policy_ready)
        assert twins.until(lambda s: s.label("kind-worker2", "e2e-policy") == "violating")
        labels = twins.labels()
        assert all(labels[n].get("e2e-policy") in (None, "null") for n in ("kind-worker", "kind-worker3"))
        for side in twins.sides:
            side.kube.set_node_metric("deschedule1_metric", "kind-worker2", "1")
        assert twins.until(lambda s: s.label("kind-worker2", "e2e-policy") == "null")
        assert twins.labels()["kind-worker2"] == {"e2e-policy": "null"}

    def test_add_and_delete_policy_churn(self, twins):
        for round_ in range(5):
            twins.crd("create_taspolicy", demo_policy())
            assert twins.until(policy_ready), round_
            status, body = twins.call("filter", sched_args("e2e-policy"))
            assert json.loads(body)["NodeNames"] == ["kind-worker2", ""], round_
            twins.crd("delete_taspolicy", "default", "e2e-policy")
            assert twins.until(lambda s: json.loads(s.call("filter", sched_args("e2e-policy"))[1]) is None, 5.0)
            assert twins.call("filter", sched_args("e2e-policy")) == (404, b"null\n")
        assert twins.port.cache.registered_metric_names() == []

    def test_unknown_policy_and_readiness(self, twins):
        assert twins.call("filter", sched_args("ghost-policy")) == (404, b"null\n")
        twins.call("prioritize", sched_args("ghost-policy"))
        port = twins.port
        assert port.controller.informer.has_synced()
        assert port.mirror.device.type == "cpu" and port.extender.planner is None
        # main's wiring: one degraded-mode controller over the client's breakers
        assert port.extender.degraded is port.enforcer.degraded
        assert port.extender.degraded.breakers is port.breakers and port.enforcer.leadership is None


# -- two replicas with leader election on one fake, against a JAX pair ----------------------


class ReplicaPair:
    """Two replicas of one package on one fake API server, each assembled
    as ``main`` assembles it with ``--leaderElect``; their electors share
    one FakeClock and are ticked by the test."""

    def __init__(self, jax: bool):
        self.kube = fake_world(jax)
        self.clock = (JaxClock if jax else FakeClock)()
        self.a = Service(jax, self.kube, "replica-a", self.clock)
        self.b = Service(jax, self.kube, "replica-b", self.clock)

    def lease(self):
        """The lease object as JSON, without the fake's resourceVersion
        (a count of every write the fake took)."""
        lease = self.kube.get_lease("default", "tas")
        lease["metadata"].pop("resourceVersion")
        return lease

    def labels(self):
        return {n: self.kube.get_node(n).get_labels() for n in NODES}


def wait_for_cycles(replica, count, timeout=30.0):
    """Wait until ``replica`` has run ``count`` more deschedule cycles."""
    seen = len(replica.cycles)
    return wait_until(lambda: len(replica.cycles) >= seen + count, timeout)


def test_two_replicas_label_once_and_fail_over_like_the_jax_pair():
    """The follower evaluates and publishes every cycle and writes no
    patch; after the leader crashes (its loops stop, its lease is not
    released) the follower takes over once the lease runs out, with the
    fencing token one higher, and labels the cluster.  Roles, tokens,
    lease objects and labels equal the JAX pair's at every step."""
    threads = set(threading.enumerate())
    pairs = [ReplicaPair(True), ReplicaPair(False)]
    try:
        for pair in pairs:
            assert pair.a.elector.tick() is True and pair.b.elector.tick() is False
        jax_pair, port_pair = pairs
        assert port_pair.lease() == jax_pair.lease()
        for pair in pairs:
            pair.kube.create_taspolicy(demo_policy())
        assert all(wait_until(lambda p=p: p.labels()["kind-worker2"].get("e2e-policy") == "violating") for p in pairs)
        for pair in pairs:
            assert wait_for_cycles(pair.b, 3)
            assert pair.b.calls.call_count("patch_node") == 0 and pair.a.calls.call_count("patch_node") > 0
            # the follower's published violations are the leader's
            assert pair.b.cycles[-1] == {"kind-worker2": ["e2e-policy"]}
        assert port_pair.labels() == jax_pair.labels()

        # the leader crashes; its lease is not released
        for pair in pairs:
            pair.a.close()
            pair.kube.set_node_metric("deschedule1_metric", "kind-worker2", "1")
        for pair in pairs:
            assert wait_for_cycles(pair.b, 3)
            # the lease is live on the clock: the follower still follows
            assert pair.b.elector.tick() is False and pair.b.calls.call_count("patch_node") == 0
            assert pair.labels()["kind-worker2"]["e2e-policy"] == "violating"
            pair.clock.advance(LEASE_S)
            assert pair.a.elector.is_leader() is False  # its own grant lapsed
            assert pair.b.elector.tick() is True and pair.b.elector.fencing_token() == 2
        assert all(wait_until(lambda p=p: p.labels()["kind-worker2"].get("e2e-policy") == "null") for p in pairs)
        assert port_pair.lease() == jax_pair.lease()
        assert port_pair.lease()["spec"]["holderIdentity"] == "replica-b"
        assert port_pair.labels() == jax_pair.labels()
        assert [p.a.calls.call_count("patch_node") > 0 for p in pairs] == [True, True]
    finally:
        for pair in pairs:
            for replica in (pair.a, pair.b):
                replica.close()
        join_threads_started_since(threads, [pair.kube for pair in pairs])


def test_main_builds_the_degraded_controller_and_the_elector(monkeypatch):
    """``main`` with ``--leaderElect`` on a fake cluster: ``/readyz``
    carries the ``degraded_mode`` and ``leadership`` conditions after the
    extender's own, and ``/debug/leader`` answers the elector's state."""
    kube = FakeKubeClient()
    kube.add_node(builders.make_node("n0"))
    parts, servers, handlers, answers = [], [], {}, {}
    real_assemble, real_build_server = tas.assemble, tas.build_server

    def assemble(*args, **kwargs):
        parts.extend(real_assemble(*args, **kwargs))
        return tuple(parts)

    monkeypatch.setattr(tas, "resolve_device", lambda _device: torch.device("cpu"))
    monkeypatch.setattr(tas, "get_kube_client", lambda _path: kube)
    monkeypatch.setattr(tas, "assemble", assemble)
    monkeypatch.setattr(tas, "build_server", lambda ext: servers.append(real_build_server(ext)) or servers[-1])
    monkeypatch.setattr(tas, "tune_for_serving", lambda: None)
    monkeypatch.setattr(tas.signal, "signal", lambda sig, handler: handlers.__setitem__(sig, handler))

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{servers[0].port}{path}", timeout=10) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def operator():
        try:
            leading = lambda: parts and parts[2].leadership.is_leader()  # noqa: E731
            if wait_until(lambda: servers and servers[0].wait_ready(0.01) and leading(), 30):
                answers["readyz"] = get("/readyz")
                answers["leader"] = get("/debug/leader")
        finally:
            wait_until(lambda: tas.signal.SIGTERM in handlers, 30)
            handlers[tas.signal.SIGTERM](tas.signal.SIGTERM, None)

    threads = set(threading.enumerate())
    helper = threading.Thread(target=operator, daemon=True)
    helper.start()
    verbosity = tas.klog._verbosity
    argv = ["--unsafe", "--port=0", "--syncPeriod=50ms", "--leaderElect", "--replicaId=r0",
            "--leaseRenewPeriod=50ms", "--degradedMode=fail-closed"]
    try:
        assert tas.main(argv) == 0
    finally:
        tas.klog.set_verbosity(verbosity)
        if parts:
            parts[5].set()
    helper.join(10)
    join_threads_started_since(threads, [kube])
    extender, enforcer = parts[2], parts[4]
    assert extender.degraded is enforcer.degraded and extender.degraded.mode == "fail-closed"
    assert enforcer.leadership is extender.leadership and extender.leadership.identity == "r0"
    _status, body = answers["readyz"]
    names = [c["name"] for c in json.loads(body)["conditions"]]
    assert names[names.index("telemetry_fresh") + 1:][:2] == ["degraded_mode", "leadership"]
    status, body = answers["leader"]
    leader = json.loads(body)
    assert status == 200 and leader["role"] == "leader" and leader["fencing_token"] == 1
    assert leader["lease"]["holder"] == "r0" and leader["lease"]["renew_period_s"] == 0.05


# -- BatchPlanner.watch against the JAX planner's -------------------------------------------


def _planner_world(jax: bool):
    fake_cls, mod = (JaxFake, jax_builders) if jax else (FakeKubeClient, builders)
    kube = fake_cls()
    for i in range(6):
        kube.add_node(mod.make_node(f"n{i}", allocatable={"pods": str(2 + i % 3)}))
    for i in range(8):
        kube.add_pod(mod.make_pod(f"p{i}", labels={"telemetry-policy": "pol"}))
    for i in range(5):
        kube.add_pod(mod.make_pod(f"b{i}", node_name=f"n{i % 3}", phase="Running"))
    kube.add_pod(mod.make_pod("unlabelled"))
    kube.add_pod(mod.make_pod("done", labels={"telemetry-policy": "pol"}, phase="Succeeded"))
    cache = JaxCache() if jax else AutoUpdatingCache()
    mirror = JaxMirror() if jax else TensorStateMirror(device="cpu")
    mirror.attach(cache)
    policy = builders.make_policy(
        "pol",
        strategies={
            "scheduleonmetric": [builders.rule("m0", "GreaterThan", 0)],
            "dontschedule": [builders.rule("m0", "GreaterThan", 95)],
        },
    )
    node_metric, quantity = (JaxNodeMetric, JaxQuantity) if jax else (NodeMetric, Quantity)
    cache.write_policy("default", "pol", (JaxPolicy if jax else TASPolicy).from_obj(policy))
    cache.write_metric("m0", {f"n{i}": node_metric(value=quantity(str(v))) for i, v in enumerate([5, 50, 96, 70, 30, 60])})
    planner = JaxPlanner(cache, mirror) if jax else BatchPlanner(cache, mirror, device="cpu")
    return kube, planner, mod


def _planner_state(planner):
    with planner._lock, planner._cap_lock:
        return list(planner._pending), dict(planner._node_alloc), dict(planner._bound_counts), dict(planner._bound_pods)


def test_planner_watch_matches_the_jax_planner():
    sides = [_planner_world(True), _planner_world(False)]
    handles = [planner.watch(kube) for kube, planner, _mod in sides]
    assert all(h.wait_for_cache_sync(10) for h in handles)

    def converged(pred):
        ok = wait_until(lambda: all(pred(kube, planner) for kube, planner, _mod in sides), 10)
        return ok and wait_until(lambda: _planner_state(sides[0][1]) == _planner_state(sides[1][1]), 10)

    try:
        assert converged(lambda kube, planner: len(planner._pending) == 8)
        assert sides[1][1].pending_keys() == [f"default&p{i}" for i in range(8)]
        for kube, _planner, mod in sides:
            kube.bind_pod("default", "p0", "uid-default-p0", "n4")
            kube.delete_pod("default", "b0")
            kube.add_pod(mod.make_pod("p9", labels={"telemetry-policy": "pol"}))
            relabelled = kube.get_pod("default", "p2")
            relabelled.raw["metadata"]["labels"] = {}
            kube.update_pod(relabelled)
            kube.delete_node("n5")
            kube.add_node(mod.make_node("n6", allocatable={"pods": "1"}))
        assert converged(
            lambda kube, planner: "default&p9" in planner._pending
            and "n6" in planner._node_alloc
            and "n5" not in planner._node_alloc
            and "default&p2" not in planner._pending
        )
        pending, alloc, bound, _pods = _planner_state(sides[1][1])
        assert "default&p0" not in pending and bound["n4"] == 1 and alloc["n6"] == 1
        for _kube, planner, _mod in sides:
            planner.replan()
        pods = [Pod(p.raw) for p in sides[1][0].list_pods()]
        jax_pods = sides[0][0].list_pods()
        assert [sides[1][1].planned_node(p) for p in pods] == [sides[0][1].planned_node(p) for p in jax_pods]
        assert any(sides[1][1].planned_node(p) for p in pods)
    finally:
        for h in handles:
            h.stop()


def test_batch_solver_sinkhorn_reaches_the_planner(monkeypatch):
    """``--batchSolver=sinkhorn`` parses as the JAX main's flag does, and
    ``assemble(batch_solver=...)`` builds a planner whose replan loop
    solves with Sinkhorn: two pods, one slot a node, both placed."""
    from platform_aware_scheduling_tpu_torch.ops import sinkhorn

    argv = ["--batchPlanner", "--batchSolver=sinkhorn"]
    args = tas.build_arg_parser().parse_args(argv)
    assert args.batchSolver == jax_tas.build_arg_parser().parse_args(argv).batchSolver == "sinkhorn"
    kube = FakeKubeClient()
    for name, value in (("n1", 100), ("n2", 99)):
        kube.add_node(builders.make_node(name, allocatable={"pods": "1"}))
        kube.set_node_metric("m", name, str(value))
    pods = [builders.make_pod(f"p{i}", labels={"telemetry-policy": "pol"}) for i in range(2)]
    for pod in pods:
        kube.add_pod(pod)
    kube.create_taspolicy(builders.make_policy("pol", strategies={"scheduleonmetric": [builders.rule("m", "GreaterThan", 0)]}))
    solves = []
    real = sinkhorn.sinkhorn_assign
    monkeypatch.setattr(sinkhorn, "sinkhorn_assign", lambda *a, **kw: solves.append(1) or real(*a, **kw))
    threads = set(threading.enumerate())
    parts = tas.assemble(
        kube, CustomMetricsClient(kube), 0.05, enable_batch_planner=args.batchPlanner,
        batch_solver=args.batchSolver, device="cpu",
    )
    try:
        planner = parts[2].planner
        assert planner.solver == "sinkhorn"
        placed = lambda: {planner.planned_node(Pod(p.raw)) for p in pods}  # noqa: E731
        assert wait_until(lambda: placed() == {"n1", "n2"}, 30)
        assert solves
    finally:
        parts[5].set()
        join_threads_started_since(threads, [kube])
