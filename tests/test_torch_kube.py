"""The port's kube layer (``kube/retry.py``, ``kube/informer.py``,
``kube/client.py``, ``testing/fake_kube.py``) held exactly against the JAX
package's: the same inputs, the same failures and the same events go to
both, and every delay, state, counter, handler call, request and object
must be equal."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from platform_aware_scheduling_tpu.kube import client as jax_client
from platform_aware_scheduling_tpu.kube import informer as jax_informer
from platform_aware_scheduling_tpu.kube import retry as jax_retry
from platform_aware_scheduling_tpu.tas import metrics as jax_metrics
from platform_aware_scheduling_tpu.testing import fake_kube as jax_fake
from platform_aware_scheduling_tpu.utils.tracing import CounterSet as JaxCounterSet
from platform_aware_scheduling_tpu_torch.kube import client, informer, retry
from platform_aware_scheduling_tpu_torch.tas import metrics
from platform_aware_scheduling_tpu_torch.testing import fake_kube
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

PORT = (client, retry, informer, metrics, fake_kube, CounterSet)
JAX = (jax_client, jax_retry, jax_informer, jax_metrics, jax_fake, JaxCounterSet)


def counter_tables(counters):
    return counters._counters, counters._gauges


# -- kube/retry.py ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_backoff_delay(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        attempt = int(rng.integers(-2, 40))
        base = float(rng.choice([0.001, 0.1, 0.2, 1.5]))
        cap = float(rng.choice([0.05, 5.0, 30.0]))
        s = int(rng.integers(0, 2**31))
        assert retry.backoff_delay(attempt, base, cap, seed=s) == jax_retry.backoff_delay(
            attempt, base, cap, seed=s
        )


@pytest.mark.parametrize("verb", ["list_nodes", "get_node_metric", "bind_pod", "watch_pods", ""])
def test_retry_policy_and_hash(verb):
    policy = retry.RetryPolicy(seed=7, verb_deadlines={"list_nodes": 3.0})
    jax_policy = jax_retry.RetryPolicy(seed=7, verb_deadlines={"list_nodes": 3.0})
    assert retry.stable_hash(verb) == jax_retry.stable_hash(verb)
    assert policy.deadline_for(verb) == jax_policy.deadline_for(verb)
    for attempt in range(1, 9):
        for after in (None, 0.0, 0.05, 2.0, 60.0):
            assert policy.backoff(attempt, verb, after) == jax_policy.backoff(attempt, verb, after)


def _exceptions(pkg):
    """The same failures, built from one package's own classes."""
    kube, rt, _informer, mets, _fake, _counters = pkg
    caused = mets.MetricsError("unable to fetch")
    caused.__cause__ = kube.KubeError("GET: HTTP 503", status=503)
    refused = mets.MetricsError("unable to fetch")
    refused.__cause__ = kube.NotFoundError("gone", status=404)
    return [
        kube.KubeError("transport", status=0),
        kube.KubeError("throttled", status=429, retry_after=2.0),
        kube.KubeError("server", status=500),
        kube.KubeError("unavailable", status=503),
        kube.KubeError("bad request", status=400),
        kube.KubeError("forbidden", status=403),
        kube.NotFoundError("missing", status=404),
        kube.ConflictError("conflict", status=409),
        rt.CircuitOpenError("kube"),
        TimeoutError("timed out"),
        ConnectionResetError("reset"),
        OSError("os"),
        mets.MetricsError("no metrics returned from custom metrics API"),
        caused,
        refused,
        ValueError("a bug"),
    ]


def test_retry_reason_and_circuit_failure():
    for mine, theirs in zip(_exceptions(PORT), _exceptions(JAX)):
        assert retry.retry_reason(mine) == jax_retry.retry_reason(theirs), repr(mine)
        assert retry.circuit_failure(mine) == jax_retry.circuit_failure(theirs), repr(mine)


def test_verb_group():
    verbs = sorted(retry.READ_VERBS | retry.WRITE_VERBS | retry.FENCED_WRITE_VERBS) + ["watch_pods"]
    assert retry.READ_VERBS == jax_retry.READ_VERBS
    assert retry.WRITE_VERBS == jax_retry.WRITE_VERBS
    assert retry.FENCED_WRITE_VERBS == jax_retry.FENCED_WRITE_VERBS
    assert [retry.verb_group(v) for v in verbs] == [jax_retry.verb_group(v) for v in verbs]


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seed", range(6))
def test_circuit_breaker_state_machine(seed):
    """A seeded sequence of allow / success / failure / clock steps drives
    both breakers; every answer, state and counter stays equal."""
    rng = np.random.default_rng(seed)
    clock, jax_clock = _Clock(), _Clock()
    counters, jax_counters = CounterSet(), JaxCounterSet()
    threshold, reset = int(rng.integers(1, 5)), float(rng.choice([0.5, 2.0]))
    mine = retry.CircuitBreaker("kube", threshold, reset, clock=clock, counters=counters)
    theirs = jax_retry.CircuitBreaker("kube", threshold, reset, clock=jax_clock, counters=jax_counters)
    for _ in range(300):
        op = rng.choice(["allow", "success", "failure", "failure", "tick"])
        if op == "allow":
            assert mine.allow() == theirs.allow()
        elif op == "success":
            mine.record_success()
            theirs.record_success()
        elif op == "failure":
            mine.record_failure()
            theirs.record_failure()
        else:
            dt = float(rng.choice([0.1, 0.4, 1.0, 2.5]))
            clock.now += dt
            jax_clock.now += dt
        assert mine.state == theirs.state
    assert counter_tables(counters) == counter_tables(jax_counters)
    assert (retry.STATE_CLOSED, retry.STATE_HALF_OPEN, retry.STATE_OPEN) == (
        jax_retry.STATE_CLOSED,
        jax_retry.STATE_HALF_OPEN,
        jax_retry.STATE_OPEN,
    )


def test_breaker_registry_groups():
    clock, jax_clock = _Clock(), _Clock()
    reg = retry.CircuitBreakerRegistry(2, 1.0, clock=clock, counters=CounterSet())
    jax_reg = jax_retry.CircuitBreakerRegistry(2, 1.0, clock=jax_clock, counters=JaxCounterSet())
    for r in (reg, jax_reg):
        r.breaker("kube").record_failure()
        r.breaker("kube").record_failure()
        r.breaker("metrics").record_success()
    assert reg.states() == jax_reg.states() == {"kube": "open", "metrics": "closed"}
    assert reg.open_groups() == jax_reg.open_groups()
    clock.now += 1.0
    jax_clock.now += 1.0
    assert reg.states() == jax_reg.states()


#: scripted outcomes of an inner client's calls: an exception spec or "ok"
SCRIPTS = {
    "list_nodes": [("kube", 503), ("kube", 429, 0.7), "ok"],
    "get_node": [("kube", 0), ("kube", 0), ("kube", 0), ("kube", 0), ("kube", 0)],
    "get_pod": [("notfound",), "ok"],
    "patch_node": [("kube", 500), "ok"],
    "bind_pod": [("conflict",)],
    "get_node_custom_metric": [("kube", 502), ("kube", 502), "ok"],
    "update_lease": [("kube", 503), "ok"],
}


class _ScriptedInner:
    def __init__(self, pkg):
        self._kube = pkg[0]
        self.script = {verb: list(steps) for verb, steps in SCRIPTS.items()}
        self.calls = []

    def __getattr__(self, verb):
        if verb not in SCRIPTS:
            raise AttributeError(verb)

        def call(*args):
            self.calls.append((verb, args))
            step = self.script[verb].pop(0) if self.script[verb] else "ok"
            if step == "ok":
                return {"verb": verb, "args": list(args)}
            kind = step[0]
            if kind == "notfound":
                raise self._kube.NotFoundError("missing", status=404)
            if kind == "conflict":
                raise self._kube.ConflictError("conflict", status=409)
            raise self._kube.KubeError(f"status {step[1]}", status=step[1], retry_after=(step + (None,))[2])

        return call


def _drive_fault_tolerant(pkg):
    kube, rt, _informer, _mets, _fake, counter_cls = pkg
    clock, sleeps, counters = _Clock(), [], counter_cls()

    def sleep(s):
        sleeps.append(s)
        clock.now += s

    inner = _ScriptedInner(pkg)
    proxy = rt.FaultTolerantClient(
        inner,
        policy=rt.RetryPolicy(max_attempts=4, base_delay_s=0.1, max_delay_s=1.0, deadline_s=3.0),
        breakers=rt.CircuitBreakerRegistry(3, 5.0, clock=clock, counters=counters),
        clock=clock,
        sleep=sleep,
        counters=counters,
    )
    outcomes = []
    for verb in ("list_nodes", "get_node", "get_node", "get_pod", "patch_node", "patch_node",
                 "bind_pod", "get_node_custom_metric", "update_lease", "list_nodes"):
        try:
            outcomes.append(("ok", getattr(proxy, verb)("x")))
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            outcomes.append(("err", type(exc).__name__, getattr(exc, "status", None), str(exc)))
    return outcomes, sleeps, inner.calls, counter_tables(counters), proxy.breakers.states()


def test_fault_tolerant_client():
    assert _drive_fault_tolerant(PORT) == _drive_fault_tolerant(JAX)


# -- kube/informer.py -----------------------------------------------------------------


def _recorder(events, key):
    return dict(
        on_add=lambda obj: events.append(("add", key(obj))),
        on_update=lambda old, new: events.append(("update", key(old), key(new), new == old)),
        on_delete=lambda obj: events.append(("delete", type(obj).__name__, getattr(obj, "key", None))),
    )


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _scripted_informer(pkg):
    """A list-watch that lists {a, b}, watches one change and breaks,
    re-lists {a', c} (b vanished in the gap), then idles."""
    _kube, _rt, inf, _mets, _fake, counter_cls = pkg
    lists = [
        [{"name": "a", "v": 1}, {"name": "b", "v": 1}],
        [{"name": "a", "v": 3}, {"name": "c", "v": 1}],
    ]
    release = threading.Event()
    watches = []

    def list_func():
        return (lists.pop(0) if lists else [{"name": "a", "v": 3}, {"name": "c", "v": 1}]), "7"

    def watch_func(rv):
        n = len(watches)
        watches.append(rv)
        if n == 0:
            yield "MODIFIED", {"name": "a", "v": 2}
            yield "ADDED", {"name": "d", "v": 1}
            yield "DELETED", {"name": "d", "v": 1}
            raise ConnectionResetError("watch broke")
        if n == 1:
            raise ConnectionResetError("watch broke again")
        release.wait(10)

    events, counters = [], counter_cls()
    key = lambda obj: obj["name"]  # noqa: E731
    handlers = _recorder(events, key)
    handlers["on_update"] = lambda old, new: events.append(("update", old["v"], new["v"]))
    subject = inf.Informer(
        inf.ListWatch(list_func, watch_func, key),
        name="scripted",
        counters=counters,
        relist_backoff_base_s=0.001,
        relist_backoff_max_s=0.01,
        **handlers,
    )
    subject.start()
    assert subject.wait_for_cache_sync(10)
    assert _wait(lambda: len(watches) >= 3)
    subject._resync_once()
    subject.stop()
    release.set()
    store = sorted((o["name"], o["v"]) for o in subject.list())
    return events, store, list(subject.relist_backoffs), counter_tables(counters), watches


def test_informer_relist_and_deleted_final_state_unknown():
    got, want = _scripted_informer(PORT), _scripted_informer(JAX)
    assert got == want
    events = got[0]
    assert ("delete", "DeletedFinalStateUnknown", "b") in events
    assert events[:2] == [("add", "a"), ("add", "b")]


def _fake_informer_events(pkg):
    """An informer over the fake API server's nodes: add, patch (update),
    delete, as the planner's node informer sees them."""
    _kube, _rt, inf, _mets, fake_mod, _counters = pkg
    from importlib import import_module

    objects = import_module(fake_mod.__name__.rsplit(".", 2)[0] + ".kube.objects")
    kube = fake_mod.FakeKubeClient()
    kube.add_node({"metadata": {"name": "n1", "labels": {}}})
    events = []
    key = lambda node: node.name  # noqa: E731
    subject = inf.Informer(
        inf.ListWatch(
            lambda: (kube.list_nodes(), ""),
            lambda rv: ((etype, objects.Node(raw)) for etype, raw in kube.watch_nodes()),
            key,
        ),
        **_recorder(events, key),
    )
    subject.start()
    assert subject.wait_for_cache_sync(10)
    kube.add_node({"metadata": {"name": "n2", "labels": {}}})
    assert _wait(lambda: len(events) == 2)
    kube.patch_node("n1", [{"op": "add", "path": "/metadata/labels/pol", "value": "violating"}])
    assert _wait(lambda: len(events) == 3)
    kube.delete_node("n2")
    assert _wait(lambda: len(events) == 4)
    subject.stop()
    labels = subject.get("n1").get_labels()
    return events, labels, sorted(n.name for n in subject.list())


def test_informer_over_the_fake():
    got = _fake_informer_events(PORT)
    assert got == _fake_informer_events(JAX)
    assert got[0] == [("add", "n1"), ("add", "n2"), ("update", "n1", "n1", False), ("delete", "Node", None)]
    assert got[1] == {"pol": "violating"}


def test_informer_counters_and_sync_gauge():
    counters = CounterSet()
    subject = informer.Informer(
        informer.ListWatch(lambda: ([], "1"), lambda rv: iter(threading.Event().wait(5) and ()), str),
        name="empty",
        counters=counters,
    )
    assert counters.get("pas_informer_synced", labels={"informer": "empty"}) == 0
    subject.start()
    assert subject.wait_for_cache_sync(5) and subject.has_synced()
    assert counters.get("pas_informer_synced", labels={"informer": "empty"}) == 1
    assert counters.get("pas_informer_relists_total", labels={"informer": "empty"}) == 1
    assert subject.serialized(lambda: 42) == 42
    subject.stop()


# -- kube/client.py against a local stub of the API server ------------------------------

NODE1 = {"metadata": {"name": "node1", "labels": {"a": "b"}}, "status": {"allocatable": {"pods": "110"}}}
NODE2 = {"metadata": {"name": "node2", "labels": {}}}
POD1 = {"metadata": {"name": "p1", "namespace": "default"}, "spec": {"nodeName": "node1"}}
CRD = "/apis/telemetry.intel.com/v1alpha1"
CM = "/apis/custom.metrics.k8s.io"
METRICS = {
    "kind": "MetricValueList",
    "items": [{"describedObject": {"name": "node1"}, "value": "42m", "timestamp": "t"}],
}

#: (method, path) -> (status, body, extra headers); anything else is a 404
ROUTES = {
    ("GET", "/api/v1/nodes"): (200, {"items": [NODE1, NODE2]}, {}),
    ("GET", "/api/v1/nodes?labelSelector=a%3Db"): (200, {"items": [NODE1]}, {}),
    ("GET", "/api/v1/nodes/node1"): (200, NODE1, {}),
    ("PATCH", "/api/v1/nodes/node1"): (200, NODE1, {}),
    ("GET", "/api/v1/pods"): (200, {"items": [POD1]}, {}),
    ("GET", "/api/v1/namespaces/default/pods"): (200, {"items": [POD1]}, {}),
    ("GET", "/api/v1/namespaces/default/pods/p1"): (200, POD1, {}),
    ("PUT", "/api/v1/namespaces/default/pods/p1"): (409, {"reason": "Conflict"}, {}),
    ("POST", "/api/v1/namespaces/default/pods/p1/binding"): (201, {}, {}),
    ("POST", "/api/v1/namespaces/default/pods/p1/eviction"): (429, {"reason": "TooMany"}, {"Retry-After": "3"}),
    ("GET", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/l1"): (503, "down", {"Retry-After": "x"}),
    ("GET", "/api/v1/namespaces/default/configmaps/c1"): (200, {"data": {"k": "v"}}, {}),
    ("GET", f"{CRD}/taspolicies"): (200, {"items": [], "metadata": {"resourceVersion": "5"}}, {}),
    ("GET", f"{CRD}/namespaces/default/taspolicies/pol"): (200, {"metadata": {"name": "pol"}}, {}),
    ("POST", f"{CRD}/namespaces/default/taspolicies"): (201, {"metadata": {"name": "pol"}}, {}),
    ("PUT", f"{CRD}/namespaces/default/taspolicies/pol"): (200, {"metadata": {"name": "pol"}}, {}),
    ("DELETE", f"{CRD}/namespaces/default/taspolicies/pol"): (200, {}, {}),
    ("GET", f"{CM}/v1beta1/nodes/*/m1"): (200, METRICS, {}),
    ("GET", f"{CM}/v1beta2/nodes/*/m2"): (500, "metrics adapter down", {}),
    ("GET", f"{CM}/v1beta1/nodes/*/m2"): (500, "metrics adapter down", {}),
}
WATCH_LINES = [
    {"type": "ADDED", "object": POD1},
    {"type": "MODIFIED", "object": {**POD1, "status": {"phase": "Running"}}},
    {"type": "DELETED", "object": POD1},
]


class _StubAPI(BaseHTTPRequestHandler):
    seen = []

    def _answer(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        self.seen.append(
            (self.command, self.path, self.headers.get("Content-Type"), self.headers.get("Authorization"), body)
        )
        if self.path.startswith("/api/v1/pods?watch=true"):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            for line in WATCH_LINES:
                self.wfile.write(json.dumps(line).encode() + b"\n\n")
            return
        status, payload, headers = ROUTES.get((self.command, self.path), (404, "not here", {}))
        data = payload.encode() if isinstance(payload, str) else json.dumps(payload).encode()
        self.send_response(status)
        for name, value in headers.items():
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _answer

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def stub_api():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubAPI)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


CALLS = [
    ("list_nodes", ()),
    ("list_nodes", ("a=b",)),
    ("get_node", ("node1",)),
    ("get_node", ("ghost",)),
    ("patch_node", ("node1", [{"op": "add", "path": "/metadata/labels/p", "value": "violating"}])),
    ("list_pods", ()),
    ("list_pods", ("default",)),
    ("get_pod", ("default", "p1")),
    ("update_pod", "pod"),
    ("bind_pod", ("default", "p1", "uid-1", "node1")),
    ("evict_pod", ("default", "p1", 5)),
    ("get_lease", ("kube-system", "l1")),
    ("get_configmap", ("default", "c1")),
    ("list_taspolicies", ()),
    ("get_taspolicy", ("default", "pol")),
    ("create_taspolicy", ({"metadata": {"name": "pol", "namespace": "default"}},)),
    ("update_taspolicy", ({"metadata": {"name": "pol", "namespace": "default"}},)),
    ("delete_taspolicy", ("default", "pol")),
    ("get_node_custom_metric", ("m1",)),
    ("get_node_custom_metric", ("m2",)),
    ("watch_pods", ()),
]


def _plain(result):
    if hasattr(result, "raw"):
        return ("object", type(result).__name__, result.raw)
    if isinstance(result, list):
        return [_plain(r) for r in result]
    return result


def _drive_client(kube_mod, host):
    objects_mod = __import__(kube_mod.__name__.rsplit(".", 1)[0] + ".objects", fromlist=["Pod"])
    api = kube_mod.KubeClient(kube_mod.KubeConfig(host=host, token="tok"))
    _StubAPI.seen.clear()
    outcomes = []
    for verb, args in CALLS:
        if args == "pod":
            args = (objects_mod.Pod(dict(POD1)),)
        try:
            result = getattr(api, verb)(*args)
            if verb.startswith("watch_"):
                result = list(result)
            outcomes.append(("ok", verb, _plain(result)))
        except kube_mod.KubeError as exc:
            outcomes.append(("err", verb, type(exc).__name__, exc.status, exc.retry_after, str(exc)))
    return outcomes, list(_StubAPI.seen)


def test_kube_client_against_a_stub_api_server(stub_api):
    got, want = _drive_client(client, stub_api), _drive_client(jax_client, stub_api)
    assert got == want
    outcomes, seen = got
    kinds = {o[1]: o[0] for o in outcomes}
    assert kinds["evict_pod"] == "err" and kinds["watch_pods"] == "ok"
    assert ("err", "evict_pod", "KubeError", 429, 3.0) == outcomes[10][:5]
    assert outcomes[8][2] == "ConflictError" and outcomes[3][2] == "NotFoundError"
    assert all(s[3] == "Bearer tok" for s in seen)


def test_kube_client_transport_error():
    def refused(kube_mod):
        api = kube_mod.KubeClient(kube_mod.KubeConfig(host="http://127.0.0.1:1"), timeout=2)
        with pytest.raises(kube_mod.KubeError) as info:
            api.get_node("n")
        return type(info.value).__name__, info.value.status, str(info.value)

    assert refused(client) == refused(jax_client)


def test_custom_metrics_client_over_the_stub(stub_api):
    def fetch(kube_mod, mets):
        api = kube_mod.KubeClient(kube_mod.KubeConfig(host=stub_api))
        info = mets.CustomMetricsClient(api).get_node_metric("m1")
        out = {n: (str(m.value), m.timestamp, m.window_seconds) for n, m in info.items()}
        with pytest.raises(mets.MetricsError) as err:
            mets.CustomMetricsClient(api).get_node_metric("m2")
        return out, str(err.value)

    assert fetch(client, metrics) == fetch(jax_client, jax_metrics)


# -- testing/fake_kube.py ---------------------------------------------------------------


def _random_patch(rng):
    ops = []
    for _ in range(int(rng.integers(1, 6))):
        leaf = str(rng.choice(["pol", "a~1b", "c~0d", "x", "missing"]))
        path = str(rng.choice(["/metadata/labels/", "/metadata/annotations/", "/spec/deep/"])) + leaf
        kind = str(rng.choice(["add", "replace", "remove", "remove", "move"]))
        op = {"op": kind, "path": path}
        if kind in ("add", "replace"):
            op["value"] = str(rng.choice(["violating", "null", "1"]))
        ops.append(op)
    return ops


@pytest.mark.parametrize("seed", range(5))
def test_apply_json_patch(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        base = {"metadata": {"name": "n", "labels": {"pol": "violating", "x": "1"}}, "spec": None}
        patch = _random_patch(rng)
        mine, theirs = json.loads(json.dumps(base)), json.loads(json.dumps(base))
        outcome = []
        for fn, obj, err in (
            (fake_kube.apply_json_patch, mine, client.KubeError),
            (jax_fake.apply_json_patch, theirs, jax_client.KubeError),
        ):
            try:
                fn(obj, patch)
                outcome.append(("ok", obj))
            except err as exc:
                outcome.append(("err", str(exc), obj))
        assert outcome[0] == outcome[1], patch


def _fake_session(fake_mod, kube_mod):
    kube = fake_mod.FakeKubeClient()
    for i in range(6):
        kube.add_node({"metadata": {"name": f"n{i}", "labels": {"zone": "a" if i % 2 else "b"}}})
    out = []
    for name, patch in [
        ("n1", [{"op": "add", "path": "/metadata/labels/pol", "value": "violating"}]),
        ("n2", [{"op": "add", "path": "/metadata/labels/pol", "value": "violating"}]),
        ("n1", [{"op": "remove", "path": "/metadata/labels/pol"},
                {"op": "add", "path": "/metadata/labels/pol", "value": "null"}]),
        ("n3", [{"op": "remove", "path": "/metadata/labels/pol"}]),
        ("ghost", []),
    ]:
        try:
            out.append(("ok", kube.patch_node(name, patch).raw))
        except kube_mod.KubeError as exc:
            out.append(("err", type(exc).__name__, str(exc)))
    for selector in (None, "pol", "pol=violating", "pol=null", "zone=a", "zone=a,pol", "nope"):
        out.append((selector, sorted(n.name for n in kube.list_nodes(label_selector=selector))))
    kube.add_pod({"metadata": {"name": "p", "namespace": "ns"}, "spec": {}})
    kube.bind_pod("ns", "p", "u", "n0")
    out.append(kube.get_pod("ns", "p").raw)
    kube.set_node_metric("m", "n0", "5", window_seconds=30, timestamp="t0")
    out.append(kube.get_node_custom_metric("m"))
    out.append(kube.node_patches)
    out.append(kube.bindings)
    return out


def test_fake_kube_matches_the_jax_fake():
    assert _fake_session(fake_kube, client) == _fake_session(jax_fake, jax_client)


def test_cache_refresh_error_reason():
    """The cache's bounded refresh-error label, ``circuit_open`` included,
    through a wrapping ``MetricsError`` as the metrics client raises it."""
    from platform_aware_scheduling_tpu.tas import cache as jax_cache
    from platform_aware_scheduling_tpu_torch.tas import cache

    got, want = [], []
    for mine, theirs in zip(_exceptions(PORT), _exceptions(JAX)):
        for reasons, fn, exc, mets in ((got, cache, mine, metrics), (want, jax_cache, theirs, jax_metrics)):
            wrapped = mets.MetricsError("unable to fetch metrics")
            wrapped.__cause__ = exc
            reasons.append((fn._refresh_error_reason(exc), fn._refresh_error_reason(wrapped)))
    assert got == want
    assert ("circuit_open", "circuit_open") in got
