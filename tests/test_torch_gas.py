"""The port's GAS host layer and extender held against the JAX package.

``ResourceMap``, the pod and node helpers and the work queue are compared
case by case.  The extender runs as twins: the JAX ``GASExtender`` over the
JAX ``FakeKubeClient`` and the port's over the port's fake (on the CPU),
fed the same objects, in the ``host``, ``staged`` and ``mirror`` modes of
``tests/test_gas_scheduler.py``.  Filter and Bind answers must be equal
byte for byte, and so must the Bind annotations and pod updates, the
rollback, the cache's bookings after ingestion and replay, and the usage
mirror's state after every event.

No thread is started: each cache is built with ``start=False``, its
informers relist on demand and its work queue is drained in the test's
thread, as the cache's worker would drain it."""

import copy
import json
import threading

import numpy as np
import pytest

from platform_aware_scheduling_tpu.extender.server import HTTPRequest as JaxRequest
from platform_aware_scheduling_tpu.gas import resource_map as jax_rm
from platform_aware_scheduling_tpu.gas import scheduler as jax_sched
from platform_aware_scheduling_tpu.gas import utils as jax_utils
from platform_aware_scheduling_tpu.gas.cache import Cache as JaxCache
from platform_aware_scheduling_tpu.kube import workqueue as jax_workqueue
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.testing import builders as jax_builders
from platform_aware_scheduling_tpu.testing.fake_kube import FakeKubeClient as JaxFake
from platform_aware_scheduling_tpu.utils import decisions as jax_decisions
from platform_aware_scheduling_tpu.utils import events as jax_events
from platform_aware_scheduling_tpu.utils import klog as jax_klog
from platform_aware_scheduling_tpu.utils import trace as jax_trace
from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
from platform_aware_scheduling_tpu_torch.gas import resource_map, scheduler, utils
from platform_aware_scheduling_tpu_torch.gas.cache import Cache
from platform_aware_scheduling_tpu_torch.kube import workqueue
from platform_aware_scheduling_tpu_torch.testing import builders
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
from platform_aware_scheduling_tpu_torch.utils import decisions, events, klog, trace

INT64_MAX = 2**63 - 1
MODES = ("host", "staged", "mirror")


@pytest.fixture(scope="module", autouse=True)
def threads_before_this_file():
    """The threads alive when this file's first test starts (a worker
    imports every test file at collection, before any runs)."""
    return set(threading.enumerate())


@pytest.fixture(autouse=True)
def restore_globals():
    """Both packages' process globals as they were: counters, decision-log
    and event-journal configuration, klog verbosity."""
    saved = []
    for trace_mod, dec, ev, log in ((trace, decisions, events, klog), (jax_trace, jax_decisions, jax_events, jax_klog)):
        counters = trace_mod.COUNTERS
        saved.append((
            counters, copy.deepcopy(counters._counters), copy.deepcopy(counters._gauges),
            dec.DECISIONS, dec.DECISIONS.enabled, dec.DECISIONS.capacity,
            ev.JOURNAL, ev.JOURNAL.enabled, ev.JOURNAL.capacity, log, log._verbosity,
        ))
    yield
    for counters, c, g, log_, enabled, cap, journal, j_enabled, j_cap, klog_mod, verbosity in saved:
        with counters._lock:
            counters._counters, counters._gauges = c, g
        log_.configure(enabled=enabled, capacity=cap)
        journal.configure(enabled=j_enabled, capacity=j_cap)
        klog_mod.set_verbosity(verbosity)


# -- ResourceMap: every case of tests/test_gas_resource_map.py, on both ------------------


def outcome(pkg, ops):
    """Run ``ops`` (callables of a ResourceMap class) on one package:
    (result map, exception class name or None)."""
    rm = None
    try:
        for op in ops:
            rm = op(pkg.ResourceMap, rm)
    except pkg.ResourceMapError as exc:
        return (dict(rm) if rm is not None else None), type(exc).__name__
    return (dict(rm) if rm is not None else None), None


def build(**kw):
    return lambda cls, _rm: cls(**kw)


def call(method, *args):
    def op(cls, rm):
        if method in ("add_rm", "subtract_rm"):
            getattr(rm, method)(cls(args[0]))
        else:
            getattr(rm, method)(*args)
        return rm

    return op


RESOURCE_MAP_CASES = {
    "add new and existing": ([build(), call("add", "r", 5), call("add", "r", 7)], {"r": 12}, None),
    "add negative": ([build(r=1), call("add", "r", -1)], {"r": 1}, "InputError"),
    "add overflow": ([build(r=INT64_MAX), call("add", "r", 1)], {"r": INT64_MAX}, "OverflowError64"),
    "add to missing key": ([build(), call("add", "r", INT64_MAX)], {"r": INT64_MAX}, None),
    "subtract": ([build(r=10), call("subtract", "r", 4)], {"r": 6}, None),
    "subtract clamps": ([build(r=3), call("subtract", "r", 10)], {"r": 0}, None),
    "subtract missing key": ([build(), call("subtract", "ghost", 1)], {}, "InputError"),
    "subtract negative": ([build(r=1), call("subtract", "r", -1)], {"r": 1}, "InputError"),
    "add_rm all or nothing": (
        [build(a=1, b=INT64_MAX), call("add_rm", {"a": 1, "b": 1})], {"a": 1, "b": INT64_MAX}, "OverflowError64"),
    "subtract_rm all or nothing": (
        [build(a=5), call("subtract_rm", {"a": 1, "ghost": 1})], {"a": 5}, "InputError"),
    "add_rm": ([build(a=1), call("add_rm", {"a": 2, "b": 3})], {"a": 3, "b": 3}, None),
    "divide": ([build(a=10, b=7), call("divide", 2)], {"a": 5, "b": 3}, None),
    "divide by one": ([build(a=9), call("divide", 1)], {"a": 9}, None),
    "divide by zero": ([build(a=1), call("divide", 0)], {"a": 1}, "InputError"),
    "divide negatives truncate": ([build(a=-7, b=7), call("divide", 2)], {"a": -3, "b": 3}, None),
}


@pytest.mark.parametrize("name", sorted(RESOURCE_MAP_CASES))
def test_resource_map(name):
    ops, want_map, want_error = RESOURCE_MAP_CASES[name]
    got = outcome(resource_map, ops)
    assert got == outcome(jax_rm, ops)
    assert got == (want_map, want_error)


def test_resource_map_errors_are_value_errors():
    for name in ("InputError", "OverflowError64"):
        assert issubclass(getattr(resource_map, name), ValueError)
    copied = resource_map.deep_copy_node_resources({"card0": resource_map.ResourceMap(a=1)})
    assert copied == jax_rm.deep_copy_node_resources({"card0": jax_rm.ResourceMap(a=1)})


# -- pod and node helpers --------------------------------------------------------------------


def gpu_node(pkg_builders, name, cards=2, i915=2, millicores=2000, memory=4000, label=None):
    labels = {"gpu.intel.com/cards": ".".join(f"card{i}" for i in range(cards))} if label is None else label
    return pkg_builders.make_node(
        name,
        labels=labels,
        allocatable={
            "gpu.intel.com/i915": str(i915),
            "gpu.intel.com/millicores": str(millicores),
            "gpu.intel.com/memory.max": str(memory),
        },
    )


def gpu_pod(pkg_builders, name, i915="1", millicores="500", node_name="", annotations=None,
            phase="Pending", containers=1, extra=None):
    reqs = [{"gpu.intel.com/i915": i915, "gpu.intel.com/millicores": millicores, **(extra or {})}] * containers
    return pkg_builders.make_pod(
        name, container_requests=reqs, node_name=node_name, annotations=annotations, phase=phase
    )


POD_REQUESTS = [
    [{"cpu": "2", "gpu.intel.com/i915": "1", "gpu.intel.com/millicores": "100"}],
    [{"gpu.intel.com/tiles": "500m"}],
    [{"gpu.intel.com/i915": "3", "gpu.intel.com/millicores": "1001"}, {"cpu": "1"}, {}],
    [{"gpu.intel.com/millicores": "1Ki", "gpu.intel.com/memory.max": "9223372036854775808"}],
    [{"cpu": "1"}],
]


@pytest.mark.parametrize("index", range(len(POD_REQUESTS)))
def test_pod_helpers(index):
    reqs = POD_REQUESTS[index]
    pod = builders.make_pod("p", container_requests=reqs)
    jax_pod = jax_builders.make_pod("p", container_requests=reqs)
    got = utils.container_requests(pod)
    assert [dict(r) for r in got] == [dict(r) for r in jax_utils.container_requests(jax_pod)]
    assert utils.has_gpu_resources(pod) == jax_utils.has_gpu_resources(jax_pod)
    for rm, jax_r in zip(got, jax_utils.container_requests(jax_pod)):
        per_gpu, k = scheduler.get_per_gpu_resource_request(rm)
        j_per_gpu, j_k = jax_sched.get_per_gpu_resource_request(jax_r)
        assert (dict(per_gpu), k) == (dict(j_per_gpu), j_k)
    assert scheduler.request_summary(pod) == jax_sched.request_summary(jax_pod)


def test_completed_pods():
    for phase in ("Succeeded", "Failed", "Running", "Pending"):
        assert utils.is_completed_pod(builders.make_pod("p", phase=phase)) == jax_utils.is_completed_pod(
            jax_builders.make_pod("p", phase=phase)
        )
    pod = builders.make_pod("p", phase="Running")
    pod.metadata["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    assert utils.is_completed_pod(pod)
    assert not utils.has_gpu_resources(None)
    assert (utils.CARD_ANNOTATION, utils.TS_ANNOTATION, utils.GPU_LIST_LABEL, utils.GPU_PLUGIN_RESOURCE) == (
        jax_utils.CARD_ANNOTATION, jax_utils.TS_ANNOTATION, jax_utils.GPU_LIST_LABEL, jax_utils.GPU_PLUGIN_RESOURCE
    )


NODE_SHAPES = [
    dict(cards=2, i915=2, millicores=2000),
    dict(cards=3, i915=4, millicores=1001, memory=7),
    dict(cards=1, i915=1, millicores=100, label={}),
    dict(cards=2, i915=2, millicores=2000, label={"gpu.intel.com/cards": "card1.card0.card9"}),
]


@pytest.mark.parametrize("index", range(len(NODE_SHAPES)))
def test_node_helpers(index):
    node = gpu_node(builders, "n", **NODE_SHAPES[index])
    jax_node = gpu_node(jax_builders, "n", **NODE_SHAPES[index])
    gpus = scheduler.get_node_gpu_list(node)
    assert gpus == jax_sched.get_node_gpu_list(jax_node)
    for count in (0, 1, len(gpus)):
        assert dict(scheduler.get_per_gpu_resource_capacity(node, count)) == dict(
            jax_sched.get_per_gpu_resource_capacity(jax_node, count)
        )


CAPACITY_CASES = [
    ({"a": 5}, {"a": 10}, {"a": 5}),
    ({"a": 6}, {"a": 10}, {"a": 5}),
    ({"b": 0}, {"a": 10}, {}),
    ({"a": 0}, {"a": 0}, {}),
    ({"a": -1}, {"a": 10}, {}),
    ({"a": 1}, {"a": 10}, {"a": -1}),
    ({"a": 2}, {"a": INT64_MAX}, {"a": INT64_MAX - 1}),
    ({"a": 2}, {"a": INT64_MAX}, {"a": INT64_MAX - 2}),
]


@pytest.mark.parametrize("index", range(len(CAPACITY_CASES)))
def test_check_resource_capacity(index):
    need, cap, used = CAPACITY_CASES[index]
    got = scheduler.check_resource_capacity(
        resource_map.ResourceMap(need), resource_map.ResourceMap(cap), resource_map.ResourceMap(used)
    )
    assert got == jax_sched.check_resource_capacity(
        jax_rm.ResourceMap(need), jax_rm.ResourceMap(cap), jax_rm.ResourceMap(used)
    )


# -- the work queue ----------------------------------------------------------------------------


def queue_trace(module, counters):
    """One scripted run of a named queue: what get returns, the depth
    gauge and the counters, in order."""
    q = module.WorkQueue(name="gas_pods", counters=counters)
    out = []
    for item in ("a", "b", "a"):  # "a" is deduplicated while pending
        q.add(item)
    out.append(len(q))
    item, shut = q.get(timeout=0)
    out.append((item, shut))
    q.add(item)  # re-added while processing: queued again on done
    out.append(len(q))
    q.done(item)
    q.forget(item)
    out.append(len(q))
    out.append([q.get(timeout=0)[0] for _ in range(2)])
    out.append(q.get(timeout=0))  # empty: (None, False) at once
    q.shut_down()
    q.add("late")  # refused after shutdown
    out.append(q.get(timeout=0))
    labels = {"queue": "gas_pods"}
    out.append({
        name: counters.get(name, labels=labels)
        for name in ("pas_workqueue_adds_total", "pas_workqueue_done_total", "pas_workqueue_depth")
    })
    return out


def test_work_queue_semantics():
    got = queue_trace(workqueue, trace.CounterSet())
    assert got == queue_trace(jax_workqueue, jax_trace.CounterSet())
    assert got[0] == 2 and got[-2] == (None, True)


def test_work_queue_rate_limited_readd():
    """A failed item comes back after its backoff (a timer thread); the
    blocking get waits on the queue's condition, not a sleep loop."""
    q = workqueue.WorkQueue(name="gas_pods", counters=trace.CounterSet(), base_delay=0.001)
    q.add_rate_limited("x")
    q.add_rate_limited("x")
    assert q._failures["x"] == 2
    assert q.get(timeout=10.0) == ("x", False)
    q.done("x")
    q.forget("x")
    assert "x" not in q._failures
    assert q.counters.get("pas_workqueue_retries_total", labels={"queue": "gas_pods"}) == 2
    q.shut_down()


def test_unnamed_queue_is_silent():
    counters = trace.CounterSet()
    q = workqueue.WorkQueue(counters=counters)
    q.add("a")
    q.done(q.get(timeout=0)[0])
    assert counters.prometheus_text() == ""


# -- twin extenders ---------------------------------------------------------------------------------


def replay(cache) -> None:
    """What the cache's threads would do, in this thread: relist both
    informers (the initial list, or a delta sync against the store) and
    drain the work queue into ``_handle_pod`` as the worker does."""
    for informer in (cache._node_informer, cache._pod_informer):
        informer._relist(initial=not informer.has_synced())
        informer._synced.set()
    while True:
        item, _shutdown = cache.work_queue.get(timeout=0)
        if item is None:
            return
        try:
            cache._handle_pod(item)
        except Exception:  # the worker logs and goes on
            pass
        finally:
            cache.work_queue.done(item)
            cache.work_queue.forget(item)


class Side:
    def __init__(self, jax: bool, mode: str):
        self.jax = jax
        self.builders = jax_builders if jax else builders
        self.kube = JaxFake() if jax else FakeKubeClient()
        self.cache = (JaxCache if jax else Cache)(self.kube, start=False)
        self.sleeps = []
        kwargs = dict(
            cache=self.cache,
            use_device=mode != "host",
            use_mirror=mode == "mirror",
            sleep=self.sleeps.append,
        )
        if not jax:
            kwargs["device"] = "cpu"
        self.ext = (jax_sched if jax else scheduler).GASExtender(self.kube, **kwargs)
        self.trace = jax_trace if jax else trace

    def request(self, verb, body):
        cls = JaxRequest if self.jax else HTTPRequest
        return cls("POST", f"/scheduler/{verb}", {"Content-Type": "application/json"}, body)


class Twins:
    """The JAX and the port extender over their own fakes, in one mode."""

    def __init__(self, mode: str):
        self.mode = mode
        self.jax, self.port = Side(True, mode), Side(False, mode)
        self.sides = (self.jax, self.port)

    def each(self, fn):
        return [fn(side) for side in self.sides]

    def add_node(self, name, **kw):
        self.each(lambda s: s.kube.add_node(gpu_node(s.builders, name, **kw)))

    def add_pod(self, name, **kw):
        self.each(lambda s: s.kube.add_pod(gpu_pod(s.builders, name, **kw)))

    def sync(self):
        self.each(lambda s: replay(s.cache))
        self.check_state()

    def check_state(self):
        """Bookings and, in mirror mode, the usage mirror equal."""
        j, p = self.jax.cache, self.port.cache
        assert p.annotated_pods == j.annotated_pods
        assert {n: {c: dict(rm) for c, rm in cards.items()} for n, cards in p.node_statuses.items()} == {
            n: {c: dict(rm) for c, rm in cards.items()} for n, cards in j.node_statuses.items()
        }
        if self.mode == "mirror":
            assert mirror_arrays(self.port) == mirror_arrays(self.jax)

    def verb(self, verb, payload):
        """The port's answer, after checking it equals the JAX one byte for
        byte, and that both took the same path."""
        body = json.dumps(payload).encode()
        before = [s.trace.COUNTERS.get("pas_gas_filter_device_total") for s in self.sides]
        want = getattr(self.jax.ext, verb)(self.jax.request(verb, body))
        got = getattr(self.port.ext, verb)(self.port.request(verb, body))
        assert (got.status, got.headers, got.body) == (want.status, want.headers, want.body)
        after = [s.trace.COUNTERS.get("pas_gas_filter_device_total") for s in self.sides]
        assert after[0] - before[0] == after[1] - before[1]
        return got.status, (json.loads(got.body) if got.body else None)

    def filter(self, pod, names):
        return self.verb("filter", {"Pod": pod.raw, "NodeNames": names})

    def bind(self, name, node):
        pod = self.port.kube.get_pod("default", name)
        return self.verb(
            "bind", {"PodName": name, "PodNamespace": "default", "PodUID": pod.uid, "Node": node}
        )

    def pods(self, name):
        """Both fakes' stored pod, the gas-ts annotation taken out (a wall
        clock) after checking it is one."""
        out = []
        for side in self.sides:
            raw = copy.deepcopy(side.kube.get_pod("default", name).raw)
            ts = raw["metadata"].get("annotations", {}).pop("gas-ts", None)
            assert ts is None or ts.isdigit()
            out.append(raw)
        assert out[0] == out[1]
        return out[1]


def mirror_arrays(side):
    """The usage mirror's snapshot as plain data."""
    state, node_index, known, has_gpus, res_index = side.ext._device.mirror.snapshot()
    if side.jax:
        fields = {
            "used": jax_i64.to_int64_np(state.used),
            "capacity": jax_i64.to_int64_np(state.capacity),
            **{k: np.asarray(getattr(state, k)) for k in ("cap_present", "card_valid", "card_real", "card_order")},
        }
    else:
        fields = {k: getattr(state, k).numpy() for k in state._fields}
    return (
        {k: (v.dtype.kind, v.shape, v.tolist()) for k, v in fields.items()},
        node_index,
        known.tolist(),
        has_gpus.tolist(),
        res_index,
    )


@pytest.fixture(params=MODES)
def twins(request):
    yield Twins(request.param)


def test_filter_fit_and_reject(twins):
    twins.add_node("empty-node")
    twins.add_node("small-node", cards=1, i915=1, millicores=100)
    twins.sync()
    status, out = twins.filter(gpu_pod(builders, "p", millicores="500"), ["empty-node", "small-node"])
    assert status == 200 and out["NodeNames"] == ["empty-node"]
    assert out["FailedNodes"] == {
        "small-node": "gas: no card fits request (gpu.intel.com/i915=1, gpu.intel.com/millicores=500)"
    }


def test_filter_without_node_names_is_404(twins):
    twins.sync()
    status, out = twins.verb("filter", {"Pod": gpu_pod(builders, "p").raw, "Nodes": {"items": []}})
    assert status == 404 and "NodeCacheCapable" in out["Error"]
    assert twins.verb("filter", {"Pod": 7})[0] == 404  # undecodable


def test_filter_reason_classes(twins):
    """Unknown node, no-GPU node, capacity miss and a fit in one request;
    the decision records' per-class counters move the same."""
    twins.add_node("fit")
    twins.add_node("bare", label={})
    twins.add_node("tiny", cards=1, i915=1, millicores=10)
    twins.sync()
    labels = {"reason": "gas_no_gpus"}
    before = [s.trace.COUNTERS.get("pas_decision_filtered_nodes_total", labels=labels) for s in twins.sides]
    status, out = twins.filter(gpu_pod(builders, "p"), ["ghost", "bare", "tiny", "fit"])
    assert status == 200 and out["NodeNames"] == ["fit"]
    assert out["FailedNodes"]["ghost"] == "gas: node unknown to cache"
    assert out["FailedNodes"]["bare"] == "gas: node has no GPUs"
    after = [s.trace.COUNTERS.get("pas_decision_filtered_nodes_total", labels=labels) for s in twins.sides]
    assert after[0] - before[0] == after[1] - before[1] == 1


def test_filter_counts_used_resources(twins):
    twins.add_node("n1", cards=1, i915=2, millicores=1000)
    twins.sync()
    twins.each(lambda s: s.cache.adjust_pod_resources_locked(
        gpu_pod(s.builders, "booked", millicores="800", node_name="n1"), True, "card0", "n1"))
    twins.check_state()
    assert "n1" in twins.filter(gpu_pod(builders, "p", millicores="300"), ["n1"])[1]["FailedNodes"]
    assert twins.filter(gpu_pod(builders, "p2", millicores="200"), ["n1"])[1]["NodeNames"] == ["n1"]


def test_filter_multi_gpu_and_repeat_picks(twins):
    twins.add_node("n1", cards=2, i915=8, millicores=2000)
    twins.sync()
    assert twins.filter(gpu_pod(builders, "p", i915="2", millicores="1600"), ["n1"])[1]["NodeNames"] == ["n1"]
    assert twins.filter(gpu_pod(builders, "q", i915="4", millicores="400"), ["n1"])[1]["NodeNames"] == ["n1"]


def test_filter_vanished_card(twins):
    """Usage on a card gone from the label is skipped; label cards fit."""
    twins.add_node("n1", cards=2, i915=4, millicores=2000)
    twins.sync()
    twins.each(lambda s: s.cache.adjust_pod_resources_locked(
        gpu_pod(s.builders, "ghost", millicores="100", node_name="n1"), True, "card9", "n1"))
    twins.check_state()
    assert twins.filter(gpu_pod(builders, "p"), ["n1"])[1]["NodeNames"] == ["n1"]


def test_filter_unknown_request_resource(twins):
    twins.add_node("n1")
    twins.sync()
    twins.filter(gpu_pod(builders, "p"), ["n1"])
    status, out = twins.filter(gpu_pod(builders, "p2", extra={"gpu.intel.com/never-seen": "1"}), ["n1"])
    assert status == 200 and "n1" in out["FailedNodes"]
    twins.check_state()


def test_filter_unreadable_node_takes_the_host_loop():
    """A node capacity that staging cannot read is a data error: the
    staged bin-pack gives the request to the host loop, which fails that
    node alone, as the JAX package does, and counts a host Filter."""
    twins = Twins("staged")
    twins.add_node("n1")
    twins.each(lambda s: s.kube.add_node(s.builders.make_node(
        "broken", labels={"gpu.intel.com/cards": "card0"},
        allocatable={"gpu.intel.com/i915": "1", "gpu.intel.com/millicores": "lots"})))
    twins.sync()
    before = trace.COUNTERS.get("pas_gas_filter_host_total")
    status, out = twins.filter(gpu_pod(builders, "p"), ["n1", "broken"])
    assert status == 200 and out["NodeNames"] == ["n1"] and list(out["FailedNodes"]) == ["broken"]
    assert trace.COUNTERS.get("pas_gas_filter_host_total") == before + 1


@pytest.mark.parametrize("mode", ("staged", "mirror"))
def test_filter_device_failure_is_an_error_answer(mode, monkeypatch):
    """A bin-pack that fails on the device (a kernel that does not build or
    launch, a shape it refuses) is an error answer: the host loop never
    answers in its place."""
    side = Side(False, mode)
    side.kube.add_node(gpu_node(builders, "n1"))
    replay(side.cache)

    def failing(*_args):
        raise RuntimeError("binpack kernel launch failed: cudaError 700")

    monkeypatch.setattr("platform_aware_scheduling_tpu_torch.gas.device.binpack", failing)
    counts = lambda: [trace.COUNTERS.get(f"pas_gas_filter_{path}_total") for path in ("host", "device", "device_error")]
    before = counts()
    body = json.dumps({"Pod": gpu_pod(builders, "p").raw, "NodeNames": ["n1"]}).encode()
    got = side.ext.filter(side.request("filter", body))
    assert got.status == 404
    assert json.loads(got.body)["Error"] == "device binpack failed: binpack kernel launch failed: cudaError 700"
    assert counts() == [before[0], before[1], before[2] + 1]


def test_prioritize_is_404(twins):
    assert twins.verb("prioritize", {})[0] == 404


def test_node_update_and_delete(twins):
    twins.add_node("n1", cards=1, i915=1, millicores=100)
    twins.sync()
    assert "n1" in twins.filter(gpu_pod(builders, "p"), ["n1"])[1]["FailedNodes"]
    twins.add_node("n1", cards=1, i915=2, millicores=2000)  # an update
    twins.sync()
    assert twins.filter(gpu_pod(builders, "p"), ["n1"])[1]["NodeNames"] == ["n1"]
    twins.each(lambda s: s.kube.delete_node("n1"))
    twins.sync()
    out = twins.filter(gpu_pod(builders, "p"), ["n1"])[1]
    assert out["FailedNodes"] == {"n1": "gas: node unknown to cache"}


def test_bind_books_annotates_and_binds(twins):
    twins.add_node("n1")
    twins.add_pod("p", millicores="500")
    twins.sync()
    assert twins.bind("p", "n1") == (200, {"Error": ""})
    pod = twins.pods("p")
    assert pod["metadata"]["annotations"] == {"gas-container-cards": "card0"}
    assert pod["spec"]["nodeName"] == "n1"
    twins.check_state()
    assert twins.port.cache.node_statuses["n1"]["card0"]["gpu.intel.com/millicores"] == 500
    assert twins.port.kube.bindings == twins.jax.kube.bindings
    twins.sync()  # the informers see the annotated, bound pod: no second booking
    assert twins.port.cache.node_statuses["n1"]["card0"]["gpu.intel.com/millicores"] == 500


def test_bind_multi_container_annotation(twins):
    twins.add_node("n1", cards=4, i915=8, millicores=4000)
    twins.add_pod("p", i915="2", millicores="900", containers=2)
    twins.sync()
    assert twins.bind("p", "n1")[0] == 200
    # per GPU: i915 1 of 2 and 450 of 1000 millicores, so each card takes
    # two shares (a repeat pick) before the next
    assert twins.pods("p")["metadata"]["annotations"] == {"gas-container-cards": "card0,card0|card1,card1"}
    twins.check_state()


def test_bind_unknown_pod(twins):
    twins.sync()
    status, out = twins.verb("bind", {"PodName": "ghost", "PodNamespace": "default", "PodUID": "u", "Node": "n1"})
    assert status == 404 and out["Error"]


def test_bind_wont_fit_rolls_nothing(twins):
    twins.add_node("n1", cards=1, i915=1, millicores=100)
    twins.add_pod("p", millicores="500")
    twins.sync()
    assert twins.bind("p", "n1") == (404, {"Error": "will not fit"})
    twins.check_state()
    assert twins.port.cache.get_node_resource_status("n1") == {}


def test_bind_failure_rolls_back(twins):
    twins.add_node("n1")
    twins.add_pod("p", millicores="500")
    twins.sync()
    twins.jax.kube.fail_next_bind = RuntimeError("bind refused")
    twins.port.kube.fail_next_bind = RuntimeError("bind refused")
    assert twins.bind("p", "n1") == (404, {"Error": "bind refused"})
    twins.check_state()
    assert twins.port.cache.annotated_pods == {}
    assert twins.port.cache.node_statuses["n1"]["card0"]["gpu.intel.com/millicores"] == 0
    twins.pods("p")  # annotated all the same, as in the reference


def test_bind_conflict_retry_backs_off(twins):
    twins.add_node("n1")
    twins.add_pod("p", millicores="500")
    twins.sync()
    for side in twins.sides:
        side.kube.update_pod_conflicts_remaining = 2
    assert twins.bind("p", "n1") == (200, {"Error": ""})
    assert twins.port.sleeps == twins.jax.sleeps and len(twins.port.sleeps) == 2
    twins.pods("p")


def test_bind_conflicts_exhausted(twins):
    twins.add_node("n1")
    twins.add_pod("p", millicores="500")
    twins.sync()
    for side in twins.sides:
        side.kube.update_pod_conflicts_remaining = 9
    status, out = twins.bind("p", "n1")
    assert status == 404 and out["Error"]
    assert twins.port.sleeps == twins.jax.sleeps and len(twins.port.sleeps) == 4
    twins.check_state()
    assert twins.port.cache.annotated_pods == {}


def test_ingestion_and_release(twins):
    """Annotated pods replay into bookings; a completed and a deleted pod
    release theirs; a pod without an annotation waits."""
    twins.add_node("n1")
    twins.add_pod("a", millicores="600", node_name="n1", annotations={"gas-container-cards": "card0"}, phase="Running")
    twins.add_pod("b", millicores="300", node_name="n1", annotations={"gas-container-cards": "card1"}, phase="Running")
    twins.add_pod("c", millicores="300", node_name="n1", phase="Running")
    twins.sync()
    assert sorted(twins.port.cache.annotated_pods) == ["default&a", "default&b"]
    for side in twins.sides:
        done = gpu_pod(side.builders, "a", millicores="600", node_name="n1",
                       annotations={"gas-container-cards": "card0"}, phase="Succeeded")
        done.metadata["uid"] = side.kube.get_pod("default", "a").uid
        side.kube.update_pod(done)
        side.kube.delete_pod("default", "b")
    twins.sync()
    assert twins.port.cache.annotated_pods == {}
    assert twins.port.cache.node_statuses["n1"]["card0"]["gpu.intel.com/millicores"] == 0


def test_restart_rebuilds_from_annotations(twins):
    """A second cache over the same fake rebuilds the same bookings."""
    twins.add_node("n1", cards=4, i915=4, millicores=4000)
    for i in range(3):
        twins.add_pod(f"p{i}", node_name="n1", annotations={"gas-container-cards": f"card{i}"}, phase="Running")
    twins.sync()
    restarted = [(JaxCache if s.jax else Cache)(s.kube, start=False) for s in twins.sides]
    for cache in restarted:
        replay(cache)
    assert restarted[1].annotated_pods == restarted[0].annotated_pods == twins.port.cache.annotated_pods
    assert restarted[1].node_statuses == twins.port.cache.node_statuses


def test_random_cluster(twins):
    """24 seeded nodes and bookings, 8 seeded pods: every Filter equal."""
    rng = np.random.default_rng(7)
    names = [f"n{i}" for i in range(24)]
    for name in names:
        twins.add_node(
            name,
            cards=int(rng.integers(1, 5)),
            i915=int(rng.integers(1, 9)),
            millicores=int(rng.integers(100, 4000)),
            memory=int(rng.integers(100, 8000)),
        )
    twins.sync()
    for i in range(10):
        node = names[int(rng.integers(0, 24))]
        millicores = str(int(rng.integers(0, 1500)))
        card = f"card{int(rng.integers(0, 4))}"
        errors = []
        for side in twins.sides:
            try:
                side.cache.adjust_pod_resources_locked(
                    gpu_pod(side.builders, f"seed{i}", millicores=millicores, node_name=node), True, card, node
                )
            except Exception as exc:
                errors.append(type(exc).__name__)
        assert len(errors) in (0, 2)
        twins.check_state()
    for trial in range(8):
        pod = gpu_pod(
            builders,
            f"trial{trial}",
            i915=str(int(rng.integers(1, 4))),
            millicores=str(int(rng.integers(0, 3000))),
            containers=int(rng.integers(1, 3)),
        )
        assert twins.filter(pod, names)[0] == 200


def test_mirror_fits_cache():
    """A repeat is a hit and a booking makes the next a miss, in both
    packages (the JAX one keeps no counters: its cache list)."""
    twins = Twins("mirror")
    twins.add_node("n1", cards=1, i915=1, millicores=1000)
    twins.sync()
    pod = gpu_pod(builders, "p", millicores="800")
    twins.filter(pod, ["n1"])
    twins.filter(pod, ["n1"])
    packer = twins.port.ext._device
    assert (packer.fits_hits, packer.fits_misses) == (1, 1)
    assert len(packer._fits_cache) == len(twins.jax.ext._device._fits_cache) == 1
    twins.each(lambda s: s.cache.adjust_pod_resources_locked(
        gpu_pod(s.builders, "booked", millicores="800", node_name="n1"), True, "card0", "n1"))
    assert "n1" in twins.filter(pod, ["n1"])[1]["FailedNodes"]
    assert (packer.fits_hits, packer.fits_misses) == (1, 2)


def test_mirror_state_is_rebuilt_from_dirty_rows():
    """A new version's device state uploads only the rows events wrote,
    starting from the last state, which it leaves as it was: every state
    equals the host arrays of its version."""
    twins = Twins("mirror")
    for i in range(20):
        twins.add_node(f"n{i}", cards=1 + i % 4, i915=4, millicores=4000)
    twins.sync()
    mirror = twins.port.ext._device.mirror
    states = []
    for i in range(6):
        states.append((mirror.snapshot()[0], [a.copy() for a in mirror._host_arrays()]))
        twins.each(lambda s, i=i: s.cache.adjust_pod_resources_locked(
            gpu_pod(s.builders, f"b{i}", millicores=str(100 + i), node_name=f"n{3 * i}"), True, "card0", f"n{3 * i}"))
        twins.check_state()
    twins.add_node("n1", cards=4, i915=8, millicores=800)  # an update
    twins.sync()
    states.append((mirror.snapshot()[0], [a.copy() for a in mirror._host_arrays()]))
    assert len({id(state) for state, _ in states}) == len(states)
    for state, arrays in states:
        for tensor, array in zip(state, arrays):
            np.testing.assert_array_equal(tensor.numpy(), array)


def test_mirror_skips_a_resynced_node():
    """An informer resync re-delivers the stored node object: the mirror
    keeps its version; a new object, or a delete, restages the row."""
    twins = Twins("mirror")
    twins.add_node("n1")
    twins.sync()
    mirror = twins.port.ext._device.mirror
    version = mirror.version
    twins.port.cache._node_informer._resync_once()
    assert mirror.version == version
    twins.add_node("n1", cards=1, i915=1, millicores=10)  # an update: a new object
    twins.sync()
    assert mirror.version > version
    row = mirror.snapshot()[1]["n1"]
    node = twins.port.cache.fetch_node("n1")
    twins.each(lambda s: s.kube.delete_node("n1"))
    twins.sync()
    assert not mirror.snapshot()[2][row]
    mirror.on_node_change(node)  # the same object again, after its delete
    assert mirror.snapshot()[2][row]


def test_no_thread_left_running(threads_before_this_file):
    """Only the work queue's backoff timers ran here; each ends when it
    fires."""
    started = [t for t in threading.enumerate() if t not in threads_before_this_file]
    for thread in started:
        thread.join(5.0)
    assert not [t for t in started if t.is_alive()]
