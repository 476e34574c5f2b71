"""The port's GAS service main (``cmd/gas.py``) against the JAX one: the
ported flags parse to the same values, the flags of planes the port lacks
are refused, ``main`` and every device-path entry point refuse to run
quietly on the CPU, and the assembled services answer Filter, Bind and
``/readyz`` over HTTP with the same bytes.  The test that starts services
stops them and joins every thread it started."""

import copy
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from platform_aware_scheduling_tpu.cmd import common as jax_common
from platform_aware_scheduling_tpu.cmd import gas as jax_gas
from platform_aware_scheduling_tpu.extender.server import Server as JaxServer
from platform_aware_scheduling_tpu.gas.cache import Cache as JaxCache
from platform_aware_scheduling_tpu.gas.scheduler import GASExtender as JaxGASExtender
from platform_aware_scheduling_tpu.testing import builders as jax_builders
from platform_aware_scheduling_tpu.testing.fake_kube import FakeKubeClient as JaxFake
from platform_aware_scheduling_tpu.utils import decisions as jax_decisions
from platform_aware_scheduling_tpu.utils import events as jax_events
from platform_aware_scheduling_tpu.utils import klog as jax_klog
from platform_aware_scheduling_tpu.utils import trace as jax_trace
from platform_aware_scheduling_tpu_torch.cmd import common, gas, tas
from platform_aware_scheduling_tpu_torch.gas.cache import Cache
from platform_aware_scheduling_tpu_torch.gas.device import DeviceBinpacker, GASUsageMirror
from platform_aware_scheduling_tpu_torch.gas.scheduler import GASExtender
from platform_aware_scheduling_tpu_torch.testing import builders
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
from platform_aware_scheduling_tpu_torch.utils import decisions, events, klog, trace



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


# -- flags -------------------------------------------------------------------------------------

PORTED_ARGV = [
    [],
    ["--unsafe", "--port=9100", "--v=2"],
    ["--kubeConfig=/tmp/kc", "--cert=c.crt", "--key=c.key", "--cacert=ca.crt"],
    ["--retryMaxAttempts=2", "--retryBaseDelay=5ms", "--retryMaxDelay=1s", "--retryDeadline=9s"],
    ["--circuitFailureThreshold=3", "--circuitResetTimeout=6s"],
    ["--decisionLog=off", "--decisionLogSize=7", "--events=off", "--eventsSize=9"],
]


@pytest.mark.parametrize("argv", PORTED_ARGV, ids=lambda a: " ".join(a) or "defaults")
def test_ported_flags_parse_as_in_jax(argv):
    got = vars(gas.build_arg_parser().parse_args(argv))
    want = vars(jax_gas.build_arg_parser().parse_args(argv))
    assert got == {key: want[key] for key in got}


UNPORTED_ARGV = [
    ["--serving=async"],
    ["--batchWindow=2ms"],
    ["--queueDepth=9"],
    ["--profilePort=6060"],
    ["--admission=on"],
    ["--slo=on"],
    ["--sloControl=on"],
    ["--flightRecorder=on"],
    ["--solveObs=on"],
    ["--degradedMode=fail-open"],
]


@pytest.mark.parametrize("argv", UNPORTED_ARGV, ids=lambda a: a[0])
def test_flags_of_unported_planes_are_refused(argv, capsys):
    if argv[0].startswith("--degradedMode"):
        # JAX GAS has no degraded-mode controller either: both refuse it
        with pytest.raises(SystemExit):
            jax_gas.build_arg_parser().parse_args(argv)
    else:
        jax_gas.build_arg_parser().parse_args(argv)
    with pytest.raises(SystemExit) as exc:
        gas.build_arg_parser().parse_args(argv)
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err or argv[0].startswith("--degradedMode")


def test_robustness_flags_keep_degraded_mode_for_tas():
    assert tas.build_arg_parser().parse_args(["--degradedMode=fail-open"]).degradedMode == "fail-open"
    assert not hasattr(gas.build_arg_parser().parse_args([]), "degradedMode")
    policy, breakers = common.build_fault_tolerance(gas.build_arg_parser().parse_args(["--retryMaxAttempts=2"]))
    jax_policy, jax_breakers = jax_common.build_fault_tolerance(
        jax_gas.build_arg_parser().parse_args(["--retryMaxAttempts=2"])
    )
    assert (policy.max_attempts, policy.base_delay_s, policy.deadline_s) == (
        jax_policy.max_attempts, jax_policy.base_delay_s, jax_policy.deadline_s
    )
    assert breakers.failure_threshold == jax_breakers.failure_threshold


# -- the device rule -------------------------------------------------------------------------------


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_main_needs_a_gpu(no_gpu, monkeypatch, capsys):
    def refuse(_path):
        raise AssertionError("main read a kubeconfig without a GPU")

    monkeypatch.setattr(gas, "get_kube_client", refuse)
    assert gas.main(["--unsafe"]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err


def test_device_entry_points_default_to_the_gpu(no_gpu):
    cache = Cache(FakeKubeClient(), start=False)
    for build in (
        lambda: GASUsageMirror(cache),
        lambda: DeviceBinpacker(cache),
        lambda: DeviceBinpacker(cache, use_mirror=False),
        lambda: GASExtender(FakeKubeClient(), cache=cache),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the host loop alone needs no device
    assert GASExtender(FakeKubeClient(), cache=cache, use_device=False)._device is None
    assert DeviceBinpacker(cache, device="cpu").mirror.device.type == "cpu"


def test_assemble_stops_its_cache_when_the_device_is_refused(no_gpu):
    threads = set(threading.enumerate())
    kube = FakeKubeClient()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gas.assemble(kube)
    join_started_since(threads, [kube])


def test_serving_posture():
    """``main``'s serving posture freezes the start-up heap and raises the
    young-generation threshold, and leaves the interpreter's switch
    interval alone; restored after."""
    import gc
    import sys

    from platform_aware_scheduling_tpu_torch.utils import gctuning

    threshold, interval, frozen = gc.get_threshold(), sys.getswitchinterval(), gc.get_freeze_count()
    try:
        gctuning.tune_for_serving()
        assert gc.get_threshold()[0] == 100_000
        assert gc.get_freeze_count() > 0
        assert sys.getswitchinterval() == interval
    finally:
        if not frozen:
            gc.unfreeze()
        gc.set_threshold(*threshold)


# -- the assembled services over HTTP ----------------------------------------------------------------


def join_started_since(before, fakes, timeout=20.0):
    """Join every thread started since the snapshot ``before``; none may
    outlive its stop.  An idle fake watch blocks its informer until the
    next event, so each hub first gets one, which a stopped informer
    returns on before reading it."""
    for kube in fakes:
        for hub in kube._hubs.values():
            hub.publish("BOOKMARK", {})
    deadline = time.monotonic() + timeout
    started = [t for t in threading.enumerate() if t not in before]
    for thread in started:
        thread.join(max(0.0, deadline - time.monotonic()))
    assert not [t for t in started if t.is_alive()], "threads still running after their stop"


def gpu_world(kube, pkg_builders):
    """Three GPU nodes and a bare one; two bound, annotated pods; one
    pending pod to bind."""
    for name, cards in (("n0", 2), ("n1", 4), ("n2", 1)):
        kube.add_node(pkg_builders.make_node(
            name,
            labels={"gpu.intel.com/cards": ".".join(f"card{i}" for i in range(cards))},
            allocatable={"gpu.intel.com/i915": str(cards), "gpu.intel.com/millicores": str(1000 * cards)},
        ))
    kube.add_node(pkg_builders.make_node("bare", allocatable={"pods": "110"}))
    for name, node, card in (("a", "n0", "card0"), ("b", "n1", "card2")):
        kube.add_pod(pkg_builders.make_pod(
            name, container_requests=[{"gpu.intel.com/i915": "1", "gpu.intel.com/millicores": "700"}],
            node_name=node, annotations={"gas-container-cards": card, "gas-ts": "1"}, phase="Running",
        ))
    kube.add_pod(pkg_builders.make_pod(
        "p", container_requests=[{"gpu.intel.com/i915": "2", "gpu.intel.com/millicores": "800"}]
    ))


def booked(cache, count):
    """An event set once ``count`` pods are booked: the cache's own hook,
    so nothing polls."""
    done = threading.Event()

    def hook(_node):
        if len(cache.annotated_pods) >= count:
            done.set()

    cache.on_booking_change(hook)
    hook(None)
    return done


class Services:
    """The JAX extender as its ``main`` builds it and the port's through
    ``cmd/gas.assemble``, each over the fault-tolerant client of its
    default flags, served on 127.0.0.1."""

    def __init__(self):
        self.threads = set(threading.enumerate())
        self.kubes = (JaxFake(), FakeKubeClient())
        gpu_world(self.kubes[0], jax_builders)
        gpu_world(self.kubes[1], builders)
        jax_args = jax_gas.build_arg_parser().parse_args([])
        policy, breakers = jax_common.build_fault_tolerance(jax_args)
        jax_api = jax_common.wrap_kube_client(self.kubes[0], policy, breakers)
        jax_cache = JaxCache(jax_api)
        jax_ext = JaxGASExtender(jax_api, cache=jax_cache, retry_policy=policy)
        args = gas.build_arg_parser().parse_args([])
        policy, breakers = common.build_fault_tolerance(args)
        api = common.wrap_kube_client(self.kubes[1], policy, breakers)
        cache, ext = gas.assemble(api, retry_policy=policy, device="cpu")
        self.caches = (jax_cache, cache)
        self.servers = (JaxServer(jax_ext, metrics_provider=jax_ext.metrics_text), gas.build_server(ext))
        for server in self.servers:
            server.start_server(port="0", unsafe=True, host="127.0.0.1", block=False)
            assert server.wait_ready()
        for c in self.caches:
            assert booked(c, 2).wait(30)

    def call(self, method, path, payload=None):
        """The port's (status, body) after checking the JAX one is equal."""
        out = []
        for server in self.servers:
            data = json.dumps(payload).encode() if payload is not None else None
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}", data=data, method=method,
                headers={"Content-Type": "application/json"} if data is not None else {},
            )
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    out.append((resp.status, resp.read()))
            except urllib.error.HTTPError as err:
                out.append((err.code, err.read()))
        assert out[0] == out[1]
        return out[1]

    def close(self):
        for server in self.servers:
            server.shutdown()
        for c in self.caches:
            c.stop()
        join_started_since(self.threads, self.kubes)


def test_assembled_services_answer_alike():
    services = Services()
    try:
        names = ["n0", "n1", "n2", "bare", "ghost"]
        pod = services.kubes[1].get_pod("default", "p").raw
        status, body = services.call("POST", "/scheduler/filter", {"Pod": pod, "NodeNames": names})
        out = json.loads(body)
        # per card: i915 1 and 1000 millicores; the pod wants two cards
        # with 400 each, and n0's card0 is taken by pod a
        assert status == 200 and out["NodeNames"] == ["n1"]
        assert set(out["FailedNodes"]) == {"n0", "n2", "bare", "ghost"}
        assert services.call("GET", "/readyz")[0] == 200
        binding = {"PodName": "p", "PodNamespace": "default", "PodUID": pod["metadata"]["uid"], "Node": "n1"}
        assert services.call("POST", "/scheduler/bind", binding) == (200, b'{"Error": ""}\n')
        annotations = [k.get_pod("default", "p").get_annotations()["gas-container-cards"] for k in services.kubes]
        assert annotations[0] == annotations[1] == "card0,card1"
        # the booking is in before Bind answers: n1 has one card left
        status, body = services.call("POST", "/scheduler/filter", {"Pod": pod, "NodeNames": names})
        assert status == 200 and json.loads(body)["NodeNames"] == []
        assert services.call("POST", "/scheduler/prioritize", {"Pod": pod, "NodeNames": names})[0] == 404
    finally:
        services.close()


def test_no_thread_left_running(threads_before_this_file):
    assert not [t for t in threading.enumerate() if t not in threads_before_this_file and t.is_alive()]
