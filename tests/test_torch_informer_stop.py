"""A service's informers stop with the service.

The TAS policy controller's informer, and the batch planner's pod and
node informers, used to learn of their service's stop from a thread
waiting on the stop event.  A watch event taken before that thread ran
left an informer waiting for one more event, so a service stopped in a
test could leave its informer thread behind.  The informers now stop on
the service's event itself."""

import threading
import time

from platform_aware_scheduling_tpu_torch.cmd.tas import assemble
from platform_aware_scheduling_tpu_torch.kube import informer as inf
from platform_aware_scheduling_tpu_torch.tas.metrics import CustomMetricsClient
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.controller import TelemetryPolicyController
from platform_aware_scheduling_tpu_torch.tas.strategies import core
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient


def join_started_since(before, kube, timeout=10.0):
    """Join the threads started since ``before`` after the one event an
    idle fake watch needs to return; returns those still alive."""
    for hub in kube._hubs.values():
        hub.publish("BOOKMARK", {})
    deadline = time.monotonic() + timeout
    started = [t for t in threading.enumerate() if t not in before]
    for thread in started:
        thread.join(max(0.0, deadline - time.monotonic()))
    return [t for t in started if t.is_alive()]


def test_policy_informer_stops_with_its_service():
    threads = set(threading.enumerate())
    kube = FakeKubeClient()
    stop = threading.Event()
    controller = TelemetryPolicyController(kube, AutoUpdatingCache(), core.MetricEnforcer(kube))
    informer = controller.run(stop)
    assert informer.wait_for_cache_sync(10)
    stop.set()
    # no other thread has to run first: the next event ends the watch
    assert informer._stop.is_set()
    assert join_started_since(threads, kube) == []


def test_informer_stops_on_a_given_event():
    threads = set(threading.enumerate())
    kube = FakeKubeClient()
    stop = threading.Event()
    subject = inf.Informer(
        inf.ListWatch(lambda: (kube.list_nodes(), ""), lambda rv: kube.watch_nodes(), str),
        stop=stop,
    )
    subject.start()
    assert subject.wait_for_cache_sync(10)
    stop.set()
    assert join_started_since(threads, kube) == []
    other = inf.Informer(inf.ListWatch(lambda: ([], ""), lambda rv: iter(()), str))
    other.stop()  # without a given event, stop() still stops it
    assert other._stop.is_set() and stop is not other._stop


def test_planner_informers_stop_with_their_service():
    """``cmd/tas.assemble`` with the batch planner: its pod and node
    informers and its replan loop end on the service's own stop event."""
    threads = set(threading.enumerate())
    kube = FakeKubeClient()
    _cache, _mirror, ext, _controller, _enforcer, stop = assemble(
        kube, CustomMetricsClient(kube), 1.0, enable_batch_planner=True, node_cache_capable=True, device="cpu"
    )
    informers = ext.planner.feed.informers
    assert all(informer.wait_for_cache_sync(10) for informer in informers)
    stop.set()
    # no other thread has to run first: the next event ends each watch
    assert all(informer._stop.is_set() for informer in informers)
    assert join_started_since(threads, kube) == []
