"""TAS service main: flags, assembly, signal handling.

The port's copy of ``platform_aware_scheduling_tpu/cmd/tas.py``.  The
reference's flag surface (``--kubeConfig --port --cert --key --cacert
--unsafe --syncPeriod`` plus klog's ``--v``), the batch planner's flags,
and the robustness (``--degradedMode`` among them), forecast,
leader-election, decision-log and event-journal flags, each with the JAX
main's name, default and meaning.  A tensor mirror on the GPU sits behind
the cache, so the verbs' scoring, the planner's solve, the deschedule
evaluation and, with ``--forecast=on``, the forecast fit run on the card.

    python -m platform_aware_scheduling_tpu_torch.cmd.tas --unsafe \\
        --batchPlanner --nodeCacheCapable --leaderElect --forecast=on

As the JAX main does, ``main`` always builds the degraded-mode controller
over the circuit breakers of its fault-tolerant client: while telemetry is
stale or a circuit is open, Filter and Prioritize degrade and the
deschedule label pass is suspended.  With ``--leaderElect`` only the
lease's holder writes labels.

The flags of the JAX main's other planes (profiler, rebalancer, gang and
the gang journal, admission, shard, SLO, control, flight recorder, solve
observatory, ``--serving=async``) are absent until their planes are
ported, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
from typing import List, Optional

from platform_aware_scheduling_tpu_torch.cmd import common
from platform_aware_scheduling_tpu_torch.extender.server import Server
from platform_aware_scheduling_tpu_torch.kube.client import get_kube_client
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.controller import TelemetryPolicyController
from platform_aware_scheduling_tpu_torch.tas.degraded import MODE_LAST_KNOWN_GOOD, DegradedModeController
from platform_aware_scheduling_tpu_torch.tas.metrics import CustomMetricsClient
from platform_aware_scheduling_tpu_torch.tas.planner import BatchPlanner
from platform_aware_scheduling_tpu_torch.tas.strategies import (
    core,
    deschedule,
    dontschedule,
    scheduleonmetric,
)
from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
from platform_aware_scheduling_tpu_torch.utils import health, klog
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device
from platform_aware_scheduling_tpu_torch.utils.duration import parse_duration
from platform_aware_scheduling_tpu_torch.utils.gctuning import tune_for_serving

# how long the main waits for the informers' initial lists before it
# applies the GC posture anyway (an unreachable API server)
INITIAL_SYNC_WAIT_S = 120.0


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tas-extender",
        description="Telemetry-aware scheduling extender (PyTorch, CUDA)",
    )
    default_kubeconfig = os.path.join(os.path.expanduser("~"), ".kube", "config")
    parser.add_argument("--kubeConfig", default=default_kubeconfig,
                        help="location of kubernetes config file")
    parser.add_argument("--port", default="9001",
                        help="port on which the scheduler extender will listen")
    parser.add_argument("--cert", default="/etc/kubernetes/pki/ca.crt",
                        help="cert file extender will use")
    parser.add_argument("--key", default="/etc/kubernetes/pki/ca.key",
                        help="key file extender will use")
    parser.add_argument("--cacert", default="/etc/kubernetes/pki/ca.crt",
                        help="ca file extender will use")
    parser.add_argument("--unsafe", action="store_true",
                        help="unsafe instances of extender will be served over http")
    parser.add_argument("--syncPeriod", default="5s",
                        help="interval between cache syncs, e.g. 1m or 2s")
    parser.add_argument("--v", type=int, default=2, help="klog verbosity")
    parser.add_argument("--batchPlanner", action="store_true",
                        help="solve the whole pending set each sync period "
                        "and steer pods onto their batch-assigned nodes")
    parser.add_argument("--batchSolver", default="greedy",
                        choices=["greedy", "sinkhorn"],
                        help="batch planner solver: greedy (sequential-"
                        "equivalent) or sinkhorn (globally coordinated)")
    parser.add_argument("--nodeCacheCapable", action="store_true",
                        help="serve Prioritize/Filter from Args.NodeNames "
                        "(register the extender nodeCacheCapable: true); "
                        "large clusters avoid shipping full node objects")
    parser.add_argument("--serving", default="threaded", choices=["threaded"],
                        help="HTTP front-end: threaded (reference-parity)")
    common.add_robustness_flags(parser)
    common.add_decision_flags(parser)
    common.add_event_flags(parser)
    common.add_forecast_flags(parser)
    common.add_ha_flags(parser)
    return parser


def assemble(
    kube_client,
    metrics_client,
    sync_period_s: float,
    *,
    enable_batch_planner: bool = False,
    batch_solver: str = "greedy",
    node_cache_capable: bool = False,
    breakers=None,
    degraded_mode: Optional[str] = None,
    forecast_options: Optional[dict] = None,
    leadership=None,
    device: DeviceLike = None,
):
    """Wire cache -> mirror (on ``device``) -> planner -> extender ->
    enforcer -> controller, then start the refresh loop, the CRD informer,
    the enforcement loop and, with the planner, its informers and replan
    loop.  Returns ``(cache, mirror, extender, controller, enforcer,
    stop)``; setting ``stop`` ends every background loop.

    ``breakers`` / ``degraded_mode``: when either is given, a
    DegradedModeController over the cache's freshness and the circuits'
    states is attached to the extender and the enforcer.
    ``forecast_options``: the ``--forecast=on`` options
    (``common.forecast_options``); a Forecaster over the cache's history
    rings and the mirror is attached to the extender (predicted-value
    ranking, ``/debug/forecast``) and the degraded-mode controller
    (bounded extrapolation).  ``leadership``:
    the ``--leaderElect`` LeaseElector, attached to the enforcer (the
    label pass runs on the leader only) and the extender (``/readyz``,
    ``/debug/leader``); the caller starts it."""
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device=device)
    mirror.attach(cache)
    planner = None
    if enable_batch_planner:
        planner = BatchPlanner(cache, mirror, solver=batch_solver, device=mirror.device)
    # the forecaster exists BEFORE the extender: the extender's constructor
    # runs the first warm pass, and the history rings must be recording
    # when the first metric writes land
    forecaster = common.build_forecaster(cache, mirror, forecast_options)
    extender = MetricsExtender(
        cache, mirror=mirror, planner=planner, node_cache_capable=node_cache_capable
    )
    extender.leadership = leadership
    if forecaster is not None:
        extender.forecaster = forecaster
        # after the forecaster's own refit hook (appended when it was
        # built), so each refresh pass warms rankings against the fit it
        # has just published: warm_fastpath fires mid-pass, before the
        # refit, and would leave every fresh forecast view cold
        cache.on_refresh_pass.append(extender.warm_forecast_rankings)

    # the registration order is the order the violation map lists policies
    # in, and so the order of each node's patch operations
    enforcer = core.MetricEnforcer(kube_client, mirror=mirror)
    enforcer.leadership = leadership
    enforcer.register_strategy_type(deschedule.Strategy())
    enforcer.register_strategy_type(scheduleonmetric.Strategy())
    enforcer.register_strategy_type(dontschedule.Strategy())
    if breakers is not None or degraded_mode is not None:
        degraded = DegradedModeController(cache, breakers=breakers, mode=degraded_mode or MODE_LAST_KNOWN_GOOD)
        degraded.forecaster = forecaster  # bounded last-known-good extrapolation
        extender.degraded = degraded
        enforcer.degraded = degraded

    controller = TelemetryPolicyController(kube_client, cache, enforcer)

    stop = threading.Event()
    cache.start_periodic_update(sync_period_s, metrics_client, stop=stop)
    controller.run(stop)
    enforcer.start_enforcing(cache, sync_period_s, stop=stop)
    if planner is not None:
        # the informers and the replan loop stop on the service's event
        # itself: told by a thread waiting on it, an informer that took a
        # watch event first would wait for one more before it saw the stop
        planner.watch(kube_client, stop=stop)
        planner.start(sync_period_s, stop=stop)
    return cache, mirror, extender, controller, enforcer, stop


def build_server(extender) -> Server:
    """The threaded HTTP front-end over an extender, ``/metrics`` serving
    the extender's exposition."""
    return Server(extender, metrics_provider=extender.metrics_text)


def tune_after_initial_syncs(extender, controller, done: threading.Event) -> None:
    """Apply the GC posture once the informers' initial lists are in.

    They (every pod and node with the planner) are most of the heap, and
    the posture freezes what exists when it is applied, so later full
    collections skip them, where a collection over ~165,000 pods would
    stall every thread for most of a second.  It runs beside ``main``, so
    a signal during a slow initial list still ends the process at once;
    after ``INITIAL_SYNC_WAIT_S`` (an unreachable API server) the posture
    is applied all the same."""
    informers = [controller.informer]
    if extender.planner is not None:
        informers += extender.planner.feed.informers
    deadline = time.monotonic() + INITIAL_SYNC_WAIT_S
    for informer in informers:
        if done.is_set():
            return
        informer.wait_for_cache_sync(max(0.0, deadline - time.monotonic()))
    if not done.is_set():
        tune_for_serving()


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    # the device rule first: without a GPU the service does not start,
    # and it never carries on quietly on the CPU
    try:
        device = resolve_device(None)
    except RuntimeError as exc:
        print(f"tas-extender: {exc}", file=sys.stderr)
        return 1
    klog.set_verbosity(args.v)
    sync_period_s = parse_duration(args.syncPeriod)
    # decision provenance and the event journal on/off and sized, before
    # any verb can record or publish
    common.configure_decisions(args)
    common.configure_events(args)

    # every remote call goes through the fault-tolerant proxy; the
    # metrics client rides it too, in the "metrics" circuit group
    retry_policy, breakers = common.build_fault_tolerance(args)
    kube_client = common.wrap_kube_client(get_kube_client(args.kubeConfig), retry_policy, breakers)
    metrics_client = CustomMetricsClient(kube_client)
    # leader election rides the fault-tolerant client too
    leadership = common.build_lease_elector(args, kube_client)
    _cache, _mirror, extender, controller, _enforcer, stop = assemble(
        kube_client,
        metrics_client,
        sync_period_s,
        enable_batch_planner=args.batchPlanner,
        batch_solver=args.batchSolver,
        node_cache_capable=args.nodeCacheCapable,
        breakers=breakers,
        degraded_mode=args.degradedMode,
        forecast_options=common.forecast_options(args, sync_period_s),
        leadership=leadership,
        device=device,
    )
    if leadership is not None:
        # after assembly, so this replica's caches are warm before it can
        # win the lease and start writing labels
        leadership.start(stop)

    server = build_server(extender)
    # /readyz also waits on the TASPolicy informer's initial list; the
    # extender's own conditions (warm, telemetry fresh) come from its
    # readiness_conditions() through the server's probe
    server.probe.register(
        "policy_informer_synced", health.informer_synced(controller.informer, "taspolicy")
    )
    done = threading.Event()
    failed = []

    def serve():
        try:
            server.start_server(
                port=args.port,
                cert_file=args.cert,
                key_file=args.key,
                ca_file=args.cacert,
                unsafe=args.unsafe,
                block=True,
            )
        except Exception as exc:  # noqa: BLE001 — a dead server takes the process down
            klog.error("extender server failed: %s", exc)
            failed.append(exc)
            done.set()

    threading.Thread(target=serve, daemon=True).start()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    threading.Thread(target=tune_after_initial_syncs, args=(extender, controller, done), daemon=True).start()
    done.wait()
    stop.set()
    server.shutdown()
    klog.v(1).info_s("Exiting", component="extender")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
