"""Flags and start-up helpers of the service mains.

The port's copy of the parts of ``platform_aware_scheduling_tpu/cmd/
common.py`` that ``cmd/tas.py`` and ``cmd/gas.py`` use: the robustness
flags (retry, backoff, circuit breaking and, for TAS, ``--degradedMode``),
the leader-election flags, the decision-log and event-journal flags, the
forecast flags (TAS only) and the Forecaster built from them, the
fault-tolerant proxy put in front of the kube client, and the lease
elector built over it.  The JAX HA flags' gang journal
(``--gangJournal*``) comes with the gang plane.
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional

from platform_aware_scheduling_tpu_torch.kube.retry import (
    CircuitBreakerRegistry,
    FaultTolerantClient,
    RetryPolicy,
)
from platform_aware_scheduling_tpu_torch.kube.lease import LeaseElector
from platform_aware_scheduling_tpu_torch.utils import decisions, events
from platform_aware_scheduling_tpu_torch.utils.duration import parse_duration


def add_robustness_flags(parser: argparse.ArgumentParser, degraded: bool = True) -> None:
    """Retry/backoff and circuit-breaker tuning.  ``--degradedMode`` only
    exists where a DegradedModeController is built (TAS): GAS would ignore
    it, so ``degraded=False`` leaves it out and argparse refuses it."""
    parser.add_argument("--retryMaxAttempts", type=int, default=4,
                        help="max attempts per idempotent API read "
                        "(writes never blind-retry)")
    parser.add_argument("--retryBaseDelay", default="100ms",
                        help="first retry backoff (Go duration); doubles "
                        "per attempt with deterministic jitter")
    parser.add_argument("--retryMaxDelay", default="5s",
                        help="backoff cap (Go duration)")
    parser.add_argument("--retryDeadline", default="30s",
                        help="per-call deadline across all retry attempts "
                        "(Go duration)")
    parser.add_argument("--circuitFailureThreshold", type=int, default=5,
                        help="consecutive transport failures that open an "
                        "endpoint group's circuit")
    parser.add_argument("--circuitResetTimeout", default="30s",
                        help="how long an open circuit waits before the "
                        "half-open probe (Go duration)")
    if degraded:
        parser.add_argument("--degradedMode", default="last-known-good",
                            choices=["fail-open", "fail-closed", "last-known-good"],
                            help="dontschedule Filter policy while telemetry "
                            "is degraded: fail-open passes every candidate, "
                            "fail-closed passes none, last-known-good keeps "
                            "serving retained values within a bounded age "
                            "then fails open.  Evictions are ALWAYS "
                            "suspended while degraded (not configurable)")


def add_forecast_flags(parser: argparse.ArgumentParser, forecast: bool = True) -> None:
    """The predictive-telemetry flags.  Like ``--degradedMode`` they exist
    only where a Forecaster is built (TAS): GAS has no telemetry cache to
    forecast over, so ``forecast=False`` adds nothing and argparse refuses
    the flags there."""
    if not forecast:
        return
    parser.add_argument("--forecast", default="off", choices=["off", "on"],
                        help="schedule on forecasts, not snapshots: a "
                        "batched on-device EWMA/Holt fit over the "
                        "telemetry refresh history ranks scheduleonmetric "
                        "on predicted-at-bind values, and lets degraded "
                        "last-known-good mode serve bounded extrapolations")
    parser.add_argument("--forecastWindow", type=int, default=32,
                        help="refresh-history samples kept per metric "
                        "(the fit's lookback window)")
    parser.add_argument("--forecastHorizon", default="",
                        help="how far ahead predictions target (Go "
                        "duration); empty = one refresh period ahead "
                        "(the value at the next refresh); capped at "
                        "--forecastWindow refresh steps")
    parser.add_argument("--forecastBandBound", type=float, default=0.25,
                        help="max mean relative uncertainty band under "
                        "which degraded LKG mode keeps serving forecast "
                        "extrapolations; past it the frozen-LKG/neutral "
                        "behavior returns")


def forecast_options(args, sync_period_s: float) -> Optional[dict]:
    """The ``--forecast*`` flags as the options ``assemble`` builds a
    Forecaster from (None: off)."""
    if getattr(args, "forecast", "off") != "on":
        return None
    horizon_s = None
    if getattr(args, "forecastHorizon", ""):
        horizon_s = parse_duration(args.forecastHorizon)
    return {
        "window": args.forecastWindow,
        "horizon_s": horizon_s,
        "period_s": sync_period_s,
        "band_bound": args.forecastBandBound,
    }


def build_forecaster(cache, mirror, options: Optional[dict]):
    """The Forecaster of ``--forecast=on`` over the cache's history rings
    and the mirror (None when off, or with no mirror: the forecast views
    ride the device mirror)."""
    if options is None or mirror is None:
        return None
    from platform_aware_scheduling_tpu_torch.forecast import Forecaster

    return Forecaster(cache, mirror, **options)


def add_ha_flags(parser: argparse.ArgumentParser) -> None:
    """Leader election over a coordination.k8s.io Lease."""
    parser.add_argument("--leaderElect", action="store_true",
                        help="run N replicas behind one Service with "
                        "exactly one executing the actuation loops "
                        "(deschedule labels): leadership rides a "
                        "coordination.k8s.io Lease with a monotonic "
                        "fencing token; followers keep serving "
                        "Filter/Prioritize at full quality.  Off (the "
                        "default) changes nothing on the wire")
    parser.add_argument("--leaseName", default="pas-tas-extender",
                        help="name of the leadership Lease object")
    parser.add_argument("--leaseNamespace", default="default",
                        help="namespace of the leadership Lease")
    parser.add_argument("--leaseDuration", default="15s",
                        help="how long a leadership grant survives "
                        "without renew before standbys may take over "
                        "(Go duration); also the deposed leader's "
                        "self-demotion deadline")
    parser.add_argument("--leaseRenewPeriod", default="",
                        help="interval between renew/acquire attempts "
                        "(Go duration); empty = a third of "
                        "--leaseDuration, jittered deterministically "
                        "per replica")
    parser.add_argument("--replicaId", default="",
                        help="this replica's lease holder identity; "
                        "empty derives hostname-pid")


def add_decision_flags(parser: argparse.ArgumentParser) -> None:
    """Decision-provenance flags."""
    parser.add_argument("--decisionLog", default="on", choices=["off", "on"],
                        help="per-decision explain records behind "
                        "GET /debug/decisions, closed by pod-bind feedback "
                        "into the pas_decision_* metrics; off disables "
                        "recording and 404s the endpoint")
    parser.add_argument("--decisionLogSize", type=int, default=512,
                        help="decision-log ring capacity; an open record "
                        "overwritten before its bind feedback counts in "
                        "pas_decision_evicted_open_total")


def add_event_flags(parser: argparse.ArgumentParser) -> None:
    """Causal-event-journal flags."""
    parser.add_argument("--events", default="on", choices=["off", "on"],
                        help="causal event journal behind GET /debug/explain: "
                        "the verbs publish typed events carrying "
                        "correlation keys, so one query returns the ordered "
                        "chain for a pod/request/node; off publishes "
                        "nothing and 404s the endpoint")
    parser.add_argument("--eventsSize", type=int, default=4096,
                        help="event-journal ring capacity; overflow drops "
                        "the OLDEST event and counts it in "
                        "pas_events_dropped_total")


def configure_events(args) -> None:
    """Apply the event flags to the process-wide EventJournal."""
    events.JOURNAL.configure(enabled=args.events == "on", capacity=args.eventsSize)


def configure_decisions(args) -> None:
    """Apply the decision flags to the process-wide DecisionLog."""
    decisions.DECISIONS.configure(enabled=args.decisionLog == "on", capacity=args.decisionLogSize)


def build_fault_tolerance(args):
    """(RetryPolicy, CircuitBreakerRegistry) from the robustness flags."""
    policy = RetryPolicy(
        max_attempts=args.retryMaxAttempts,
        base_delay_s=parse_duration(args.retryBaseDelay),
        max_delay_s=parse_duration(args.retryMaxDelay),
        deadline_s=parse_duration(args.retryDeadline),
    )
    breakers = CircuitBreakerRegistry(
        failure_threshold=args.circuitFailureThreshold,
        reset_timeout_s=parse_duration(args.circuitResetTimeout),
    )
    return policy, breakers


def wrap_kube_client(kube_client, policy, breakers):
    """The fault-tolerant proxy the main puts in front of every API
    consumer (kube/retry.py)."""
    return FaultTolerantClient(kube_client, policy=policy, breakers=breakers)


def replica_identity(args) -> str:
    """The lease holder identity: ``--replicaId`` or hostname-pid."""
    if args.replicaId:
        return args.replicaId
    return f"{socket.gethostname()}-{os.getpid()}"


def build_lease_elector(args, kube_client) -> Optional[LeaseElector]:
    """The LeaseElector of ``--leaderElect`` (None when off).  The client
    is the fault-tolerant proxy, where the lease verbs retry as
    idempotent-by-fencing within the lease duration."""
    if not args.leaderElect:
        return None
    return LeaseElector(
        kube_client,
        identity=replica_identity(args),
        lease_name=args.leaseName,
        namespace=args.leaseNamespace,
        lease_duration_s=parse_duration(args.leaseDuration),
        renew_period_s=parse_duration(args.leaseRenewPeriod) if args.leaseRenewPeriod else None,
    )
