"""Flags and start-up helpers of the service main.

The port's copy of the parts of ``platform_aware_scheduling_tpu/cmd/
common.py`` that ``cmd/tas.py`` uses: the robustness flags (retry, backoff
and circuit breaking), the decision-log and event-journal flags, and the
fault-tolerant proxy put in front of the kube client.  ``--degradedMode``
comes with the degraded-mode controller, which is not ported.
"""

from __future__ import annotations

import argparse

from platform_aware_scheduling_tpu_torch.kube.retry import (
    CircuitBreakerRegistry,
    FaultTolerantClient,
    RetryPolicy,
)
from platform_aware_scheduling_tpu_torch.utils import decisions, events
from platform_aware_scheduling_tpu_torch.utils.duration import parse_duration


def add_robustness_flags(parser: argparse.ArgumentParser) -> None:
    """Retry/backoff and circuit-breaker tuning."""
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
