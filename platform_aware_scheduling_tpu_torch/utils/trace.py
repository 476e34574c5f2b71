"""Request tracing: spans, path-attribution counters and the metric-name
inventory behind ``/metrics``.

The port's copy of ``platform_aware_scheduling_tpu/utils/trace.py``:

  * :class:`Span` — one per HTTP request, opened by the server's
    connection handler, carrying a generated-or-propagated
    ``X-Request-ID`` and named stage timings (read, decode, kernel,
    encode, write);
  * :class:`TraceBuffer` — a bounded ring of recent completed spans plus
    the slowest few, served on ``GET /debug/traces``;
  * ``COUNTERS`` — process-wide path-attribution counters merged into
    ``/metrics``;
  * :data:`METRICS` — the declared inventory of every metric name the
    port emits.

The JAX package's compile watch (``install_jax_hooks``, ``watch_jit``)
has no counterpart: PyTorch runs the scoring code eagerly.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.utils.tracing import (
    CounterSet,
    LatencyRecorder,
    histograms_text,
)

# ---------------------------------------------------------------------------
# metric-name inventory
# ---------------------------------------------------------------------------

#: name -> (kind, help): every metric name the port may emit
METRICS: Dict[str, Tuple[str, str]] = {}


def declare(name: str, kind: str, help_text: str) -> None:
    if name in METRICS:
        raise ValueError(f"metric {name!r} declared twice")
    METRICS[name] = (kind, help_text)


declare("pas_request_duration_seconds", "histogram", "Verb/stage wall latency (labels: verb).")
# path attribution (tas/telemetryscheduler.py, tas/fastpath.py).  The
# three pas_prioritize_{native,native_host,exact}_total counters partition
# Prioritize requests by the path that answered, and hit + miss + bypass
# partition Filter requests; host_fallback counts degradation EVENTS and
# overlaps the partitions
declare("pas_prioritize_native_total", "counter", "Prioritize requests answered by the native wire path's device fastpath (incl. its trivial empty answers).")
declare("pas_prioritize_native_host_total", "counter", "Prioritize requests on the native wire path answered with exact host semantics (host-only policy/metric, or after a device failure).")
declare("pas_prioritize_exact_total", "counter", "Prioritize requests served by the exact Python path.")
declare("pas_prioritize_host_fallback_total", "counter", "Device-path failures degraded to host semantics (events; overlaps the partition counters).")
declare("pas_filter_host_fallback_total", "counter", "Filter device-path failures degraded to host semantics.")
declare("pas_fastpath_response_hit_total", "counter", "Prioritize response-reuse cache hits (response skeleton or span memcmp).")
declare("pas_fastpath_response_miss_total", "counter", "Prioritize response-reuse cache misses.")
declare("pas_gas_filter_device_total", "counter", "GAS Filter requests served by the batched device bin-pack.")
declare("pas_gas_filter_host_total", "counter", "GAS Filter requests served by the host loop.")
declare("pas_gas_filter_device_error_total", "counter", "GAS Filter requests answered with an error because the device bin-pack failed.")
declare("pas_filter_cache_hit_total", "counter", "Filter response cache hits.")
declare("pas_filter_cache_miss_total", "counter", "Filter cacheable requests that missed the response cache.")
declare("pas_filter_cache_bypass_total", "counter", "Filter requests not cacheable (host-only policy, odd shapes, no native scanner).")
# interned node-name universes (native/wirec.c UniverseCache via
# tas/fastpath.py): hits + misses partition every probe against an
# available universe cache; evictions count universes dropped past the
# MRU bound (PAS_TPU_UNIVERSE_CACHE)
declare("pas_wire_intern_hits_total", "counter", "Candidate-span universe-cache hits (digest + memcmp-verified).")
declare("pas_wire_intern_misses_total", "counter", "Candidate-span universe-cache misses (cold span, or first sighting before interning).")
declare("pas_wire_intern_evictions_total", "counter", "Interned universes evicted past the MRU bound.")
declare("pas_traces_recorded_total", "counter", "Completed spans recorded into the trace ring buffer.")
declare("pas_ready", "gauge", "Composite readiness: 1 when every /readyz condition holds, else 0.")
declare("pas_ready_transitions_total", "counter", "Readiness flips (ready <-> not ready) observed across /readyz evaluations.")
declare("pas_telemetry_metric_age_seconds", "gauge", "Seconds since each registered telemetry metric's last successful refresh (label: metric).")
declare("pas_telemetry_refresh_total", "counter", "Telemetry cache refresh passes completed.")
declare("pas_telemetry_refresh_errors_total", "counter", "Individual metric fetch failures across refresh passes.")
declare("pas_strategy_evaluations_total", "counter", "Strategy violation evaluations (label: strategy).")
declare("pas_strategy_violations_total", "counter", "Violating nodes found by strategy evaluations (label: strategy).")
declare("pas_strategy_enforcements_total", "counter", "Enforcement passes completed without error (label: strategy).")
declare("pas_deschedule_host_fallback_total", "counter", "Deschedule evaluations that fell back from the mirror's device to the host path while a mirror was attached.")
# controller plumbing (kube/workqueue.py and kube/informer.py; named
# instances only)
declare("pas_workqueue_depth", "gauge", "Current work-queue depth (label: queue).")
declare("pas_workqueue_adds_total", "counter", "Items accepted into the work queue (label: queue).")
declare("pas_workqueue_retries_total", "counter", "Rate-limited re-adds after failures (label: queue).")
declare("pas_workqueue_done_total", "counter", "Items finished processing (label: queue).")
declare("pas_informer_relists_total", "counter", "Informer list/re-list passes started (label: informer).")
declare("pas_informer_watch_errors_total", "counter", "Informer watch streams that broke and forced a re-list (label: informer).")
declare("pas_informer_synced", "gauge", "1 once the informer's initial list has delivered (label: informer).")
# fault-tolerant kube and metrics clients (kube/retry.py)
declare("pas_kube_retry_total", "counter", "API-call retries performed by the fault-tolerant client (labels: verb, reason in throttled/server_error/network/api_error).")
declare("pas_kube_giveup_total", "counter", "API calls abandoned after exhausting the retry budget or deadline (label: verb).")
declare("pas_circuit_state", "gauge", "Circuit-breaker state per endpoint group: 0 closed, 1 half-open, 2 open (label: group).")
declare("pas_circuit_transitions_total", "counter", "Circuit-breaker state transitions (labels: group, to).")
# degraded mode (tas/degraded.py) and leader election (kube/lease.py)
declare("pas_degraded", "gauge", "1 while the named subsystem runs degraded: telemetry (stale/unrefreshable), kube_api / metrics_api (circuit not closed), evictions (suspended) (label: subsystem).")
declare("pas_leader", "gauge", "1 while this replica holds the leadership lease and runs the singleton actuation loops (label: replica).")
declare("pas_leader_transitions_total", "counter", "Local leadership role changes (gained or lost) observed by this replica's elector.")
declare("pas_decision_records_total", "counter", "Scheduling decisions recorded into the decision log (label: verb).")
declare("pas_decision_filtered_nodes_total", "counter", "Nodes filtered out of scheduling decisions, by reason class (label: reason).")
declare("pas_decision_open", "gauge", "Decision records currently awaiting outcome feedback (pod bind).")
declare("pas_decision_closed_total", "counter", "Decision records closed by a pod-bind observation.")
declare("pas_decision_violated_at_bind_total", "counter", "Pods bound onto a node the Filter decision had marked violating.")
declare("pas_decision_chosen_rank_total", "counter", "Bind observations by the chosen node's rank in the Prioritize ordering (label: rank in 1/2/3/4_8/9_16/17_plus/unknown).")
declare("pas_decision_evicted_open_total", "counter", "Open decision records overwritten by the ring before any outcome feedback arrived.")
declare("pas_events_published_total", "counter", "Typed events accepted into the causal event journal (label: kind).")
declare("pas_events_dropped_total", "counter", "Oldest journal events evicted by ring overflow.")
declare("pas_explain_requests_total", "counter", "GET /debug/explain queries served.")
declare("pas_explain_chain_events", "gauge", "Events in the causal chain returned by the most recent /debug/explain query.")
# predictive telemetry (forecast/engine.py + ops/forecast.py: batched
# EWMA/Holt fits over the refresh history)
declare("pas_forecast_fit_passes_total", "counter", "Batched forecast fit passes completed (one per telemetry refresh pass with history movement).")
declare("pas_forecast_extrapolated_serves_total", "counter", "Degraded-mode requests served past the frozen-LKG window under forecast confidence: Prioritize ranks on the extrapolated predictions, Filter keeps the last-known-good verdicts alive.")
declare("pas_forecast_suppressed_evictions_total", "counter", "Eviction escalations held back because every violated metric was trending down (transient spike) when snapshot hysteresis would have escalated.")
declare("pas_forecast_metric_slope", "gauge", "Mean per-node forecast slope in metric units per second (label: metric).")

#: process-wide counters: path attribution and the observability planes
COUNTERS = CounterSet()


# ---------------------------------------------------------------------------
# request ids and spans
# ---------------------------------------------------------------------------


def new_request_id() -> str:
    """A fresh X-Request-ID (uuid4 hex — 32 chars, no dashes)."""
    return uuid.uuid4().hex


class _StageTimer:
    """``with span.stage("decode"):`` — one perf_counter pair."""

    __slots__ = ("_span", "_name", "_t0")

    def __init__(self, span: "Span", name: str):
        self._span = span
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._span.add_stage(self._name, time.perf_counter() - self._t0)
        return False


class Span:
    """One request's timeline: id, named stages, attributes, links.  Owned
    by the thread serving its request; the ring buffer takes the lock."""

    __slots__ = (
        "trace_id",
        "name",
        "start_wall",
        "_t0",
        "duration_s",
        "status",
        "stages",
        "attrs",
        "links",
    )

    def __init__(self, name: str, trace_id: Optional[str] = None, t0: Optional[float] = None):
        self.trace_id = trace_id or new_request_id()
        self.name = name
        now = time.perf_counter()
        self._t0 = t0 if t0 is not None else now
        # wall-clock start, back-dated when t0 predates construction
        self.start_wall = time.time() - (now - self._t0)
        self.duration_s: Optional[float] = None
        self.status: Optional[int] = None
        self.stages: List[Tuple[str, float, float]] = []  # (name, start, dur)
        self.attrs: Dict[str, object] = {}
        self.links: List[str] = []

    def stage(self, name: str) -> _StageTimer:
        return _StageTimer(self, name)

    def add_stage(self, name: str, seconds: float) -> None:
        """Record a stage that just ended (start inferred from now)."""
        offset = max(0.0, time.perf_counter() - self._t0 - seconds)
        self.stages.append((name, offset, seconds))

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def link(self, trace_id: str) -> None:
        self.links.append(trace_id)

    def finish(self, status: Optional[int] = None) -> "Span":
        self.duration_s = time.perf_counter() - self._t0
        if status is not None:
            self.status = status
        return self

    def stage_seconds(self) -> Dict[str, float]:
        """Total recorded seconds per stage name."""
        out: Dict[str, float] = {}
        for name, _start, dur in self.stages:
            out[name] = out.get(name, 0.0) + dur
        return out

    def to_dict(self) -> Dict:
        return {
            "id": self.trace_id,
            "name": self.name,
            "status": self.status,
            "start": round(self.start_wall, 6),
            "duration_ms": round((self.duration_s or 0.0) * 1e3, 4),
            "stages": [
                {
                    "name": name,
                    "start_ms": round(start * 1e3, 4),
                    "duration_ms": round(dur * 1e3, 4),
                }
                for name, start, dur in self.stages
            ],
            "attrs": dict(self.attrs),
            "links": list(self.links),
        }


class _NullStageTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_STAGE = _NullStageTimer()


class _NullSpan:
    """No-op span: instrumented code never branches on 'is tracing on'."""

    __slots__ = ()
    trace_id = ""
    name = ""
    duration_s = None
    status = None
    stages: List[Tuple[str, float, float]] = []
    attrs: Dict[str, object] = {}
    links: List[str] = []

    def stage(self, name: str) -> _NullStageTimer:
        return _NULL_STAGE

    def add_stage(self, name: str, seconds: float) -> None:
        pass

    def set(self, key: str, value) -> None:
        pass

    def link(self, trace_id: str) -> None:
        pass

    def finish(self, status: Optional[int] = None) -> "_NullSpan":
        return self

    def stage_seconds(self) -> Dict[str, float]:
        return {}

    def to_dict(self) -> Dict:
        return {}


NULL_SPAN = _NullSpan()


def of(request) -> Span:
    """The span riding on an HTTPRequest, or the no-op span."""
    span = getattr(request, "span", None)
    return span if span is not None else NULL_SPAN


# ---------------------------------------------------------------------------
# trace ring buffer
# ---------------------------------------------------------------------------

#: callables ``(span)`` run after every completed span lands in the buffer
#: (the event journal, utils/events.py, registers here); they run on the
#: request thread and their failures are swallowed
SPAN_OBSERVERS: List[Callable] = []


class TraceBuffer:
    """Bounded ring of recent completed spans + bounded top-K slowest."""

    def __init__(self, capacity: int = 256, slow_capacity: int = 32):
        self.capacity = max(1, capacity)
        self.slow_capacity = max(1, slow_capacity)
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=self.capacity)
        self._slow: List[Span] = []  # sorted by duration, slowest first

    def add(self, span: Span) -> None:
        if span.duration_s is None:
            span.finish()
        with self._lock:
            self._recent.append(span)
            slow = self._slow
            if len(slow) < self.slow_capacity or span.duration_s > slow[-1].duration_s:
                i = 0
                while i < len(slow) and slow[i].duration_s >= span.duration_s:
                    i += 1
                slow.insert(i, span)
                del slow[self.slow_capacity :]
        COUNTERS.inc("pas_traces_recorded_total")
        for observer in SPAN_OBSERVERS:
            try:
                observer(span)
            except Exception:
                pass

    def find(self, trace_id: str) -> Optional[Span]:
        with self._lock:
            for span in reversed(self._recent):
                if span.trace_id == trace_id:
                    return span
        return None

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._recent)

    def snapshot(self, verb: Optional[str] = None, min_ms: Optional[float] = None) -> Dict:
        """Both lists, optionally filtered by the ``verb`` attribute and a
        minimum duration — the ``?verb=`` / ``?min_ms=`` query params."""
        with self._lock:
            recent = list(self._recent)
            slow = list(self._slow)

        def keep(span: Span) -> bool:
            if verb is not None and span.attrs.get("verb") != verb:
                return False
            if min_ms is not None and (span.duration_s or 0.0) * 1e3 < min_ms:
                return False
            return True

        if verb is not None or min_ms is not None:
            recent = [s for s in recent if keep(s)]
            slow = [s for s in slow if keep(s)]
        out = {
            "capacity": self.capacity,
            "slow_capacity": self.slow_capacity,
            "recent": [s.to_dict() for s in recent],
            "slowest": [s.to_dict() for s in slow],
        }
        if verb is not None:
            out["verb"] = verb
        if min_ms is not None:
            out["min_ms"] = min_ms
        return out

    def to_json(self, verb: Optional[str] = None, min_ms: Optional[float] = None) -> bytes:
        return json.dumps(self.snapshot(verb=verb, min_ms=min_ms)).encode() + b"\n"


#: the process-wide buffer the server records into
TRACES = TraceBuffer()


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def help_texts() -> Dict[str, str]:
    return {name: help_text for name, (_kind, help_text) in METRICS.items()}


def exposition(
    recorders: Iterable[LatencyRecorder] = (),
    counter_sets: Iterable[CounterSet] = (),
) -> str:
    """One Prometheus text page: every recorder merged under the single
    ``pas_request_duration_seconds`` family, then each counter set, then
    the process-wide COUNTERS; HELP text from :data:`METRICS`."""
    helps = help_texts()
    parts = [histograms_text(list(recorders), help_texts=helps)]
    for cs in counter_sets:
        parts.append(cs.prometheus_text(help_texts=helps))
    parts.append(COUNTERS.prometheus_text(help_texts=helps))
    return "".join(parts)
