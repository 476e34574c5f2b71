"""Scheduling decision provenance: per-decision explain records, the
bounded DecisionLog ring behind ``GET /debug/decisions``, and the reason
codes and strings shared by the host and device paths.

The port's copy of the TAS and GAS parts of
``platform_aware_scheduling_tpu/utils/decisions.py``:

  * the device path returns a per-node first-matching-rule index vector
    beside the Filter verdict (``ops/scoring.filter_explain``); the host
    strategy produces the same indexes
    (``tas/strategies/dontschedule.violated_details``).  Both format the
    SAME milli integers through :func:`rule_reason`, so the FailedNodes
    reason strings on the wire are byte-identical on both paths;
  * GAS Filter carries one class code a node (unknown node, no GPUs, no
    card fits, error) from the device bin-pack and the host loop alike,
    rendered by :func:`gas_reason`;
  * a DecisionRecord holds per-node detail by reference to structures
    shared across requests, so recording one is O(1);
  * a Bind observation closes the pod's open records and feeds the
    ``pas_decision_*`` placement-quality families.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from platform_aware_scheduling_tpu_torch.utils import trace

# ---------------------------------------------------------------------------
# reason codes
# ---------------------------------------------------------------------------

CODE_ELIGIBLE = 0
CODE_RULE_VIOLATION = 1
CODE_FAIL_CLOSED = 2
CODE_GAS_UNKNOWN_NODE = 3
CODE_GAS_NO_GPUS = 4
CODE_GAS_CAPACITY = 5
CODE_GAS_ERROR = 6  # host-loop unexpected failure; no device analog

#: code -> bounded Prometheus ``reason`` label
CODE_LABELS: Dict[int, str] = {
    CODE_RULE_VIOLATION: "rule_violation",
    CODE_FAIL_CLOSED: "fail_closed",
    CODE_GAS_UNKNOWN_NODE: "gas_unknown_node",
    CODE_GAS_NO_GPUS: "gas_no_gpus",
    CODE_GAS_CAPACITY: "gas_capacity",
    CODE_GAS_ERROR: "gas_error",
}

#: the FailedNodes reason of every candidate while Filter fails closed
REASON_FAIL_CLOSED = "degraded fail-closed"
REASON_GAS_UNKNOWN = "gas: node unknown to cache"
REASON_GAS_NO_GPUS = "gas: node has no GPUs"
REASON_GAS_ERROR = "gas: node could not be evaluated"

_OP_SYMBOLS = {"LessThan": "<", "GreaterThan": ">", "Equals": "=="}


def fmt_milli(milli: int) -> str:
    """Decimal string of a milli-unit int64 ("93000" -> "93", "500" ->
    "0.5")."""
    sign = "-" if milli < 0 else ""
    whole, frac = divmod(abs(int(milli)), 1000)
    if frac == 0:
        return f"{sign}{whole}"
    return f"{sign}{whole}.{str(frac).zfill(3).rstrip('0')}"


def rule_reason(policy: str, metric: str, operator: str, value_str: str, target_str: str) -> str:
    """The Filter ``FailedNodes`` reason for one violated rule, e.g.
    ``policy cpu-pol: metric cpu=93 > threshold 80``."""
    sym = _OP_SYMBOLS.get(operator, operator)
    return f"policy {policy}: metric {metric}={value_str} {sym} threshold {target_str}"


def gas_reason(code: int, request_summary: str = "") -> str:
    """The GAS Filter reason for one failed node; the same on the device
    and host paths, since both derive it from the code and the pod's own
    request."""
    if code == CODE_GAS_UNKNOWN_NODE:
        return REASON_GAS_UNKNOWN
    if code == CODE_GAS_NO_GPUS:
        return REASON_GAS_NO_GPUS
    if code == CODE_GAS_ERROR:
        return REASON_GAS_ERROR
    if request_summary:
        return f"gas: no card fits request ({request_summary})"
    return "gas: no card fits request"


def _rank_bucket(rank: Optional[int]) -> str:
    if rank is None:
        return "unknown"
    if rank <= 3:
        return str(rank)
    if rank <= 8:
        return "4_8"
    if rank <= 16:
        return "9_16"
    return "17_plus"


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

#: per-record bound on materialized per-node detail in to_dict()
DETAIL_NODE_CAP = 32

#: retention bound for a record's OWN per-request violating map; shared
#: per-state maps (scope "policy_state") stay full by reference
RETAIN_NODE_CAP = 128


class DecisionRecord:
    """One Filter/Prioritize decision, keyed by request id + pod.  Open
    until a Bind observation closes it or the ring overwrites it."""

    __slots__ = (
        "seq",
        "request_id",
        "verb",
        "pod_namespace",
        "pod_name",
        "policy",
        "path",
        "ts",
        "candidates",
        "eligible",
        "filtered",
        "violating",
        "violating_scope",
        "violating_total",
        "metric",
        "operator",
        "score_head",
        "planned",
        "outcome",
        "detail",
        "_ranked",
        "_node_index",
    )

    def __init__(
        self,
        verb: str,
        request_id: str = "",
        pod_namespace: str = "",
        pod_name: str = "",
        policy: str = "",
        path: str = "",
        candidates: int = 0,
        filtered: int = 0,
        violating: Optional[Mapping[str, str]] = None,
        violating_scope: str = "request",
        metric: str = "",
        operator: str = "",
        score_head: Optional[List[Tuple[str, int]]] = None,
        planned: Optional[str] = None,
        ranked: Optional[np.ndarray] = None,
        node_index: Optional[Mapping[str, int]] = None,
        detail: Optional[Dict] = None,
    ):
        self.seq = 0  # assigned by the log
        self.request_id = request_id
        self.verb = verb
        self.pod_namespace = pod_namespace
        self.pod_name = pod_name
        self.policy = policy
        self.path = path
        self.ts = 0.0  # stamped by the log's clock in add()
        self.candidates = candidates
        self.filtered = filtered
        self.eligible = max(0, candidates - filtered)
        violating = violating if violating is not None else {}
        self.violating_total = len(violating)
        if violating_scope == "request" and len(violating) > RETAIN_NODE_CAP:
            violating = dict(pair for pair, _ in zip(violating.items(), range(RETAIN_NODE_CAP)))
        self.violating = violating
        self.violating_scope = violating_scope
        self.metric = metric
        self.operator = operator
        self.score_head = score_head if score_head is not None else []
        self.planned = planned
        self.outcome: Optional[Dict] = None
        # verb-specific provenance (a forecast ranking's), None when absent
        self.detail = detail
        # device-path rank lookup at bind time: the shared global ranking
        # and interning table (references, not copies)
        self._ranked = ranked
        self._node_index = node_index

    @property
    def pod_key(self) -> str:
        return f"{self.pod_namespace}/{self.pod_name}"

    def chosen_rank(self, node: str) -> Optional[int]:
        """1-based score rank of ``node`` in this decision's ordering, or
        None when unknown (host-path records keep only the score head)."""
        if self._ranked is not None and self._node_index is not None:
            row = self._node_index.get(node)
            if row is None:
                return None
            at = np.nonzero(self._ranked == row)[0]
            return int(at[0]) + 1 if at.size else None
        for i, (name, _score) in enumerate(self.score_head):
            if name == node:
                return i + 1
        return None

    def to_dict(self) -> Dict:
        violating = {}
        truncated = self.violating_total > len(self.violating)
        for i, (name, reason) in enumerate(self.violating.items()):
            if i >= DETAIL_NODE_CAP:
                truncated = True
                break
            violating[name] = reason
        out = {
            "seq": self.seq,
            "request_id": self.request_id,
            "verb": self.verb,
            "pod": self.pod_key,
            "policy": self.policy,
            "path": self.path,
            "ts": round(self.ts, 6),
            "candidates": self.candidates,
            "eligible": self.eligible,
            "filtered": self.filtered,
            "violating": violating,
            "violating_scope": self.violating_scope,
            "open": self.outcome is None,
        }
        if truncated:
            out["violating_truncated"] = True
            out["violating_total"] = self.violating_total
        if self.metric:
            out["metric"] = self.metric
            out["operator"] = self.operator
        if self.score_head:
            out["score_head"] = [{"node": n, "score": s} for n, s in self.score_head]
        if self.planned is not None:
            out["planned"] = self.planned
        if self.detail is not None:
            out["detail"] = self.detail
        if self.outcome is not None:
            out["outcome"] = self.outcome
        return out


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------


class DecisionLog:
    """Bounded ring of DecisionRecords + a pod-keyed index of the OPEN
    ones.  One short lock per record or bind; /debug/decisions serves a
    snapshot."""

    def __init__(self, capacity: int = 512, clock: Callable[[], float] = time.time):
        self.capacity = max(1, capacity)
        self.enabled = True
        self._clock = clock
        self._lock = threading.Lock()
        self._records: deque = deque()
        self._open_by_pod: Dict[str, List[DecisionRecord]] = {}
        self._seq = 0
        self._recorded_total = 0
        self._open = 0

    def configure(self, enabled: Optional[bool] = None, capacity: Optional[int] = None) -> None:
        """Apply ``--decisionLog`` / ``--decisionLogSize``; empties the ring
        (its records were kept under the old retention)."""
        with self._lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            if enabled is not None:
                self.enabled = bool(enabled)
            self._records.clear()
            self._open_by_pod.clear()
            self._open = 0
            self._recorded_total = 0
        trace.COUNTERS.set_gauge("pas_decision_open", 0.0)

    def clear(self) -> None:
        """Empty the ring and its open index."""
        with self._lock:
            self._records.clear()
            self._open_by_pod.clear()
            self._open = 0
            self._recorded_total = 0
        trace.COUNTERS.set_gauge("pas_decision_open", 0.0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- recording -------------------------------------------------------------

    def add(self, record: DecisionRecord) -> None:
        if not self.enabled:
            return
        evicted_open = 0
        with self._lock:
            self._seq += 1
            record.seq = self._seq
            record.ts = self._clock()
            self._recorded_total += 1
            self._records.append(record)
            if record.outcome is None:
                self._open += 1
                self._open_by_pod.setdefault(record.pod_key, []).append(record)
            while len(self._records) > self.capacity:
                old = self._records.popleft()
                if old.outcome is None:
                    self._open -= 1
                    evicted_open += 1
                bucket = self._open_by_pod.get(old.pod_key)
                if bucket is not None:
                    try:
                        bucket.remove(old)
                    except ValueError:
                        pass
                    if not bucket:
                        del self._open_by_pod[old.pod_key]
            open_now = self._open
        trace.COUNTERS.inc("pas_decision_records_total", labels={"verb": record.verb})
        if evicted_open:
            trace.COUNTERS.inc("pas_decision_evicted_open_total", evicted_open)
        trace.COUNTERS.set_gauge("pas_decision_open", float(open_now))

    def record_filter(
        self,
        verb: str = "filter",
        reason_code: int = CODE_RULE_VIOLATION,
        reason_counts: Optional[Dict[int, int]] = None,
        **kwargs,
    ) -> None:
        """One Filter decision; ``filtered`` is the request's exact
        failed-node count, counted under ``reason_code``, or under each
        code of ``reason_counts`` ({code: node count}) when one request
        mixes reason classes (GAS: no-GPU nodes beside capacity misses)."""
        if not self.enabled:
            return
        record = DecisionRecord(verb=verb, **kwargs)
        self.add(record)
        if reason_counts:
            for code, count in reason_counts.items():
                if count:
                    trace.COUNTERS.inc(
                        "pas_decision_filtered_nodes_total",
                        count,
                        labels={"reason": CODE_LABELS.get(code, "other")},
                    )
        elif record.filtered:
            trace.COUNTERS.inc(
                "pas_decision_filtered_nodes_total",
                record.filtered,
                labels={"reason": CODE_LABELS.get(reason_code, "other")},
            )

    def record_prioritize(self, verb: str = "prioritize", **kwargs) -> None:
        if not self.enabled:
            return
        self.add(DecisionRecord(verb=verb, **kwargs))

    # -- outcome feedback ------------------------------------------------------

    def observe_bind(self, namespace: str, name: str, node: str) -> None:
        """A pod-bind observation: close the pod's open records, scoring
        the chosen node's rank in the Prioritize ordering and whether
        Filter had marked it violating."""
        if not self.enabled:
            return
        key = f"{namespace}/{name}"
        bound_at = self._clock()
        violated = False
        rank: Optional[int] = None
        # outcomes are assigned UNDER the lock: a record must never sit
        # decremented-from-_open but still outcome-None
        with self._lock:
            open_records = self._open_by_pod.pop(key, [])
            closed = [r for r in open_records if r.outcome is None]
            for record in closed:
                outcome: Dict = {"bound_node": node, "bound_at": round(bound_at, 6)}
                if record.verb.endswith("prioritize"):
                    r = record.chosen_rank(node)
                    outcome["rank"] = r
                    if rank is None:
                        rank = r
                if record.violating and node in record.violating:
                    outcome["violated_at_bind"] = True
                    outcome["violation_reason"] = record.violating[node]
                    violated = True
                record.outcome = outcome
            self._open -= len(closed)
            open_now = self._open
        if not closed:
            return
        trace.COUNTERS.inc("pas_decision_closed_total", len(closed))
        if any(r.verb.endswith("prioritize") for r in closed):
            trace.COUNTERS.inc(
                "pas_decision_chosen_rank_total", labels={"rank": _rank_bucket(rank)}
            )
        if violated:
            trace.COUNTERS.inc("pas_decision_violated_at_bind_total")
        trace.COUNTERS.set_gauge("pas_decision_open", float(open_now))

    # -- the debug surface -----------------------------------------------------

    def snapshot(
        self, pod: Optional[str] = None, verb: Optional[str] = None, limit: int = 64
    ) -> Dict:
        with self._lock:
            records = list(self._records)
            recorded_total = self._recorded_total
            open_count = self._open
        selected = []
        for record in reversed(records):  # newest first
            if pod is not None and pod not in (record.pod_name, record.pod_key):
                continue
            if verb is not None and record.verb != verb:
                continue
            selected.append(record.to_dict())
            if len(selected) >= max(1, limit):
                break
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "recorded_total": recorded_total,
            "open": open_count,
            "returned": len(selected),
            "records": selected,
        }

    def to_json(
        self, pod: Optional[str] = None, verb: Optional[str] = None, limit: int = 64
    ) -> bytes:
        return json.dumps(self.snapshot(pod=pod, verb=verb, limit=limit)).encode() + b"\n"


#: the process-wide log every verb records into; ``--decisionLog=off``
#: flips ``enabled`` through :meth:`DecisionLog.configure`
DECISIONS = DecisionLog()
