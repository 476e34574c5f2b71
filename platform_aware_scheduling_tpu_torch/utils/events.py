"""Causal event spine: one bounded journal the verbs publish into.

The port's copy of ``platform_aware_scheduling_tpu/utils/events.py``.
``JOURNAL`` is a process-wide, bounded, lock-light ring of typed events,
each carrying the correlation keys (``request_id``, ``pod``, ``gang``,
``node``) that let :meth:`EventJournal.explain` walk from a wire response
back through what led to it; ``GET /debug/explain`` serves it.

Publication is one short lock, one deque append and one counter bump;
overflow drops the oldest event and counts ``pas_events_dropped_total``.
A publish never raises into, or blocks, a verb.  A ``trace.SPAN_OBSERVERS``
hook registered at import turns every completed span that carries a
``verb`` attribute into a ``kind="wire"`` event.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from platform_aware_scheduling_tpu_torch.utils import trace

#: kinds that describe the WORLD rather than one entity: explain() joins
#: them into a chain by scheduler tick, not by correlation key
CONTEXT_KINDS = ("churn", "solve", "shard")


class EventJournal:
    """Bounded, lock-light, process-wide causal event ring.  Events carry
    ``tick`` -1: no scheduler tick source drives the port yet."""

    def __init__(self, capacity: int = 4096, clock: Callable[[], float] = time.monotonic):
        self.capacity = max(1, capacity)
        self.clock = clock
        self.enabled = True
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0

    def publish(
        self,
        kind: str,
        event: str,
        request_id: str = "",
        pod: str = "",
        gang: str = "",
        node: str = "",
        data: Optional[Dict] = None,
    ) -> None:
        """Append one typed event; never raises, never blocks a verb."""
        if not self.enabled:
            return
        record = {
            "seq": 0,  # assigned under the lock
            "t": self.clock(),
            "tick": -1,
            "kind": kind,
            "event": event,
            "request_id": request_id,
            "pod": pod,
            "gang": gang,
            "node": node,
            "data": data if data is not None else {},
        }
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                trace.COUNTERS.inc("pas_events_dropped_total")
            self._ring.append(record)
        trace.COUNTERS.inc("pas_events_published_total", labels={"kind": kind})

    def configure(self, enabled: Optional[bool] = None, capacity: Optional[int] = None) -> None:
        """Apply ``--events`` / ``--eventsSize``."""
        with self._lock:
            if capacity is not None and capacity != self.capacity:
                self.capacity = max(1, capacity)
                self._ring = deque(self._ring, maxlen=self.capacity)
        if enabled is not None:
            self.enabled = enabled

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def explain(self, request_id: str = "", pod: str = "", gang: str = "", node: str = "") -> Dict:
        """Walk the correlation graph from any one key: events matching
        the query seed a set of request ids, pods and gangs, and every
        event sharing one of them joins the chain, seq-ordered, with a
        one-line narrative per event."""
        events = self.snapshot()

        def direct(r: Dict) -> bool:
            return bool(
                (request_id and r["request_id"] == request_id)
                or (pod and r["pod"] == pod)
                or (gang and r["gang"] == gang)
                or (node and r["node"] == node)
            )

        seeds = [r for r in events if direct(r)]
        request_ids = {r["request_id"] for r in seeds if r["request_id"]}
        pods = {r["pod"] for r in seeds if r["pod"]}
        gangs = {r["gang"] for r in seeds if r["gang"]}

        def correlated(r: Dict) -> bool:
            return bool(
                (r["request_id"] and r["request_id"] in request_ids)
                or (r["pod"] and r["pod"] in pods)
                or (r["gang"] and r["gang"] in gangs)
                or direct(r)
            )

        chain = [r for r in events if correlated(r)]
        chain.sort(key=lambda r: r["seq"])
        ticks = {r["tick"] for r in chain if r["tick"] >= 0}
        in_chain = {r["seq"] for r in chain}
        context = [
            r
            for r in events
            if r["kind"] in CONTEXT_KINDS
            and r["tick"] >= 0
            and r["tick"] in ticks
            and r["seq"] not in in_chain
        ]
        context.sort(key=lambda r: r["seq"])
        trace.COUNTERS.inc("pas_explain_requests_total")
        trace.COUNTERS.set_gauge("pas_explain_chain_events", len(chain))
        return {
            "query": {"request_id": request_id, "pod": pod, "gang": gang, "node": node},
            "correlated": {
                "request_ids": sorted(request_ids),
                "pods": sorted(pods),
                "gangs": sorted(gangs),
            },
            "events": chain,
            "narrative": [_narrate(r) for r in chain],
            "context": context,
            "context_narrative": [_narrate(r) for r in context],
            "dropped": self.dropped,
        }

    def to_json(self, **query) -> bytes:
        return json.dumps(self.explain(**query)).encode() + b"\n"


def _narrate(r: Dict) -> str:
    """One human sentence per event."""
    head = f"[{r['kind']}] {r['event']}"
    subject = r["pod"] or r["gang"] or r["node"] or r["request_id"]
    if subject:
        head += f" {subject}"
    data = r.get("data") or {}
    detail = ", ".join(f"{k}={v}" for k, v in sorted(data.items()) if v not in ("", None))
    if detail:
        head += f" ({detail})"
    if r["tick"] >= 0:
        return f"tick {r['tick']}: {head}"
    return head


#: the process-wide journal the verbs publish into; ``--events=off`` flips
#: ``enabled`` through :meth:`EventJournal.configure`
JOURNAL = EventJournal()


def _on_span(span) -> None:
    """trace.SPAN_OBSERVERS hook: completed verb spans become wire events."""
    verb = span.attrs.get("verb")
    if not verb:
        return
    duration_us = round((span.duration_s or 0.0) * 1e6, 1)
    JOURNAL.publish(
        "wire",
        f"{verb} responded",
        request_id=span.trace_id,
        pod=str(span.attrs.get("pod", "")),
        gang=str(span.attrs.get("gang", "")),
        node=str(span.attrs.get("node", "")),
        data={"status": span.status, "duration_us": duration_us},
    )


trace.SPAN_OBSERVERS.append(_on_span)
