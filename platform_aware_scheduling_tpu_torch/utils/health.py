"""Health and readiness: ``/healthz`` (process liveness) and ``/readyz``
(composite readiness).

The port's copy of the part of ``platform_aware_scheduling_tpu/utils/
health.py`` the server uses.  Readiness is a conjunction of named
conditions, each a callable returning ``(ok, reason)``: for TAS,
``kernels_warmed`` (the extender's warm pass completed) and
``telemetry_fresh`` (the cache's refresh loop is current).  ``/readyz``
answers 200 with the condition list when all hold, 503 otherwise; each
evaluation updates the ``pas_ready`` gauge and counts flips on
``pas_ready_transitions_total``.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.utils import klog, trace

#: a condition callable: () -> (ok, reason) — or a bare bool, normalized
Check = Callable[[], Tuple[bool, str]]

HEALTHZ_BODY = b'{"status": "ok"}\n'


class ReadinessProbe:
    """Named readiness conditions, evaluated per /readyz request.  No
    conditions means ready; a condition that raises is NOT ready, with the
    exception as its reason."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conditions: List[Tuple[str, Check]] = []
        self._last_ready: Optional[bool] = None

    def register(self, name: str, check: Check) -> "ReadinessProbe":
        with self._lock:
            self._conditions.append((name, check))
        return self

    def evaluate(self) -> Tuple[bool, List[Dict]]:
        """(ready, condition results); updates the gauge + flap counter."""
        with self._lock:
            conditions = list(self._conditions)
        results: List[Dict] = []
        ready = True
        for name, check in conditions:
            try:
                res = check()
                ok, reason = res if isinstance(res, tuple) else (bool(res), "")
            except Exception as exc:  # fail closed
                ok, reason = False, f"check raised: {exc!r}"
            results.append({"name": name, "ok": bool(ok), "reason": reason or "ok"})
            ready = ready and bool(ok)
        with self._lock:
            flipped = self._last_ready is not None and self._last_ready != ready
            self._last_ready = ready
        trace.COUNTERS.set_gauge("pas_ready", 1 if ready else 0)
        if flipped:
            trace.COUNTERS.inc("pas_ready_transitions_total")
        return ready, results

    def readyz_response(self) -> Tuple[int, bytes]:
        """(status, JSON body) for GET /readyz."""
        ready, results = self.evaluate()
        body = json.dumps({"ready": ready, "conditions": results}).encode() + b"\n"
        return (200 if ready else 503), body


def probe_for(scheduler) -> ReadinessProbe:
    """A probe seeded from the scheduler's ``readiness_conditions()``
    (a list of (name, check) pairs); a scheduler without one is always
    ready.  A provider that raises registers one failing condition."""
    probe = ReadinessProbe()
    conditions = getattr(scheduler, "readiness_conditions", None)
    if callable(conditions):
        try:
            for name, check in conditions():
                probe.register(name, check)
        except Exception as exc:
            reason = f"readiness_conditions provider raised: {exc!r}"
            klog.error("readiness_conditions failed: %s", exc)
            probe.register("readiness_conditions", lambda reason=reason: (False, reason))
    return probe


def informer_synced(informer, name: str) -> Check:
    """A condition over an Informer's ``has_synced`` (kube/informer.py)."""

    def check() -> Tuple[bool, str]:
        ok = bool(informer.has_synced())
        return ok, ("synced" if ok else f"{name} cache not yet synced")

    return check
