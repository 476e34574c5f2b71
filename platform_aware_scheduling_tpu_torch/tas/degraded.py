"""Degraded-mode policy: what every telemetry consumer does when the
remote dependencies misbehave.

The port's copy of ``platform_aware_scheduling_tpu/tas/degraded.py``.
The controller reads the cache's freshness signal and the circuit
breakers' states (``kube/retry.py``) and answers three questions, one per
consumer:

  * ``filter_decision``: Filter (dontschedule) under ``--degradedMode``:
    ``fail_open`` (every candidate passes), ``fail_closed`` (every
    candidate fails) or ``last-known-good`` (serve the cache's retained
    values while their age stays within a bounded multiple of the
    freshness bound, then fail open);
  * ``prioritize_decision``: Prioritize (scheduleonmetric), whatever the
    mode: last-known-good scores within the bounded age, then neutral
    priorities (every candidate scored alike);
  * ``evictions_allowed``: the hard invariant, not configurable: the
    deschedule label pass is suspended whenever telemetry is degraded or
    the kube circuit is not closed.  ``=violating`` labels are the trigger
    external deschedulers evict on; they are never written from data the
    service cannot trust, nor against an API server it cannot see.

The degraded state surfaces on the ``pas_degraded{subsystem}`` gauges and
as the ``degraded_mode`` condition of ``/readyz``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from platform_aware_scheduling_tpu_torch.kube.retry import GROUP_KUBE, GROUP_METRICS, STATE_CLOSED
from platform_aware_scheduling_tpu_torch.utils import trace
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

MODE_FAIL_OPEN = "fail-open"
MODE_FAIL_CLOSED = "fail-closed"
MODE_LAST_KNOWN_GOOD = "last-known-good"
MODES = (MODE_FAIL_OPEN, MODE_FAIL_CLOSED, MODE_LAST_KNOWN_GOOD)

#: last-known-good values stay servable this many freshness bounds past
#: freshness loss (with the default 3x-period bound: 9 periods)
DEFAULT_LKG_BOUND_MULTIPLE = 3.0

ACTION_NORMAL = "normal"
ACTION_LAST_KNOWN_GOOD = "last_known_good"
ACTION_NEUTRAL = "neutral"
ACTION_FAIL_OPEN = "fail_open"
ACTION_FAIL_CLOSED = "fail_closed"


class DegradedModeController:
    """One per assembled service, attached to the extender (verbs) and the
    enforcer (deschedule labelling)."""

    def __init__(
        self,
        cache=None,
        breakers=None,
        mode: str = MODE_LAST_KNOWN_GOOD,
        lkg_max_age_s: Optional[float] = None,
        counters: Optional[CounterSet] = None,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown degraded mode {mode!r}")
        self.cache = cache
        self.breakers = breakers  # CircuitBreakerRegistry or None
        self.mode = mode
        #: explicit last-known-good age bound; None derives it from the
        #: cache's freshness bound x lkg_bound_multiple
        self.lkg_max_age_s = lkg_max_age_s
        #: how many freshness bounds past staleness LKG answers stay servable
        self.lkg_bound_multiple = DEFAULT_LKG_BOUND_MULTIPLE
        self.counters = counters if counters is not None else trace.COUNTERS
        # the forecast.Forecaster under --forecast=on: while telemetry is
        # stale PAST the frozen-LKG window, last-known-good keeps serving
        # by bounded extrapolation (Prioritize ranks on the grown-horizon
        # predictions, Filter keeps its last-known-good verdicts) until the
        # widening band passes its bound.  Evictions stay suspended
        self.forecaster = None

    # -- inputs ----------------------------------------------------------------

    def _circuit_state(self, group: str) -> str:
        if self.breakers is None:
            return STATE_CLOSED
        return self.breakers.states().get(group, STATE_CLOSED)

    def telemetry_status(self) -> Tuple[bool, str]:
        """(healthy, reason): telemetry is degraded when the cache reports
        staleness OR the metrics-API circuit is not closed (refreshes are
        being refused, so the values will go stale)."""
        if self.cache is not None:
            fresh, reason = self.cache.telemetry_freshness()
            if not fresh:
                return False, f"telemetry stale: {reason}"
        state = self._circuit_state(GROUP_METRICS)
        if state != STATE_CLOSED:
            return False, f"metrics-API circuit {state}"
        return True, "telemetry fresh"

    def kube_status(self) -> Tuple[bool, str]:
        state = self._circuit_state(GROUP_KUBE)
        if state != STATE_CLOSED:
            return False, f"kube-API circuit {state}"
        return True, "kube API reachable"

    def _lkg_bound(self) -> Optional[float]:
        if self.lkg_max_age_s is not None:
            return self.lkg_max_age_s
        bound = None
        if self.cache is not None:
            bound = self.cache.freshness_bound()
        if bound is None:
            return None
        return bound * self.lkg_bound_multiple

    def _within_lkg_bound(self) -> bool:
        """Every registered metric still has retained data younger than
        the last-known-good bound."""
        if self.cache is None:
            return False
        bound = self._lkg_bound()
        if bound is None:
            return False
        ages = self.cache.metric_ages()
        if not ages:
            return False
        return all(age is not None and age <= bound for age in ages.values())

    def _extrapolation_ok(self) -> Tuple[bool, str]:
        """May a forecaster carry a consumer past the frozen-LKG window?
        Any trouble answers no, the pre-forecast behaviour."""
        if self.forecaster is None:
            return False, ""
        try:
            return self.forecaster.extrapolation_ok()
        except Exception:  # noqa: BLE001 — a failing forecaster must not fail the verb
            return False, "forecast extrapolation check failed"

    # -- the three consumer answers --------------------------------------------

    def filter_decision(self) -> Tuple[str, str]:
        """Filter's behaviour right now: ``normal`` when telemetry is
        healthy, else per the mode."""
        ok, reason = self.telemetry_status()
        if ok:
            self._publish(telemetry=False)
            return ACTION_NORMAL, reason
        self._publish(telemetry=True)
        if self.mode == MODE_FAIL_CLOSED:
            return ACTION_FAIL_CLOSED, reason
        if self.mode == MODE_LAST_KNOWN_GOOD:
            if self._within_lkg_bound():
                return ACTION_LAST_KNOWN_GOOD, reason
            extrapolate, band_reason = self._extrapolation_ok()
            if extrapolate:
                self.forecaster.count_extrapolated_serve()
                return ACTION_LAST_KNOWN_GOOD, f"{reason}; extrapolating: {band_reason}"
        return ACTION_FAIL_OPEN, reason

    def prioritize_decision(self) -> Tuple[str, str]:
        """Prioritize's behaviour right now, whatever the mode:
        last-known-good scores within the bounded age, then neutral."""
        ok, reason = self.telemetry_status()
        if ok:
            self._publish(telemetry=False)
            return ACTION_NORMAL, reason
        self._publish(telemetry=True)
        if self._within_lkg_bound():
            return ACTION_LAST_KNOWN_GOOD, reason
        extrapolate, band_reason = self._extrapolation_ok()
        if extrapolate:
            self.forecaster.count_extrapolated_serve()
            return ACTION_LAST_KNOWN_GOOD, f"{reason}; extrapolating: {band_reason}"
        return ACTION_NEUTRAL, reason

    def evictions_allowed(self) -> Tuple[bool, str]:
        """The hard invariant: no eviction pressure while telemetry is
        degraded or the kube circuit is not closed.  Not configurable."""
        telemetry_ok, telemetry_reason = self.telemetry_status()
        kube_ok, kube_reason = self.kube_status()
        allowed = telemetry_ok and kube_ok
        reasons = [r for ok, r in ((telemetry_ok, telemetry_reason), (kube_ok, kube_reason)) if not ok]
        self._publish(telemetry=not telemetry_ok, kube=not kube_ok, evictions=not allowed)
        if allowed:
            return True, "telemetry fresh, kube circuit closed"
        return False, "evictions suspended: " + "; ".join(reasons)

    # -- surfaces --------------------------------------------------------------

    def degraded_subsystems(self) -> List[str]:
        out = []
        if not self.telemetry_status()[0]:
            out.append("telemetry")
        if self._circuit_state(GROUP_METRICS) != STATE_CLOSED:
            out.append("metrics_api")
        if not self.kube_status()[0]:
            out.append("kube_api")
        if not self.evictions_allowed()[0]:
            out.append("evictions")
        return out

    def readiness_condition(self) -> Tuple[bool, str]:
        """The ``/readyz`` ``degraded_mode`` condition: the process keeps
        serving while degraded, and the reason says why it is not fully
        ready."""
        telemetry_ok, telemetry_reason = self.telemetry_status()
        kube_ok, kube_reason = self.kube_status()
        if telemetry_ok and kube_ok:
            return True, f"not degraded (mode {self.mode})"
        reasons = [r for ok, r in ((telemetry_ok, telemetry_reason), (kube_ok, kube_reason)) if not ok]
        filter_action, _ = self.filter_decision()
        prioritize_action, _ = self.prioritize_decision()
        return False, (
            f"degraded ({'; '.join(reasons)}); filter={filter_action}, "
            f"prioritize={prioritize_action}, evictions=suspended"
        )

    def status(self) -> Dict:
        """The controller's state as one JSON-able block."""
        telemetry_ok, telemetry_reason = self.telemetry_status()
        kube_ok, kube_reason = self.kube_status()
        evictions_ok, evictions_reason = self.evictions_allowed()
        filter_action, _ = self.filter_decision()
        prioritize_action, _ = self.prioritize_decision()
        return {
            "mode": self.mode,
            "lkg_bound_multiple": self.lkg_bound_multiple,
            "degraded": sorted(self.degraded_subsystems()),
            "telemetry": {"ok": telemetry_ok, "reason": telemetry_reason},
            "kube_api": {"ok": kube_ok, "reason": kube_reason},
            "evictions": {"allowed": evictions_ok, "reason": evictions_reason},
            "filter_action": filter_action,
            "prioritize_action": prioritize_action,
            "circuits": dict(self.breakers.states()) if self.breakers else {},
        }

    def _publish(
        self,
        telemetry: Optional[bool] = None,
        kube: Optional[bool] = None,
        evictions: Optional[bool] = None,
    ) -> None:
        """Keep the ``pas_degraded{subsystem}`` gauges current; each
        decision refreshes the subsystems it evaluated."""
        updates = {"telemetry": telemetry, "kube_api": kube, "evictions": evictions}
        for subsystem, value in updates.items():
            if value is None:
                continue
            self.counters.set_gauge("pas_degraded", 1 if value else 0, labels={"subsystem": subsystem})
        if telemetry is not None:
            self.counters.set_gauge(
                "pas_degraded",
                1 if self._circuit_state(GROUP_METRICS) != STATE_CLOSED else 0,
                labels={"subsystem": "metrics_api"},
            )
