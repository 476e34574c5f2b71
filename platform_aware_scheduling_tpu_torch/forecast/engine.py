"""The forecasting engine: refresh-history rings -> one batched fit ->
forecast views every consumer shares.

The port's copy of ``platform_aware_scheduling_tpu/forecast/engine.py``.
One :class:`Forecaster` serves three consumers:

  * **scheduleonmetric** ranks on predicted-at-bind values: the engine
    publishes a *forecast DeviceView*, the same ``[M, N]`` int64 shape the
    ranking code consumes, holding predicted milli values instead of
    last-refresh ones, so the native fastpath and the exact host path rank
    through their existing machinery with the same bytes
    (``tas/telemetryscheduler.py``);
  * **deschedule / rebalance** tell a trend from a transient spike:
    :meth:`Forecaster.trending_down` and :meth:`Forecaster.predicts_surge`
    answer from per-node slopes;
  * **degraded last-known-good** carries on by bounded extrapolation: the
    fit's uncertainty band widens with the extrapolation distance, and
    ``tas/degraded.py`` keeps serving forecasts only while the relative
    band stays inside ``--forecastBandBound``.

Fits run OFF the request path: the cache's end-of-refresh-pass hook refits
once a pass in the refresh thread, on the mirror's device.  The history
lives there as an ``ops/state.HistoryRing``: a refit stages only the
samples appended since the last one, and the fit reads the ring in place
(the CUDA kernel ``csrc/forecast.cu`` on the card,
``ops/forecast.forecast_ring_reference`` for a CPU mirror).  A failed fit
is logged and the last published fit stands; a CUDA mirror never
publishes a fit of the plain version.
Requests only read the last published fit; the one request-path mutation
is the cheap horizon re-extension when staleness has grown by a refresh
period (plain tensor arithmetic over the stored fit, no kernel)."""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.ops import forecast as ops_forecast
from platform_aware_scheduling_tpu_torch.ops.state import DeviceView, HistoryRing
from platform_aware_scheduling_tpu_torch.utils import decisions, klog, trace
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

DEFAULT_WINDOW = 32
DEFAULT_BAND_BOUND = 0.25

#: relative-band denominator floor (milli): keeps near-zero predictions
#: from reading as infinitely uncertain
_REL_FLOOR_MILLI = 1000


class _Fit:
    """One published fit: everything request paths read, immutable after
    construction (swapped whole under the engine lock)."""

    __slots__ = (
        "generation",
        "view",
        "scaled",
        "shift",
        "horizon_steps",
        "fitted_at",
        "fview",
        "fview_generation",
        "predicted",
        "trend",
        "band",
        "present",
        "rows",
        "host_metrics",
        "extrapolation",
    )

    def __init__(self):
        self.host_metrics: Dict[str, Dict] = {}
        # the extrapolation_ok verdict, memoized on first use: the fit is
        # immutable, so the band reduction runs once a fit, not once a
        # degraded request (a benign race: the write is idempotent)
        self.extrapolation: Optional[Tuple[bool, str]] = None


class Forecaster:
    """One per assembled service (``--forecast=on``), attached to the
    extender (ranking and provenance) and the degraded-mode controller
    (bounded extrapolation)."""

    def __init__(
        self,
        cache,
        mirror,
        window: int = DEFAULT_WINDOW,
        horizon_s: Optional[float] = None,
        period_s: Optional[float] = None,
        band_bound: float = DEFAULT_BAND_BOUND,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[CounterSet] = None,
    ):
        self.cache = cache
        self.mirror = mirror
        self.window = int(window)
        self.horizon_s = horizon_s
        self._period_s = period_s
        self.band_bound = float(band_bound)
        #: optional cap (in refresh steps) on how far degraded-mode
        #: extrapolation may reach, below the window's; None: the window
        #: alone caps
        self.horizon_cap: Optional[int] = None
        self._clock = clock
        self.counters = counters if counters is not None else trace.COUNTERS
        self.enabled = True
        self._lock = threading.Lock()
        self._fit: Optional[_Fit] = None
        self._generation_seen = -1
        self._fview_generations = 0
        self.refit_stages_ms: Dict[str, float] = {}
        #: the history on the mirror's device, staged a sample at a time;
        #: refits take it in turn
        self._ring = HistoryRing(mirror.device)
        self._ring_lock = threading.Lock()
        cache.configure_history(self.window)
        # refit once a refresh pass, in the refresh thread: requests only
        # read a finished fit
        cache.on_refresh_pass.append(self.refresh)
        # an evicted metric takes its slope gauge with it
        cache.on_metric_delete.append(self._on_metric_delete)

    # -- timing ----------------------------------------------------------------

    def period_s(self) -> float:
        if self._period_s is not None:
            return float(self._period_s)
        period = getattr(self.cache, "_refresh_period", None)
        return float(period) if period else 1.0

    def _base_steps(self) -> int:
        """The configured horizon in refresh steps (default one period
        ahead: the value at the next refresh), capped at the lookback
        window: no fit predicts further ahead than it looked back, and an
        unbounded horizon would wrap the int32 tails (``trend * h``,
        ``resid * (1 + h)``) on every path alike."""
        if self.horizon_s is None:
            return 1
        steps = max(1, round(float(self.horizon_s) / self.period_s()))
        return min(steps, max(1, self.window))

    def _steps_now(self, fit: _Fit, now: float) -> int:
        """The horizon in steps as of ``now``: the base horizon plus the
        refresh periods elapsed since the fit, which makes the band widen
        through an outage.  Anchored on the BASE horizon, never on an
        already-extended fit's (``fitted_at`` survives extension, so adding
        elapsed periods to an extended horizon would compound)."""
        elapsed = max(0.0, now - fit.fitted_at)
        steps = self._base_steps() + int(elapsed // self.period_s())
        # clamped one past every consumer gate (the ranking fallback at
        # base + window, the degraded cap at window): growth past it
        # changes no decision and would wrap ``trend * h`` in the end
        return min(steps, self._base_steps() + self.window + 1)

    # -- fitting ---------------------------------------------------------------

    def refresh(self) -> None:
        """Refit against the current history if it moved; a cheap no-op
        otherwise.  Never raises (it is a cache refresh-pass hook): a
        failed fit is logged and the last published fit stands."""
        try:
            generation = self.cache.history_generation()
            with self._lock:
                if generation == self._generation_seen:
                    return
            self._refit(generation)
        except Exception as exc:  # noqa: BLE001 — the refresh loop must keep ticking
            klog.error("forecast refit failed: %r", exc)

    def _refit(self, generation: int) -> None:
        with self._ring_lock:
            t0 = time.perf_counter()
            _gen, history = self.cache.history_snapshot()
            view = self.mirror.device_view()
            ring = self._ring
            ring.stage(view, history, self.window)
            t1 = time.perf_counter()
            ring.upload()
            t2 = time.perf_counter()
            steps = self._base_steps()
            # the ring read in place on the mirror's device (the kernel on
            # the card), read back as CPU tensors
            scaled = ops_forecast.forecast_ring_fit(
                ring.values, ring.valid, ring.head, ring.shift_dev, ring.n_live, steps
            )
            t3 = time.perf_counter()
            fit = self._publishable_fit(view, ring.shift.copy(), scaled, steps)
            fit.generation = generation
            t4 = time.perf_counter()
        with self._lock:
            self._generation_seen = generation
            self._fit = fit
        #: the last refit's stages, wall ms: the snapshot and the new
        #: samples' staging, their upload, the fit with its readback,
        #: unscale and forecast view
        self.refit_stages_ms = {
            "staging": (t1 - t0) * 1e3,
            "upload": (t2 - t1) * 1e3,
            "fit": (t3 - t2) * 1e3,
            "view": (t4 - t3) * 1e3,
        }
        self.counters.inc("pas_forecast_fit_passes_total")
        self._publish_slope_gauges(fit)

    def _publishable_fit(self, view, shift, scaled, steps, present=None) -> _Fit:
        """Unscale the fit's outputs back to milli and stage the forecast
        DeviceView the ranking paths consume.  ``present`` (host bool
        ``[M, N]``) is the published mask when it is already known (a
        re-extension of a fit: same samples, same view)."""
        fit = _Fit()
        fit.view = view
        fit.scaled = scaled
        fit.shift = shift
        fit.horizon_steps = steps
        fit.fitted_at = self._clock()
        up = shift[:, None]
        fit.predicted = scaled.predicted.numpy().astype(np.int64) << up
        fit.trend = scaled.trend.numpy().astype(np.int64) << up
        fit.band = scaled.band.numpy().astype(np.int64) << up
        if present is None:
            present = (scaled.samples.numpy() >= 1) & view.present.cpu().numpy()
        fit.present = present
        fit.rows = dict(view.metric_index or {})
        with self._lock:
            # a marker per published forecast view: two views must never
            # share a row-version key in the ranking cache
            self._fview_generations += 1
            fit.fview_generation = self._fview_generations
        fit.fview = self._forecast_view(view, fit)
        return fit

    def _forecast_view(self, view, fit: _Fit) -> DeviceView:
        """The predicted-value DeviceView on the mirror's device: the real
        view's interning (the fastpath's encode tables are shared), but
        NEGATIVE version counters, so the ranking cache can never confuse
        a forecast ranking with a snapshot one (real row versions are
        always >= 0)."""
        device = view.values.device
        values = torch.from_numpy(fit.predicted).to(device)
        present = torch.from_numpy(fit.present).to(device)
        if device.type == "cuda":
            # the upload must have landed before any reader sees the view
            torch.cuda.current_stream(device).synchronize()
        marker = -int(fit.fview_generation)
        return DeviceView(
            values=values,
            present=present,
            node_names=view.node_names,
            node_index=view.node_index,
            version=marker,
            row_versions=tuple(marker for _ in range(fit.predicted.shape[0])),
            intern_version=view.intern_version,
            values_milli=fit.predicted,
            metric_index=fit.rows,
        )

    def ensure_current(self) -> Optional[_Fit]:
        """The fit as of NOW: re-extrapolates (predicted, band) when a
        refresh period has elapsed since the fit with no new samples (plain
        arithmetic over the stored fit, no kernel, at most once a
        period)."""
        now = self._clock()
        with self._lock:
            fit = self._fit
        if fit is None:
            return None
        steps = self._steps_now(fit, now)
        if steps == fit.horizon_steps:
            return fit
        extended = self._publishable_fit(
            fit.view, fit.shift, ops_forecast.extend_horizon(fit.scaled, steps), steps, present=fit.present
        )
        extended.generation = fit.generation
        extended.fitted_at = fit.fitted_at  # staleness keeps accruing
        with self._lock:
            if self._fit is fit:  # a concurrent refit wins
                self._fit = extended
                return extended
            return self._fit

    def _publish_slope_gauges(self, fit: _Fit) -> None:
        period = self.period_s()
        for name, row in fit.rows.items():
            if row >= fit.trend.shape[0]:
                continue
            mask = fit.present[row]
            if not mask.any():
                continue
            mean_slope = float(fit.trend[row][mask].mean())
            self.counters.set_gauge(
                "pas_forecast_metric_slope", round(mean_slope / 1000.0 / period, 6), labels={"metric": name}
            )

    def _on_metric_delete(self, name: str) -> None:
        self.counters.remove("pas_forecast_metric_slope", labels={"metric": name}, kind="gauge")

    # -- consumer answers ------------------------------------------------------

    def _row_for(self, fit: _Fit, metric_name: str) -> Optional[int]:
        row = fit.rows.get(metric_name)
        if row is None or row >= fit.predicted.shape[0]:
            return None
        return row

    def _ranking_horizon_ok(self, fit: _Fit) -> bool:
        """May rankings serve from this fit?  Only while staleness has grown
        the horizon by at most the lookback window past its base; past it
        the ranking paths fall back to snapshot values (this protects
        assemblies without a degraded-mode controller too)."""
        return fit.horizon_steps <= self._base_steps() + self.window

    def ranking_view(self, metric_name: str) -> Optional[DeviceView]:
        """The forecast DeviceView to rank this metric on, or None when no
        prediction exists (no history, unknown metric) or the fit is too
        stale to extrapolate: the caller then ranks on the snapshot."""
        fit = self.ensure_current()
        if fit is None or not self._ranking_horizon_ok(fit):
            return None
        row = self._row_for(fit, metric_name)
        if row is None or not fit.present[row].any():
            return None
        return fit.fview

    def host_metric(self, metric_name: str):
        """Predicted values as NodeMetricsInfo for the exact host ranking
        path: the SAME milli integers the forecast view carries, so native
        and host rankings on forecasts give the same bytes.  None under
        the same gate as :meth:`ranking_view`, so both paths fall back
        together."""
        fit = self.ensure_current()
        if fit is None or not self._ranking_horizon_ok(fit):
            return None
        row = self._row_for(fit, metric_name)
        if row is None or not fit.present[row].any():
            return None
        cached = fit.host_metrics.get(metric_name)
        if cached is not None:
            return cached
        from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
        from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity

        names = fit.fview.node_names
        predicted = fit.predicted[row]
        info = {
            names[col]: NodeMetric(value=Quantity(f"{int(predicted[col])}m"))
            for col in np.nonzero(fit.present[row])[0]
            if col < len(names)
        }
        fit.host_metrics[metric_name] = info
        return info

    def _trend_from(self, fit: _Fit, metric_name: str, node: str) -> Optional[int]:
        row = self._row_for(fit, metric_name)
        if row is None:
            return None
        col = fit.fview.node_index.get(node)
        if col is None or col >= fit.present.shape[1]:
            return None
        if not fit.present[row, col]:
            return None
        return int(fit.trend[row, col])

    def trend_milli(self, metric_name: str, node: str) -> Optional[int]:
        """Per-refresh-step slope (milli) of one series, or None."""
        fit = self.ensure_current()
        if fit is None:
            return None
        return self._trend_from(fit, metric_name, node)

    def trending_down(self, node: str, metric_names) -> bool:
        """True when every named metric with a known series at ``node`` has
        a strictly negative slope (and at least one is known): the
        transient-spike signature a drift detector holds streaks on.  All
        slopes read ONE fit."""
        fit = self.ensure_current()
        if fit is None:
            return False
        known = 0
        for name in metric_names:
            slope = self._trend_from(fit, name, node)
            if slope is None:
                continue
            known += 1
            if slope >= 0:
                return False
        return known > 0

    def predicts_surge(self, rate_threshold: float = 0.05) -> Tuple[bool, str]:
        """A budget controller's trend signal: True when any forecast
        metric's fleet-mean slope implies growth faster than
        ``rate_threshold`` of its current predicted magnitude a second."""
        fit = self.ensure_current()
        if fit is None:
            return False, "no forecast fit yet"
        period = self.period_s()
        for name, row in sorted(fit.rows.items()):
            if row >= fit.predicted.shape[0]:
                continue
            mask = fit.present[row]
            if not mask.any():
                continue
            slope_per_s = float(fit.trend[row][mask].astype(np.float64).mean()) / period
            level = float(np.abs(fit.predicted[row][mask]).astype(np.float64).mean())
            rate = slope_per_s / (level + _REL_FLOOR_MILLI)
            if rate > rate_threshold:
                return True, (
                    f"{name} growing {rate:.4f}/s of current level "
                    f"(threshold {rate_threshold:.4f}/s)"
                )
        return False, "no metric trending above threshold"

    def extrapolation_ok(self) -> Tuple[bool, str]:
        """May degraded last-known-good mode keep serving forecasts?  Yes
        while every forecast metric's mean relative band stays inside
        ``band_bound`` AND the horizon stays within the lookback window
        (a constant series keeps band 0 at any horizon; the window cap
        makes a long enough outage always trip back).  Memoized per fit."""
        fit = self.ensure_current()
        if fit is None:
            return False, "no forecast fit yet"
        if fit.extrapolation is not None:
            return fit.extrapolation
        fit.extrapolation = self._extrapolation_verdict(fit)
        return fit.extrapolation

    def set_extrapolation_bounds(
        self, band_bound: Optional[float] = None, horizon_cap: Optional[int] = None
    ) -> None:
        """Retighten (or relax) the degraded-mode bounds at runtime, and
        clear the memoized verdict on the CURRENT fit so the new bounds
        apply to requests against it at once."""
        with self._lock:
            if band_bound is not None:
                if band_bound <= 0:
                    raise ValueError(f"band_bound must be > 0, got {band_bound}")
                self.band_bound = float(band_bound)
            if horizon_cap is not None:
                if horizon_cap < 1:
                    raise ValueError(f"horizon_cap must be >= 1, got {horizon_cap}")
                self.horizon_cap = int(horizon_cap)
            if self._fit is not None:
                self._fit.extrapolation = None

    def _extrapolation_verdict(self, fit: _Fit) -> Tuple[bool, str]:
        cap = self.window
        if self.horizon_cap is not None:
            cap = min(cap, self.horizon_cap)
        if fit.horizon_steps > cap:
            return False, (
                f"extrapolation horizon {fit.horizon_steps} steps exceeds "
                f"the {cap}-step cap ({self.window}-sample lookback window)"
            )
        worst = 0.0
        covered = 0
        for _name, row in fit.rows.items():
            if row >= fit.predicted.shape[0]:
                continue
            mask = fit.present[row]
            if not mask.any():
                continue
            covered += 1
            rel = np.abs(fit.band[row][mask]).astype(np.float64) / (
                np.abs(fit.predicted[row][mask]).astype(np.float64) + _REL_FLOOR_MILLI
            )
            worst = max(worst, float(rel.mean()))
        if not covered:
            return False, "no forecastable metrics"
        if worst <= self.band_bound:
            return True, (
                f"forecast band {worst:.3f} within bound "
                f"{self.band_bound:.3f} at horizon "
                f"{fit.horizon_steps} steps"
            )
        return False, (
            f"forecast band {worst:.3f} exceeds bound "
            f"{self.band_bound:.3f} at horizon {fit.horizon_steps} steps"
        )

    def count_extrapolated_serve(self) -> None:
        """One degraded request served past the frozen-LKG window under
        forecast confidence (counted by ``tas/degraded.py``)."""
        self.counters.inc("pas_forecast_extrapolated_serves_total")

    def count_suppressed_eviction(self, n: int = 1) -> None:
        """Eviction streaks held by a negative-slope classification that
        snapshot hysteresis would have escalated."""
        if n:
            self.counters.inc("pas_forecast_suppressed_evictions_total", n)

    def describe(self, metric_name: str, node: str) -> Optional[str]:
        """The provenance string decision records carry, e.g.
        ``predicted cpu=93 (slope +2.1/s)``."""
        fit = self.ensure_current()
        if fit is None:
            return None
        row = self._row_for(fit, metric_name)
        if row is None:
            return None
        col = fit.fview.node_index.get(node)
        if col is None or col >= fit.present.shape[1]:
            return None
        if not fit.present[row, col]:
            return None
        value = decisions.fmt_milli(int(fit.predicted[row, col]))
        slope = int(fit.trend[row, col]) / 1000.0 / self.period_s()
        return f"predicted {metric_name}={value} (slope {slope:+.3g}/s)"

    # -- the debug surface -----------------------------------------------------

    def snapshot(self) -> Dict:
        fit = self.ensure_current()
        out: Dict = {
            "enabled": True,
            "window": self.window,
            "horizon_s": self.horizon_s,
            "period_s": self.period_s(),
            "band_bound": self.band_bound,
            "horizon_cap": self.horizon_cap,
            "fitted": fit is not None,
        }
        if fit is None:
            return out
        ok, reason = self.extrapolation_ok()
        out["horizon_steps"] = fit.horizon_steps
        out["extrapolation"] = {"ok": ok, "reason": reason}
        metrics: Dict[str, Dict] = {}
        names = fit.fview.node_names
        for name, row in sorted(fit.rows.items()):
            if row >= fit.predicted.shape[0]:
                continue
            mask = fit.present[row]
            count = int(mask.sum())
            entry: Dict = {"nodes": count}
            if count:
                entry["mean_slope_per_s"] = round(
                    float(fit.trend[row][mask].mean()) / 1000.0 / self.period_s(), 6
                )
                head: List[Dict] = []
                for col in np.nonzero(mask)[0][:5]:
                    if col >= len(names):
                        continue
                    head.append(
                        {
                            "node": names[col],
                            "predicted": decisions.fmt_milli(int(fit.predicted[row, col])),
                            "slope_per_step": decisions.fmt_milli(int(fit.trend[row, col])),
                            "band": decisions.fmt_milli(int(fit.band[row, col])),
                        }
                    )
                entry["head"] = head
            metrics[name] = entry
        out["metrics"] = metrics
        return out

    def to_json(self) -> bytes:
        return json.dumps(self.snapshot()).encode() + b"\n"
