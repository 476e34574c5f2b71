"""The port's forecast plane held byte for byte against the JAX package's.

The same numpy inputs, made from seeds, go through both packages:

  * ``ops/forecast.forecast_reference`` (the plain version of the CUDA
    kernel ``csrc/forecast.cu``) against JAX ``forecast_device`` (XLA on
    the CPU) and ``forecast_host`` on random histories with values in
    +-2^30, missing samples, constant series, W from 1 to 40, and on edge
    cases (INT32_MIN, horizons 0, W and 2W + 1);
  * ``ops/state.build_history_tensor`` against JAX's on the same rings,
    the huge-value de-scale included;
  * the ``Forecaster`` against JAX's on fake clocks: refit memoization,
    horizon growth and its clamp, the forecast view, ``host_metric``,
    ``trend_milli`` / ``trending_down`` / ``predicts_surge``, ``describe``,
    ``/debug/forecast``'s JSON and the host-only metric;
  * forecast-ranked Prioritize through both extenders, native and exact
    (the wire extension off) and on the host path, in both wire modes;
  * degraded extrapolation, then the band-bound and horizon-cap
    fallbacks;
  * ``/debug/forecast``'s 200, 404 and 405."""

import json

import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.extender.server import HTTPRequest as JaxRequest
from platform_aware_scheduling_tpu.extender.server import Server as JaxServer
from platform_aware_scheduling_tpu.forecast import Forecaster as JaxForecaster
from platform_aware_scheduling_tpu.native import get_wirec as get_jax_wirec
from platform_aware_scheduling_tpu.ops import forecast as jax_forecast
from platform_aware_scheduling_tpu.ops import i64 as jax_i64
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.ops.state import build_history_tensor as jax_build_history_tensor
from platform_aware_scheduling_tpu.tas import degraded as jax_degraded
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import DummyMetricsClient as JaxDummyClient
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicy as JaxPolicy
from platform_aware_scheduling_tpu.tas.policy.v1alpha1 import TASPolicyRule as JaxRule
from platform_aware_scheduling_tpu.tas.telemetryscheduler import MetricsExtender as JaxExtender
from platform_aware_scheduling_tpu.testing.builders import make_policy, rule
from platform_aware_scheduling_tpu.utils import decisions as jax_decisions
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu.utils.tracing import CounterSet as JaxCounterSet
from platform_aware_scheduling_tpu_torch import convert, native
from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest, Server
from platform_aware_scheduling_tpu_torch.forecast import Forecaster
from platform_aware_scheduling_tpu_torch.ops import forecast as ops_forecast
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror, build_history_tensor
from platform_aware_scheduling_tpu_torch.tas import degraded
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient, NodeMetric
from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy, TASPolicyRule
from platform_aware_scheduling_tpu_torch.tas.telemetryscheduler import MetricsExtender
from platform_aware_scheduling_tpu_torch.testing.faults import FakeClock
from platform_aware_scheduling_tpu_torch.utils import decisions, trace
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

INT32_MIN = np.iinfo(np.int32).min
HEADERS = {"Content-Type": "application/json"}


def assert_results_equal(port, want, what=""):
    """Every field of a port ForecastResult equals the JAX one's, dtype
    (int32) and bits."""
    assert port._fields == want._fields
    for name, got, expected in zip(port._fields, port, want):
        expected = np.asarray(expected)
        assert got.dtype == torch.int32, (what, name)
        assert expected.dtype == np.int32, (what, name)
        assert np.array_equal(got.numpy(), expected), (what, name)


# ---------------------------------------------------------------------------
# the plain version of the kernel
# ---------------------------------------------------------------------------


def random_history(seed):
    """The JAX parity test's distribution: values in +-2^30, 70% valid,
    every 5th case constant, every 7th dense, every 11th empty; W 1-40."""
    rng = np.random.default_rng(1000 + seed)
    m, n, w = int(rng.integers(1, 6)), int(rng.integers(1, 10)), int(rng.integers(1, 41))
    values = rng.integers(-(2**30), 2**30, size=(m, n, w)).astype(np.int32)
    valid = rng.random((m, n, w)) < 0.7
    if seed % 5 == 0:
        values[:] = 54321
    if seed % 7 == 0:
        valid[:] = True
    if seed % 11 == 0:
        valid[:] = False
    return values, valid, int(rng.integers(0, 2 * w + 2))


@pytest.mark.parametrize("seed", range(36))
def test_reference_equals_jax_device_and_host(seed):
    values, valid, horizon = random_history(seed)
    port = ops_forecast.forecast_reference(*convert.history_tensor_from_numpy(values, valid, "cpu"), horizon)
    assert_results_equal(port, jax_forecast.forecast_device(values, valid, horizon), "device")
    assert_results_equal(port, jax_forecast.forecast_host(values, valid, horizon), "host")


def edge_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for w in (1, 2, 32, 64):
        cases[f"all invalid W={w}"] = (np.full((2, 3, w), 7, np.int32), np.zeros((2, 3, w), bool))
    ragged = np.zeros((3, 4, 32), bool)
    for n in range(4):
        ragged[:, n, 32 - 4 * (n + 1):] = True  # 4, 8, 12 and 16 trailing samples
    ragged[1, 2, 20] = False  # a gap
    cases["ragged"] = (rng.integers(-1000, 1000, size=(3, 4, 32)).astype(np.int32), ragged)
    cases["constant"] = (np.full((2, 2, 32), 123456, np.int32), np.ones((2, 2, 32), bool))
    cases["ceiling +-2^30"] = (
        (rng.integers(0, 2, size=(2, 5, 32)) * (2**31 - 2) - (2**30 - 1)).astype(np.int32),
        np.ones((2, 5, 32), bool),
    )
    extremes = np.array([INT32_MIN, 2**31 - 1, INT32_MIN, -(2**30), 2**30, INT32_MIN, 0, 2**31 - 1], np.int32)
    cases["INT32_MIN"] = (np.tile(extremes, (2, 3, 4)), np.ones((2, 3, 32), bool))
    cases["W=64 noisy"] = (rng.integers(-(2**30), 2**30, size=(2, 3, 64)).astype(np.int32), rng.random((2, 3, 64)) < 0.8)
    return cases


@pytest.mark.parametrize("case", sorted(edge_cases()))
def test_reference_edge_cases_equal_jax(case):
    values, valid = edge_cases()[case]
    w = values.shape[2]
    for horizon in (0, 1, w, 2 * w + 1):
        port = ops_forecast.forecast_reference(torch.from_numpy(values), torch.from_numpy(valid), horizon)
        assert_results_equal(port, jax_forecast.forecast_host(values, valid, horizon), (case, horizon))
        assert_results_equal(port, jax_forecast.forecast_device(values, valid, horizon), (case, horizon))


@pytest.mark.parametrize("seed", range(6))
def test_extend_horizon_equals_jax(seed):
    values, valid, horizon = random_history(seed)
    fit = jax_forecast.forecast_host(values, valid, horizon)
    port = convert.forecast_result_from_numpy(*fit, device="cpu")
    for h in (0, horizon + 1, 3 * horizon + 7):
        assert_results_equal(ops_forecast.extend_horizon(port, h), jax_forecast.extend_horizon(fit, h), h)
        # a fit extended to h equals a fresh fit at h
        fresh = ops_forecast.forecast_reference(torch.from_numpy(values), torch.from_numpy(valid), h)
        assert_results_equal(ops_forecast.extend_horizon(port, h), fresh)


def test_forecast_fit_on_cpu_is_the_reference():
    values, valid, horizon = random_history(3)
    got = ops_forecast.forecast_fit(torch.from_numpy(values), torch.from_numpy(valid), horizon)
    assert_results_equal(got, jax_forecast.forecast_host(values, valid, horizon))


# ---------------------------------------------------------------------------
# history staging
# ---------------------------------------------------------------------------


class TwinCaches:
    """A JAX cache + mirror and the port's, on one fake clock, with
    history rings at ``window``."""

    def __init__(self, window=8, clock=None):
        self.clock = clock or FakeClock()
        self.jax_cache = JaxCache(clock=self.clock.now)
        self.cache = AutoUpdatingCache(clock=self.clock.now)
        self.jax_mirror = JaxMirror()
        self.jax_mirror.attach(self.jax_cache)
        self.mirror = TensorStateMirror(device="cpu")
        self.mirror.attach(self.cache)
        self.window = window

    def configure(self):
        self.jax_cache.configure_history(self.window)
        self.cache.configure_history(self.window)

    def write(self, metric, values):
        """``values``: node -> Quantity string."""
        self.jax_cache.write_metric(metric, {n: JaxNodeMetric(value=JaxQuantity(v)) for n, v in values.items()})
        self.cache.write_metric(metric, {n: NodeMetric(value=Quantity(v)) for n, v in values.items()})

    def staged(self):
        jax_view, view = self.jax_mirror.device_view(), self.mirror.device_view()
        assert view.metric_index == jax_view.metric_index
        assert view.node_index == jax_view.node_index
        jax_gen, jax_history = self.jax_cache.history_snapshot()
        gen, history = self.cache.history_snapshot()
        assert gen == jax_gen
        assert history == jax_history
        return (
            build_history_tensor(view, history, self.window),
            jax_build_history_tensor(jax_view, jax_history, self.window),
        )


def assert_staged_equal(port, want):
    for name, got, expected in zip(port._fields, port, want):
        assert got.dtype == expected.dtype, name
        assert np.array_equal(got, expected, equal_nan=name == "last_stamp"), name


@pytest.mark.parametrize("seed", range(4))
def test_history_tensor_equals_jax(seed):
    rng = np.random.default_rng(seed)
    twins = TwinCaches(window=int(rng.integers(3, 9)))
    twins.configure()
    names = [f"n{i}" for i in range(int(rng.integers(3, 30)))]
    for step in range(int(rng.integers(1, 14))):
        twins.clock.advance(1.5)
        for metric in ("cpu", "mem", "huge"):
            keep = [n for n in names if rng.random() < 0.85]  # gaps and ragged series
            scale = 10**15 if metric == "huge" else 1000  # huge: ~2^60 milli, de-scaled
            twins.write(metric, {n: f"{int(rng.integers(-scale, scale))}m" for n in keep})
        if step == 3:
            names.append(f"late-{step}")  # a node interned mid-history
    port, want = twins.staged()
    assert_staged_equal(port, want)
    assert port.shift[twins.mirror.device_view().metric_index["huge"]] > 0


def test_history_alignment_and_gaps_equal_jax():
    twins = TwinCaches(window=4)
    twins.configure()
    twins.write("m", {"a": "1", "b": "2"})
    twins.write("m", {"a": "3"})  # b missing
    port, want = twins.staged()
    assert_staged_equal(port, want)
    row, col_b = twins.mirror.device_view().metric_index["m"], twins.mirror.device_view().node_index["b"]
    assert port.valid[row, col_b, 2] and not port.valid[row, col_b, 3]


def test_history_ring_dies_with_its_metric():
    twins = TwinCaches(window=4)
    twins.configure()
    for cache in (twins.jax_cache, twins.cache):
        cache.write_metric("m")  # registered once
    twins.write("m", {"a": "1"})
    twins.jax_cache.delete_metric("m")
    twins.cache.delete_metric("m")
    assert twins.cache.history_snapshot() == twins.jax_cache.history_snapshot()
    assert twins.cache.history_snapshot()[1] == {}


def test_history_window_rebound_equals_jax():
    twins = TwinCaches(window=6)
    twins.configure()
    for v in range(5):
        twins.write("m", {"a": str(v)})
    for cache in (twins.jax_cache, twins.cache):
        cache.configure_history(3)
        assert cache.history_window() == 3
    assert twins.cache.history_snapshot() == twins.jax_cache.history_snapshot()
    with pytest.raises(ValueError):
        twins.cache.configure_history(0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class TwinForecasters(TwinCaches):
    """TwinCaches plus a Forecaster on each side (same options, same fake
    clock, counters of their own)."""

    def __init__(self, window=8, **options):
        super().__init__(window=window)
        options.setdefault("period_s", 1.0)
        self.jax_counters, self.counters = JaxCounterSet(), CounterSet()
        self.jax_fc = JaxForecaster(
            self.jax_cache, self.jax_mirror, window=window, clock=self.clock.now, counters=self.jax_counters, **options
        )
        self.fc = Forecaster(
            self.cache, self.mirror, window=window, clock=self.clock.now, counters=self.counters, **options
        )

    def refresh(self):
        self.jax_fc.refresh()
        self.fc.refresh()

    def check(self):
        """Both fits as of now equal field for field."""
        jax_fit, fit = self.jax_fc.ensure_current(), self.fc.ensure_current()
        assert (fit is None) == (jax_fit is None)
        if fit is None:
            return None
        assert fit.horizon_steps == jax_fit.horizon_steps
        assert fit.rows == jax_fit.rows
        assert fit.generation == jax_fit.generation
        assert fit.fview_generation == jax_fit.fview_generation
        for name in ("predicted", "trend", "band", "present", "shift"):
            got, want = getattr(fit, name), getattr(jax_fit, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert_results_equal(fit.scaled, jax_fit.scaled)
        want_values = jax_i64.to_int64_np(jax_fit.fview.values)
        assert np.array_equal(fit.fview.values.numpy(), want_values)
        assert np.array_equal(fit.fview.present.numpy(), np.asarray(jax_fit.fview.present))
        assert fit.fview.row_versions == jax_fit.fview.row_versions
        assert fit.fview.version == jax_fit.fview.version < 0
        assert self.fc.snapshot() == self.jax_fc.snapshot()
        assert self.fc.to_json() == self.jax_fc.to_json()
        return fit


def trending_values(step, names):
    """A riser (+300 a step from 100), a faller, a flat node and a noisy
    one (seeded), as Quantity strings of whole units."""
    rng = np.random.default_rng(step)
    out = {}
    for i, name in enumerate(names):
        value = (100 + 300 * step, 5000 - 250 * step, 1950, 2000 + int(rng.integers(-400, 400)))[i % 4]
        out[name] = str(value)
    return out


NAMES = [f"node-{i}" for i in range(8)]


def trending_twins(steps=6, **options):
    twins = TwinForecasters(**options)
    for step in range(steps):
        twins.write("cpu", trending_values(step, NAMES))
    twins.refresh()
    return twins


def test_refit_memoized_per_generation():
    twins = TwinForecasters()
    twins.write("cpu", {"n": "5"})
    twins.refresh()
    twins.refresh()  # no history movement: no refit
    assert twins.counters.get("pas_forecast_fit_passes_total") == 1
    twins.write("cpu", {"n": "6"})
    twins.refresh()
    for counters in (twins.counters, twins.jax_counters):
        assert counters.get("pas_forecast_fit_passes_total") == 2
    twins.check()


def test_no_history_no_ranking():
    twins = TwinForecasters()
    assert twins.fc.ranking_view("cpu") is None and twins.jax_fc.ranking_view("cpu") is None
    assert twins.fc.ensure_current() is None
    assert twins.fc.snapshot() == twins.jax_fc.snapshot()
    assert twins.fc.extrapolation_ok() == twins.jax_fc.extrapolation_ok()


def test_fit_and_consumer_answers_equal_jax():
    twins = trending_twins()
    fit = twins.check()
    assert int(fit.predicted[fit.rows["cpu"], fit.fview.node_index["node-0"]]) > 1_600_000
    for node in NAMES + ["unknown"]:
        assert twins.fc.trend_milli("cpu", node) == twins.jax_fc.trend_milli("cpu", node)
        assert twins.fc.describe("cpu", node) == twins.jax_fc.describe("cpu", node)
        for metrics in (["cpu"], ["cpu", "absent"], ["absent"]):
            assert twins.fc.trending_down(node, metrics) == twins.jax_fc.trending_down(node, metrics)
    assert twins.fc.trending_down("node-1", ["cpu"]) is True
    assert twins.fc.trend_milli("cpu", "node-2") == 0
    for threshold in (0.0, 0.05, 10.0):
        assert twins.fc.predicts_surge(threshold) == twins.jax_fc.predicts_surge(threshold)
    host, jax_host = twins.fc.host_metric("cpu"), twins.jax_fc.host_metric("cpu")
    assert {n: m.value.milli_value_exact() for n, m in host.items()} == {
        n: m.value.milli_value_exact() for n, m in jax_host.items()
    }
    assert twins.fc.host_metric("absent") is None and twins.jax_fc.host_metric("absent") is None
    assert twins.fc.extrapolation_ok() == twins.jax_fc.extrapolation_ok()
    gauge = twins.counters.get("pas_forecast_metric_slope", labels={"metric": "cpu"})
    assert gauge == twins.jax_counters.get("pas_forecast_metric_slope", labels={"metric": "cpu"})


def test_horizon_grows_linearly_and_clamps():
    twins = trending_twins()
    assert twins.check().horizon_steps == 1
    for expected in (2, 3, 4, 6, 9):
        twins.clock.advance(1.0 if expected < 6 else float(expected - twins.fc.ensure_current().horizon_steps))
        assert twins.check().horizon_steps == expected
        assert twins.fc.ranking_view("cpu") is not None
    twins.clock.advance(1.0)  # base 1 + window 8 passed: both paths fall back
    assert twins.check().horizon_steps == 10
    assert twins.fc.ranking_view("cpu") is None and twins.jax_fc.ranking_view("cpu") is None
    assert twins.fc.host_metric("cpu") is None
    twins.clock.advance(2_600_000.0)  # a month: clamped one past the gates
    assert twins.check().horizon_steps == 10


def test_configured_horizon_capped_at_window():
    twins = trending_twins(horizon_s=100_000.0)
    assert twins.check().horizon_steps == 8


def test_extrapolation_bounds_runtime_update_equal_jax():
    twins = trending_twins()
    for fc in (twins.fc, twins.jax_fc):
        fc.set_extrapolation_bounds(band_bound=0.01, horizon_cap=3)
    assert twins.fc.extrapolation_ok() == twins.jax_fc.extrapolation_ok()
    twins.clock.advance(4.0)
    assert twins.fc.extrapolation_ok() == twins.jax_fc.extrapolation_ok()
    assert not twins.fc.extrapolation_ok()[0]
    for bad in ({"band_bound": 0}, {"horizon_cap": 0}):
        with pytest.raises(ValueError):
            twins.fc.set_extrapolation_bounds(**bad)


def test_counts_equal_jax():
    twins = trending_twins()
    for fc in (twins.fc, twins.jax_fc):
        fc.count_extrapolated_serve()
        fc.count_suppressed_eviction(0)
        fc.count_suppressed_eviction(3)
    for name in ("pas_forecast_extrapolated_serves_total", "pas_forecast_suppressed_evictions_total"):
        assert twins.counters.get(name) == twins.jax_counters.get(name) > 0


def test_metric_delete_drops_its_slope_gauge():
    twins = trending_twins()
    both = (twins.counters, twins.jax_counters)
    labels = {"metric": "cpu"}
    assert [c.get("pas_forecast_metric_slope", labels=labels, kind="gauge") != 0 for c in both] == [True, True]
    for cache in (twins.jax_cache, twins.cache):
        cache.write_metric("cpu")
        cache.delete_metric("cpu")
    assert [c.get("pas_forecast_metric_slope", labels=labels, kind="gauge") for c in both] == [0, 0]


def test_host_only_metric_never_forecasts():
    twins = TwinForecasters()
    for _ in range(3):
        twins.write("submilli", {"a": "0.0004", "b": "0.0006"})
    twins.refresh()
    assert twins.mirror.metric_host_only("submilli")
    ext = MetricsExtender(twins.cache, mirror=twins.mirror)
    jax_ext = JaxExtender(twins.jax_cache, mirror=twins.jax_mirror)

    class MustNotForecast:
        def host_metric(self, name):
            raise AssertionError("a host-only metric consulted the forecast")

    ext.forecaster = jax_ext.forecaster = MustNotForecast()
    got = ext._prioritize_host(TASPolicyRule(metricname="submilli", operator="GreaterThan", target=0), ["a", "b"])
    want = jax_ext._prioritize_host(JaxRule(metricname="submilli", operator="GreaterThan", target=0), ["a", "b"])
    assert [(p.host, p.score) for p in got] == [(p.host, p.score) for p in want] == [("b", 10), ("a", 9)]


# ---------------------------------------------------------------------------
# forecast-ranked Prioritize through both extenders
# ---------------------------------------------------------------------------


class TwinServices(TwinForecasters):
    """Both packages' extenders over TwinForecasters, wired as ``assemble``
    wires them: the forecaster set after construction, its ranking warm
    on the refresh-pass hook after its refit."""

    def __init__(self, node_cache_capable=True, **options):
        super().__init__(**options)
        self.jax_cache._refresh_period = self.cache._refresh_period = 1.0
        self.jax = JaxExtender(self.jax_cache, mirror=self.jax_mirror, node_cache_capable=node_cache_capable)
        self.port = MetricsExtender(self.cache, mirror=self.mirror, node_cache_capable=node_cache_capable)
        self.jax.forecaster, self.port.forecaster = self.jax_fc, self.fc
        self.jax_cache.on_refresh_pass.append(self.jax.warm_forecast_rankings)
        self.cache.on_refresh_pass.append(self.port.warm_forecast_rankings)
        for name, strategies in POLICIES.items():
            obj = make_policy(name, strategies=strategies)
            self.jax_cache.write_policy("default", name, JaxPolicy.from_obj(obj))
            self.cache.write_policy("default", name, TASPolicy.from_obj(obj))

    def refresh_pass(self, values):
        """One refresh pass on both caches: ``values`` metric -> {node:
        Quantity string}, through update_all_metrics (the refit hook)."""
        self.clock.advance(1.0)
        self.jax_cache.update_all_metrics(
            JaxDummyClient({m: {n: JaxNodeMetric(value=JaxQuantity(v)) for n, v in d.items()} for m, d in values.items()})
        )
        self.cache.update_all_metrics(
            DummyMetricsClient({m: {n: NodeMetric(value=Quantity(v)) for n, v in d.items()} for m, d in values.items()})
        )

    def post(self, verb, body, path=None):
        """The port's response after checking it equals the JAX one's;
        the span's attributes beside it."""
        span = trace.Span(f"POST /scheduler/{verb}")
        want = getattr(self.jax, verb)(JaxRequest("POST", f"/scheduler/{verb}", HEADERS, body))
        got = getattr(self.port, verb)(HTTPRequest("POST", f"/scheduler/{verb}", HEADERS, body, span=span))
        assert (got.status, got.headers, got.body) == (want.status, want.headers, want.body)
        return got, span.attrs


POLICIES = {
    "low": {
        "scheduleonmetric": [rule("load", "LessThan", 0)],
        "dontschedule": [rule("load", "GreaterThan", 5000)],
    },
    "high": {"scheduleonmetric": [rule("load", "GreaterThan", 0)]},
    "other": {"scheduleonmetric": [rule("spare", "GreaterThan", 0)]},
}
SERVICE_NODES = [f"node-{i:02d}" for i in range(24)]


def service_values(step, rng):
    """load: a quarter of the nodes rise 300 a step, a quarter fall, the
    rest churn; spare: seeded noise, some nodes missing."""
    load, spare = {}, {}
    for i, name in enumerate(SERVICE_NODES):
        kind = i % 4
        if kind == 0:
            value = 100 + 300 * step + 7 * i
        elif kind == 1:
            value = 4000 - 300 * step + 7 * i
        else:
            value = int(rng.integers(0, 5000))
        load[name] = f"{value}"
        if rng.random() < 0.9:
            spare[name] = f"{int(rng.integers(0, 10**6))}m"
    return {"load": load, "spare": spare}


def body(policy, names, nodes, pod="p"):
    pod_obj = {"metadata": {"name": pod, "namespace": "default", "labels": {"telemetry-policy": policy}}}
    out = {"Pod": pod_obj}
    if nodes:
        out["Nodes"] = {"items": [{"metadata": {"name": n}} for n in names]}
    else:
        out["NodeNames"] = list(names)
    return json.dumps(out).encode()


@pytest.fixture
def native_wire(monkeypatch):
    monkeypatch.delenv("PAS_TPU_NO_NATIVE", raising=False)
    if native.get_wirec() is None or get_jax_wirec() is None:
        pytest.skip("no C toolchain for the wire extensions")


def driven_services(node_cache_capable, steps=7, seed=0):
    twins = TwinServices(node_cache_capable=node_cache_capable)
    for cache in (twins.jax_cache, twins.cache):
        cache.write_metric("load")
        cache.write_metric("spare")
    rng = np.random.default_rng(seed)
    for step in range(steps):
        twins.refresh_pass(service_values(step, rng))
    twins.check()
    return twins, rng


def candidate_lists(seed):
    rng = np.random.default_rng(seed)
    subset = [SERVICE_NODES[i] for i in sorted(rng.choice(len(SERVICE_NODES), 15, replace=False))]
    return [SERVICE_NODES, subset, subset[::-1] + ["unknown-node"]]


@pytest.mark.parametrize("nodes", [True, False], ids=["Nodes", "NodeNames"])
def test_native_forecast_prioritize_equals_jax(native_wire, nodes):
    twins, rng = driven_services(node_cache_capable=not nodes)
    before = trace.COUNTERS.get("pas_prioritize_native_total")
    served = 0
    for round_ in range(3):
        for policy in POLICIES:
            for names in candidate_lists(round_):
                got, attrs = twins.post("prioritize", body(policy, names, nodes))
                assert got.status == 200
                assert attrs["path"] == "native"
                assert attrs.get("ranking") == "forecast"
                served += 1
        twins.refresh_pass(service_values(10 + round_, rng))
        twins.check()
    assert trace.COUNTERS.get("pas_prioritize_native_total") - before == served


def test_native_skeletons_keep_forecast_and_snapshot_apart(native_wire):
    """The same interned candidate list ranked on the forecast view, then
    on the snapshot (the forecaster switched off), then on the forecast
    again: each answer is its own ranking's, never a skeleton of the
    other's, on both packages."""
    twins, _rng = driven_services(node_cache_capable=True)
    request = body("low", SERVICE_NODES, False)
    answers = {}
    for label in ("forecast", "snapshot", "forecast", "snapshot"):
        forecaster = (twins.jax_fc, twins.fc) if label == "forecast" else (None, None)
        twins.jax.forecaster, twins.port.forecaster = forecaster
        for _ in range(3):  # the second sighting interns the span; the third is a skeleton hit
            got, attrs = twins.post("prioritize", request)
            assert attrs["path"] == "native" and attrs.get("ranking") == ("forecast" if forecaster[1] else None)
            assert answers.setdefault(label, got.body) == got.body
    assert answers["forecast"] != answers["snapshot"]


@pytest.mark.parametrize("nodes", [True, False], ids=["Nodes", "NodeNames"])
def test_exact_and_host_forecast_prioritize_equal_jax(monkeypatch, nodes):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    twins, _rng = driven_services(node_cache_capable=not nodes, seed=1)
    for policy in POLICIES:
        for names in candidate_lists(7):
            device, attrs = twins.post("prioritize", body(policy, names, nodes))
            assert (attrs["path"], attrs.get("ranking")) == ("device", "forecast")
            # the host path on the same forecasts, on both packages
            monkeypatch.setattr(twins.port, "_device_prioritize_ok", lambda *a, **k: False)
            monkeypatch.setattr(twins.jax, "_device_prioritize_ok", lambda *a, **k: False)
            host, attrs = twins.post("prioritize", body(policy, names, nodes))
            assert attrs["path"] == "host"
            monkeypatch.undo()
            monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
            if names is SERVICE_NODES:  # node order: ties break alike on both paths
                assert host.body == device.body


def test_forecast_ranking_differs_from_snapshot(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    twins, _rng = driven_services(node_cache_capable=True)
    forecast, _ = twins.post("prioritize", body("low", SERVICE_NODES, False))
    twins.port.forecaster = twins.jax.forecaster = None  # --forecast=off
    snapshot, attrs = twins.post("prioritize", body("low", SERVICE_NODES, False))
    assert "ranking" not in attrs
    assert forecast.body != snapshot.body


def test_decision_records_carry_forecast_provenance(monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    for log in (decisions.DECISIONS, jax_decisions.DECISIONS):
        log.configure(enabled=True, capacity=64)
    try:
        twins, _rng = driven_services(node_cache_capable=True)
        twins.post("prioritize", body("high", SERVICE_NODES, False, pod="traced"))
        got = decisions.DECISIONS.snapshot(verb="prioritize", limit=1)["records"][0]
        want = jax_decisions.DECISIONS.snapshot(verb="prioritize", limit=1)["records"][0]
        assert got["detail"] == want["detail"]
        assert got["detail"]["ranking"] == "forecast"
        assert got["detail"]["top"].startswith("predicted load=")
        assert got["score_head"] == want["score_head"]
    finally:
        for log in (decisions.DECISIONS, jax_decisions.DECISIONS):
            log.configure(enabled=True, capacity=512)


def test_forecast_warm_precedes_requests(monkeypatch):
    """After a refresh pass, the first request finds its forecast ranking
    warm: the refresh-pass hook ranked it after the refit."""
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    twins, rng = driven_services(node_cache_capable=True)
    twins.refresh_pass(service_values(20, rng))
    fview = twins.fc.ranking_view("load")
    compiled = twins.mirror.policy("default", "low")
    key = (fview.row_version(compiled.scheduleonmetric_row), compiled.scheduleonmetric_row, compiled.scheduleonmetric_op)
    assert key[0] < 0 and key in twins.port.fastpath._rank


# ---------------------------------------------------------------------------
# degraded extrapolation
# ---------------------------------------------------------------------------


def stale_twins(noisy, band_bound=0.25, window=64):
    """The JAX suite's set-up on both packages: 8 refreshes of one series,
    a 1 s period, controllers over the caches with the forecasters."""
    twins = TwinForecasters(window=window, band_bound=band_bound)
    twins.window = 8
    twins.configure()
    for cache in (twins.jax_cache, twins.cache):
        cache._refresh_period = 1.0
        cache.write_metric("cpu")
    rng = np.random.default_rng(5)
    for _ in range(8):
        value = 1000 + (int(rng.integers(-400, 400)) if noisy else 0)
        twins.clock.advance(1.0)
        twins.jax_cache.update_all_metrics(JaxDummyClient({"cpu": {"n": JaxNodeMetric(value=JaxQuantity(value))}}))
        twins.cache.update_all_metrics(DummyMetricsClient({"cpu": {"n": NodeMetric(value=Quantity(value))}}))
    controllers = (
        degraded.DegradedModeController(twins.cache, counters=CounterSet()),
        jax_degraded.DegradedModeController(twins.jax_cache, counters=JaxCounterSet()),
    )
    controllers[0].forecaster, controllers[1].forecaster = twins.fc, twins.jax_fc
    return twins, controllers


def decisions_of(controllers):
    got, want = [(c.prioritize_decision(), c.filter_decision(), c.evictions_allowed()) for c in controllers]
    assert got == want
    return got


def test_extrapolation_extends_lkg_window_like_jax():
    twins, controllers = stale_twins(noisy=False)
    assert decisions_of(controllers)[0][0] == degraded.ACTION_NORMAL
    twins.clock.advance(20.0)  # past the frozen-LKG window (3 s x 3)
    (action, reason), (filter_action, _), (allowed, _) = decisions_of(controllers)
    assert action == filter_action == degraded.ACTION_LAST_KNOWN_GOOD and "extrapolating" in reason
    assert not allowed  # extrapolation serves verbs, never evictions
    assert twins.counters.get("pas_forecast_extrapolated_serves_total") == twins.jax_counters.get(
        "pas_forecast_extrapolated_serves_total"
    ) >= 2


def test_wide_band_falls_back_like_jax():
    twins, controllers = stale_twins(noisy=True, band_bound=0.1)
    twins.clock.advance(20.0)
    ok, reason = twins.fc.extrapolation_ok()
    assert (ok, reason) == twins.jax_fc.extrapolation_ok() and not ok and "exceeds bound" in reason
    (action, _), (filter_action, _), _ = decisions_of(controllers)
    assert (action, filter_action) == (degraded.ACTION_NEUTRAL, degraded.ACTION_FAIL_OPEN)


def test_horizon_past_window_trips_like_jax():
    twins, controllers = stale_twins(noisy=False, window=16)
    twins.clock.advance(10.0)
    assert twins.fc.extrapolation_ok() == twins.jax_fc.extrapolation_ok()
    assert decisions_of(controllers)[0][0] == degraded.ACTION_LAST_KNOWN_GOOD
    twins.clock.advance(10.0)
    ok, reason = twins.fc.extrapolation_ok()
    assert (ok, reason) == twins.jax_fc.extrapolation_ok() and not ok and "lookback window" in reason
    assert decisions_of(controllers)[0][0] == degraded.ACTION_NEUTRAL


def test_degraded_prioritize_ranks_on_extrapolation(monkeypatch):
    """Through the verbs: past the frozen-LKG window with a calm history,
    both extenders serve last-known-good Prioritize ranked on the grown
    horizon's predictions, with the same bytes."""
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    twins = TwinServices(node_cache_capable=True, window=16)
    for cache in (twins.jax_cache, twins.cache):
        cache.write_metric("load")
    for step in range(12):
        load = {n: str(1000 + (40 * step if i % 3 == 0 else 0) + i) for i, n in enumerate(SERVICE_NODES)}
        twins.refresh_pass({"load": load})
    twins.jax.degraded = jax_degraded.DegradedModeController(twins.jax_cache, counters=JaxCounterSet())
    twins.port.degraded = degraded.DegradedModeController(twins.cache, counters=CounterSet())
    twins.jax.degraded.forecaster, twins.port.degraded.forecaster = twins.jax_fc, twins.fc
    twins.clock.advance(12.0)  # stale past 3 s x 3, horizon 13 <= 16
    got, attrs = twins.post("prioritize", body("low", SERVICE_NODES, False))
    assert "extrapolating" in attrs["degraded"] and attrs.get("ranking") == "forecast"
    assert twins.check().horizon_steps == 13
    twins.clock.advance(8.0)  # horizon 21 > 16: neutral
    got, attrs = twins.post("prioritize", body("low", SERVICE_NODES, False))
    assert attrs["path"] == "neutral" and all(e["Score"] == 0 for e in json.loads(got.body))


# ---------------------------------------------------------------------------
# /debug/forecast
# ---------------------------------------------------------------------------


def debug_get(server, method="GET"):
    return server.route(HTTPRequest(method, "/debug/forecast", {}, b"{}" if method == "POST" else b""))


def test_debug_forecast_200_404_405():
    twins, _rng = driven_services(node_cache_capable=True)
    server, jax_server = Server(twins.port), JaxServer(twins.jax)
    got = debug_get(server)
    want = jax_server.route(JaxRequest("GET", "/debug/forecast", {}, b""))
    assert (got.status, got.headers, got.body) == (want.status, want.headers, want.body)
    assert got.status == 200 and set(json.loads(got.body)["metrics"]) == {"load", "spare"}
    assert debug_get(server, "POST").status == 405
    index = json.loads(server.route(HTTPRequest("GET", "/debug", {}, b"")).body)
    assert "/debug/forecast" in [e["path"] for e in index["endpoints"]]
    twins.port.forecaster = twins.jax.forecaster = None
    got = debug_get(server)
    want = jax_server.route(JaxRequest("GET", "/debug/forecast", {}, b""))
    assert (got.status, got.body) == (want.status, want.body) == (404, b'{"error": "forecasting not configured"}\n')
    assert debug_get(server, "POST").status == 405
