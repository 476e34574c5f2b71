"""The forecast plane's assembly in the port's service mains, and its
device rule.

TAS takes the four ``--forecast*`` flags with the JAX main's names and
defaults and GAS refuses them; ``forecast_options`` and ``build_forecaster``
answer as the JAX package's; ``cmd/tas.assemble`` builds the forecaster
before the extender and registers the extender's forecast warm after the
forecaster's refit on the refresh-pass hook; and a fit for a CUDA tensor
comes from the kernel or raises, never from the plain version."""

import json
import time
import types

import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.cmd import common as jax_common
from platform_aware_scheduling_tpu.cmd import gas as jax_gas
from platform_aware_scheduling_tpu.cmd import tas as jax_tas
from platform_aware_scheduling_tpu_torch.cmd import common, gas, tas
from platform_aware_scheduling_tpu_torch.forecast import Forecaster
from platform_aware_scheduling_tpu_torch.forecast import engine
from platform_aware_scheduling_tpu_torch.ops import cuda_forecast
from platform_aware_scheduling_tpu_torch.ops import forecast as ops_forecast
from platform_aware_scheduling_tpu_torch.ops.state import TensorStateMirror
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import DummyMetricsClient, NodeMetric
from platform_aware_scheduling_tpu_torch.testing.fake_kube import FakeKubeClient
from platform_aware_scheduling_tpu_torch.testing.faults import FakeClock
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

FLAGS = ["--forecast", "--forecastWindow", "--forecastHorizon", "--forecastBandBound"]


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--forecast=on"],
        ["--forecast", "on", "--forecastWindow", "16", "--forecastHorizon", "10s", "--forecastBandBound", "0.5"],
    ],
)
def test_tas_forecast_flags_parse_as_jax(argv):
    mine = vars(tas.build_arg_parser().parse_args(argv))
    theirs = vars(jax_tas.build_arg_parser().parse_args(argv))
    assert {k: mine[k] for k in ("forecast", "forecastWindow", "forecastHorizon", "forecastBandBound")} == {
        k: theirs[k] for k in ("forecast", "forecastWindow", "forecastHorizon", "forecastBandBound")
    }
    assert common.forecast_options(tas.build_arg_parser().parse_args(argv), 5.0) == jax_common.forecast_options(
        jax_tas.build_arg_parser().parse_args(argv), 5.0
    )


@pytest.mark.parametrize("flag", FLAGS)
def test_gas_refuses_forecast_flags_as_jax(flag):
    for parser in (gas.build_arg_parser(), jax_gas.build_arg_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args([flag, "on"])


def test_forecast_options_off_is_none_and_on_carries_the_period():
    assert common.forecast_options(tas.build_arg_parser().parse_args([]), 5.0) is None
    options = common.forecast_options(tas.build_arg_parser().parse_args(["--forecast=on"]), 2.5)
    assert options == {"window": 32, "horizon_s": None, "period_s": 2.5, "band_bound": 0.25}


def test_build_forecaster_needs_options_and_a_mirror():
    cache = AutoUpdatingCache()
    assert common.build_forecaster(cache, None, {"window": 8}) is None
    assert common.build_forecaster(cache, TensorStateMirror(device="cpu"), None) is None
    built = common.build_forecaster(cache, TensorStateMirror(device="cpu"), {"window": 8, "period_s": 1.0})
    assert isinstance(built, Forecaster) and cache.history_window() == 8


def test_assemble_wires_the_forecaster_in_order():
    kube = FakeKubeClient()
    cache, mirror, extender, _controller, _enforcer, stop = tas.assemble(
        kube,
        DummyMetricsClient({}),
        3600.0,
        degraded_mode="last-known-good",
        forecast_options={"window": 8, "period_s": 3600.0},
        device="cpu",
    )
    try:
        forecaster = extender.forecaster
        assert isinstance(forecaster, Forecaster)
        assert extender.degraded.forecaster is forecaster
        assert forecaster.mirror is mirror and forecaster.cache is cache
        assert cache.history_window() == 8
        hooks = cache.on_refresh_pass
        # the refit first, then the ranking warm over the fit it published
        assert hooks.index(forecaster.refresh) < hooks.index(extender.warm_forecast_rankings)
    finally:
        stop.set()


def test_assemble_without_forecast_options_is_snapshot_only():
    cache, _mirror, extender, _controller, _enforcer, stop = tas.assemble(
        FakeKubeClient(), DummyMetricsClient({}), 3600.0, degraded_mode="last-known-good", device="cpu"
    )
    try:
        assert extender.forecaster is None and extender.degraded.forecaster is None
        assert cache.history_window() == 0 and cache.on_refresh_pass == []
    finally:
        stop.set()


def test_assembled_service_ranks_on_forecasts():
    """``assemble`` with the options of ``--forecast=on``: refresh passes
    through the cache's own loop entry refit once each, and Prioritize
    ranks on the forecast view."""
    from platform_aware_scheduling_tpu_torch.extender.server import HTTPRequest
    from platform_aware_scheduling_tpu_torch.tas.policy.v1alpha1 import TASPolicy
    from platform_aware_scheduling_tpu_torch.testing.builders import make_policy, rule
    from platform_aware_scheduling_tpu_torch.utils import trace

    counters = CounterSet()
    cache, _mirror, extender, _controller, _enforcer, stop = tas.assemble(
        FakeKubeClient(),
        DummyMetricsClient({}),
        3600.0,
        node_cache_capable=True,
        forecast_options={"window": 8, "period_s": 3600.0, "counters": counters},
        device="cpu",
    )
    try:
        # the service's own refresh loop makes its first pass at once (then
        # sleeps the hour), and that pass's hook fits the empty history of
        # configure_history: the passes below start after it
        deadline = time.monotonic() + 60
        while not counters.get("pas_forecast_fit_passes_total") and time.monotonic() < deadline:
            time.sleep(0.01)
        fits = counters.get("pas_forecast_fit_passes_total")
        assert fits == 1 and cache.counters.get("pas_telemetry_refresh_total") == 1
        policy = make_policy("pol", strategies={"scheduleonmetric": [rule("load", "LessThan", 0)]})
        cache.write_policy("default", "pol", TASPolicy.from_obj(policy))
        cache.write_metric("load")  # registered, as the policy controller does
        names = [f"n{i}" for i in range(6)]
        for step in range(5):
            client = DummyMetricsClient(
                {"load": {n: NodeMetric(value=Quantity(str(100 * i + (200 * step if i == 0 else 0))))
                          for i, n in enumerate(names)}}
            )
            cache.update_all_metrics(client)
            assert counters.get("pas_forecast_fit_passes_total") == fits + step + 1
        span = trace.Span("POST /scheduler/prioritize")
        body = (
            b'{"Pod": {"metadata": {"name": "p", "namespace": "default", "labels": {"telemetry-policy": "pol"}}},'
            b' "NodeNames": ["n0", "n1", "n2", "n3", "n4", "n5"]}'
        )
        response = extender.prioritize(
            HTTPRequest("POST", "/scheduler/prioritize", {"Content-Type": "application/json"}, body, span=span)
        )
        assert response.status == 200 and span.attrs.get("ranking") == "forecast"
        # LessThan: ascending predicted values (all distinct here)
        fit = extender.forecaster.ensure_current()
        predicted = {n: int(fit.predicted[fit.rows["load"], fit.fview.node_index[n]]) for n in names}
        assert [e["Host"] for e in json.loads(response.body)] == sorted(names, key=predicted.get)
        assert predicted["n0"] > 800_000  # the riser's forecast passes its last sample
    finally:
        stop.set()


# -- the device rule ---------------------------------------------------------------


def cuda_like(array):
    """A stand-in that reports a CUDA device (this machine has none)."""
    return types.SimpleNamespace(device=torch.device("cuda"), data=array)


def ring_like(m=1, w=4, n=1):
    """A history ring's four tensors as stand-ins that report a CUDA
    device."""
    return (
        cuda_like(np.zeros((m, w, n), np.int64)),
        cuda_like(np.ones((m, w, n), np.uint8)),
        cuda_like(np.zeros(m, np.int32)),
        cuda_like(np.zeros(m, np.int32)),
    )


def test_cuda_fit_raises_with_the_kernel_never_the_plain_version(monkeypatch):
    def broken(values, valid, head, shift, n_live, horizon):
        raise RuntimeError("forecast kernel launch failed: cudaError 98")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version served a CUDA fit")

    monkeypatch.setattr(cuda_forecast, "forecast_ring_cuda", broken)
    monkeypatch.setattr(ops_forecast, "forecast_ring_reference", plain)
    monkeypatch.setattr(ops_forecast, "forecast_reference", plain)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        ops_forecast.forecast_ring_fit(*ring_like(), 1, 1)


def test_cuda_fit_reads_the_kernels_planes_back_in_field_order(monkeypatch):
    """The ring wrapper's ``[6, M, N]`` result comes back as CPU tensors,
    one plane a ``ForecastResult`` field in order."""
    packed = torch.arange(6 * 2 * 3, dtype=torch.int32).reshape(6, 2, 3)
    monkeypatch.setattr(cuda_forecast, "forecast_ring_cuda", lambda values, valid, head, shift, n_live, horizon: packed)
    got = ops_forecast.forecast_ring_fit(*ring_like(2, 4, 3), 3, 1)
    assert isinstance(got, ops_forecast.ForecastResult)
    for k, plane in enumerate(got):
        assert plane.device.type == "cpu" and torch.equal(plane, packed[k])


def test_refit_records_its_stages():
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    forecaster = Forecaster(cache, mirror, window=4, period_s=1.0, clock=FakeClock(), counters=CounterSet())
    assert forecaster.refit_stages_ms == {}
    cache.write_metric("m", {"a": NodeMetric(value=Quantity("1"))})
    forecaster.refresh()
    stages = forecaster.refit_stages_ms
    assert list(stages) == ["staging", "upload", "fit", "view"]
    assert all(ms >= 0.0 for ms in stages.values())


def test_cuda_wrapper_refuses_cpu_tensors():
    ring = (
        torch.zeros((1, 4, 1), dtype=torch.int64),
        torch.ones((1, 4, 1), dtype=torch.uint8),
        torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
    )
    with pytest.raises(ValueError, match="not cuda"):
        cuda_forecast.forecast_ring_cuda(*ring, 1, 1)


def test_failed_device_fit_publishes_nothing(monkeypatch):
    """A history ring on the card whose fit fails: ``refresh`` logs and
    publishes no fit (the last one stands), and the plain version is never
    consulted."""
    cache = AutoUpdatingCache()
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    counters = CounterSet()
    forecaster = Forecaster(cache, mirror, window=4, period_s=1.0, clock=FakeClock(), counters=counters)
    cache.write_metric("m", {"a": NodeMetric(value=Quantity("1"))})
    forecaster.refresh()
    published = forecaster.ensure_current()
    assert published is not None and counters.get("pas_forecast_fit_passes_total") == 1

    def plain(*args, **kwargs):
        raise AssertionError("the plain version served a CUDA fit")

    def broken(values, valid, head, shift, n_live, horizon):
        raise RuntimeError("forecast kernel launch failed: cudaError 98")

    monkeypatch.setattr(ops_forecast, "forecast_ring_reference", plain)
    monkeypatch.setattr(ops_forecast, "forecast_reference", plain)
    monkeypatch.setattr(cuda_forecast, "forecast_ring_cuda", broken)
    # the ring as one on the card: the refit's staging lands in its tensors
    # (this machine's), which the fit then finds reporting the card
    ring = forecaster._ring
    stage = ring.stage

    def staged_on_the_card(*args):
        stage(*args)
        ring.upload()
        monkeypatch.setattr(ring, "upload", lambda: None)
        for name in ("values", "valid", "head", "shift_dev"):
            monkeypatch.setattr(ring, name, cuda_like(getattr(ring, name)))

    monkeypatch.setattr(ring, "stage", staged_on_the_card)
    cache.write_metric("m", {"a": NodeMetric(value=Quantity("2"))})
    errors = []
    monkeypatch.setattr(engine.klog, "error", lambda msg, *args: errors.append(msg % args))
    forecaster.refresh()
    assert errors and "cudaError 98" in errors[0]
    assert ring.slots == 2  # the one new sample of each refit
    assert forecaster.ensure_current() is published
    assert counters.get("pas_forecast_fit_passes_total") == 1
