"""The forecaster's history ring (``ops/state.HistoryRing``) held byte for
byte against both packages' ``build_history_tensor``, and its plain fit
against the JAX package's ``forecast_host``.

The same writes go to a JAX cache and mirror and to the port's, on one
fake clock.  After every step of seeded sequences the ring, staged a
sample at a time from the port's snapshot, is materialised
(``to_history_tensor``) and compared with the port's and the JAX
package's staging of the same rings: values, valid, shift and
``last_stamp``.  The sequences append, leave rings shorter than the
window, drop nodes from samples, delete a metric and register it again,
hand a freed row to another metric, rebind the window, intern new nodes
past the node capacity, and write values past 2^40 and ``INT64_MIN``.
The ring's plain fit (``ops/forecast.forecast_ring_reference``) equals
JAX ``forecast_host`` bit for bit at four horizons, on staged rings and on
random rings with any head and shift; and the ring looks up only the
samples it has not staged (``HistoryRing.lookups``)."""

import numpy as np
import pytest
import torch

from platform_aware_scheduling_tpu.ops import forecast as jax_forecast
from platform_aware_scheduling_tpu.ops.state import TensorStateMirror as JaxMirror
from platform_aware_scheduling_tpu.ops.state import build_history_tensor as jax_build_history_tensor
from platform_aware_scheduling_tpu.tas.cache import AutoUpdatingCache as JaxCache
from platform_aware_scheduling_tpu.tas.metrics import NodeMetric as JaxNodeMetric
from platform_aware_scheduling_tpu.utils.quantity import Quantity as JaxQuantity
from platform_aware_scheduling_tpu_torch.forecast import Forecaster
from platform_aware_scheduling_tpu_torch.ops import forecast as ops_forecast
from platform_aware_scheduling_tpu_torch.ops.state import HistoryRing, TensorStateMirror, build_history_tensor
from platform_aware_scheduling_tpu_torch.tas.cache import AutoUpdatingCache
from platform_aware_scheduling_tpu_torch.tas.metrics import NodeMetric
from platform_aware_scheduling_tpu_torch.testing.faults import FakeClock
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity
from platform_aware_scheduling_tpu_torch.utils.tracing import CounterSet

INT64_MIN = -(2**63)
HORIZONS = (0, 1, 7, 65)


class TwinRings:
    """A JAX cache and mirror and the port's on one fake clock, and a
    ``HistoryRing`` on the CPU staged from the port's snapshots."""

    def __init__(self, window):
        self.clock = FakeClock()
        self.jax_cache = JaxCache(clock=self.clock.now)
        self.cache = AutoUpdatingCache(clock=self.clock.now)
        self.jax_mirror = JaxMirror()
        self.jax_mirror.attach(self.jax_cache)
        self.mirror = TensorStateMirror(device="cpu")
        self.mirror.attach(self.cache)
        self.window = window
        self.ring = HistoryRing("cpu")
        self.configure(window)

    def configure(self, window):
        self.window = window
        for cache in (self.jax_cache, self.cache):
            cache.configure_history(window)

    def write(self, metric, milli):
        """``milli``: node -> int milli value."""
        self.clock.advance(1.0)
        self.jax_cache.write_metric(
            metric, {n: JaxNodeMetric(value=JaxQuantity(f"{v}m")) for n, v in milli.items()}
        )
        self.cache.write_metric(metric, {n: NodeMetric(value=Quantity(f"{v}m")) for n, v in milli.items()})

    def register(self, metric):
        for cache in (self.jax_cache, self.cache):
            cache.write_metric(metric)

    def delete(self, metric):
        for cache in (self.jax_cache, self.cache):
            cache.delete_metric(metric)

    def check(self, what=""):
        """Stage the ring, then hold its materialised form against both
        packages' staging of the same rings; returns the staging."""
        view, jax_view = self.mirror.device_view(), self.jax_mirror.device_view()
        assert view.metric_index == jax_view.metric_index and view.node_index == jax_view.node_index
        gen, history = self.cache.history_snapshot()
        jax_gen, jax_history = self.jax_cache.history_snapshot()
        assert gen == jax_gen and history == jax_history
        self.ring.stage(view, history, self.window)
        self.ring.upload()
        got = self.ring.to_history_tensor()
        for want in (build_history_tensor(view, history, self.window), jax_build_history_tensor(jax_view, jax_history, self.window)):
            for name, g, x in zip(got._fields, got, want):
                assert g.dtype == x.dtype and g.shape == x.shape, (what, name)
                assert np.array_equal(g, x, equal_nan=name == "last_stamp"), (what, name)
        assert self.ring.n_live == len(view.node_names)
        return got


def draw(rng, names, scale):
    """A sample over a random 80% of ``names``: values in +-``scale``
    milli, now and then one at ``INT64_MIN`` or ``INT64_MAX``."""
    out = {}
    for name in names:
        if rng.random() < 0.8:
            out[name] = int(rng.integers(-scale, scale))
    if out and rng.random() < 0.1:
        out[next(iter(out))] = INT64_MIN if rng.random() < 0.5 else 2**63 - 1
    return out


@pytest.mark.parametrize("seed", range(6))
def test_ring_equals_both_stagings_after_every_step(seed):
    rng = np.random.default_rng(seed)
    twins = TwinRings(window=int(rng.integers(2, 7)))
    names = [f"n{i}" for i in range(int(rng.integers(3, 12)))]
    metrics = ["cpu", "mem", "huge"]
    twins.register("mem")
    scales = {"cpu": 10**6, "mem": 10**4, "huge": 2**50, "disk": 10**5}
    for step in range(int(rng.integers(20, 34))):
        for metric in metrics:
            if rng.random() < 0.85:  # some passes skip a metric
                twins.write(metric, draw(rng, names, scales[metric]))
        event = rng.random()
        if event < 0.15:
            names += [f"late{step}-{k}" for k in range(int(rng.integers(1, 30)))]  # intern, capacity growth
        elif event < 0.25:
            names = [n for n in names if rng.random() < 0.7] or names  # nodes leave the samples
        elif event < 0.32 and "mem" in metrics:
            twins.delete("mem")  # its ring and row go
            metrics = [m for m in metrics if m != "mem"]
        elif event < 0.40 and "mem" not in metrics:
            metric = "disk" if rng.random() < 0.5 and "disk" not in metrics else "mem"
            twins.register(metric)  # a freed row, maybe another metric's
            metrics.append(metric)
        elif event < 0.46:
            twins.configure(int(rng.integers(1, 8)))  # rebinds every ring
        twins.check(f"seed {seed} step {step}")


def test_short_rings_gaps_and_missing_nodes():
    twins = TwinRings(window=5)
    twins.write("m", {"a": 1, "b": 2})
    staged = twins.check("one sample")
    row, col_b = twins.mirror.device_view().metric_index["m"], twins.mirror.device_view().node_index["b"]
    assert staged.valid[row, col_b].tolist() == [False] * 4 + [True]
    twins.write("m", {"a": 3})  # b missing
    staged = twins.check("b missing")
    assert staged.valid[row, col_b].tolist() == [False] * 3 + [True, False]
    twins.write("m", {})  # a write without data registers, appends nothing
    twins.check("no sample")
    for v in range(6):
        twins.write("m", {"a": v, "b": -v})
        twins.check(f"wrap {v}")


def test_huge_values_shift_on_the_ring_as_on_the_staging():
    twins = TwinRings(window=4)
    twins.write("m", {"a": 5, "b": -7})
    assert twins.check().shift.max() == 0
    twins.write("m", {"a": 2**41 + 3, "b": -(2**45)})
    staged = twins.check("past 2^40")
    assert staged.shift.max() > 0
    twins.write("m", {"a": INT64_MIN})
    staged = twins.check("INT64_MIN")
    for _ in range(4):  # the huge samples leave the window: the shift drops
        twins.write("m", {"a": 9, "b": 11})
        staged = twins.check("calm")
    assert staged.shift.max() == 0


def test_int64_min_beside_invalid_columns_is_no_magnitude():
    """``INT64_MIN``'s magnitude reads negative, so beside an invalid
    column (the mask's 0) it sets no shift."""
    twins = TwinRings(window=1)
    twins.write("m", {"a": 5})
    twins.write("m", {"a": INT64_MIN})
    staged = twins.check("INT64_MIN alone")
    assert staged.shift.max() == 0


def test_every_column_valid_with_int64_min():
    """No invalid column in any slot: the mask's 0 is not in the row's
    maximum, which ``INT64_MIN``'s own magnitude (negative) then sets."""
    twins = TwinRings(window=2)
    names = [f"n{i}" for i in range(64)]  # the mirror's whole node capacity
    for _ in range(3):
        twins.write("m", {n: INT64_MIN for n in names})
        staged = twins.check("all INT64_MIN")
    row = twins.mirror.device_view().metric_index["m"]
    assert staged.valid[row].all() and staged.shift[row] > 0


def test_window_rebound_and_cache_window_apart():
    """The ring restages when the window changes, and keeps up when the
    cache's rings are shorter than the window it stages."""
    twins = TwinRings(window=6)
    for v in range(8):
        twins.write("m", {"a": v * 1000, "b": v})
        twins.check()
    twins.configure(3)
    for v in range(4):
        twins.write("m", {"a": -v})
        twins.check("rebound to 3")
    for cache in (twins.jax_cache, twins.cache):
        cache.configure_history(2)  # the cache's rings now hold 2
    for v in range(4):
        twins.write("m", {"a": v, "b": 2 * v})
        twins.check("cache window 2, ring window 3")


def ring_fit_against_jax(ring, staged, what=""):
    for horizon in HORIZONS:
        got = ops_forecast.forecast_ring_reference(
            ring.values, ring.valid, ring.head, ring.shift_dev, ring.n_live, horizon
        )
        want = jax_forecast.forecast_host(staged.values, staged.valid, horizon)
        for name, g, x in zip(got._fields, got, want):
            x = np.asarray(x)
            assert g.dtype == torch.int32 and x.dtype == np.int32, (what, name)
            assert np.array_equal(g.numpy(), x), (what, horizon, name)


@pytest.mark.parametrize("seed", range(4))
def test_plain_ring_fit_equals_jax_forecast_host(seed):
    rng = np.random.default_rng(100 + seed)
    twins = TwinRings(window=int(rng.integers(3, 9)))
    names = [f"n{i}" for i in range(int(rng.integers(5, 80)))]
    for step in range(int(rng.integers(5, 20))):
        for metric, scale in (("cpu", 10**6), ("huge", 2**52)):
            twins.write(metric, draw(rng, names, scale))
        staged = twins.check()
        jax_view = twins.jax_mirror.device_view()
        want = jax_build_history_tensor(jax_view, twins.jax_cache.history_snapshot()[1], twins.window)
        ring_fit_against_jax(twins.ring, want, f"seed {seed} step {step}")
        assert np.array_equal(staged.values, want.values)


@pytest.mark.parametrize("seed", range(8))
def test_plain_ring_fit_any_head_and_shift(seed):
    """Random rings: raw int64 values over the whole range, any head in
    [0, W) and shift in [0, 63], columns past ``n_live`` holding stray
    valid bytes the fit must not read; held against ``forecast_host`` on
    the staging done by hand (numpy's shift and int32 cast)."""
    rng = np.random.default_rng(200 + seed)
    m, w, n = int(rng.integers(1, 5)), int(rng.integers(1, 40)), int(rng.integers(1, 50))
    values = rng.integers(INT64_MIN, 2**63 - 1, size=(m, w, n), dtype=np.int64, endpoint=True)
    values[:, :, ::7] = INT64_MIN
    valid = (rng.random((m, w, n)) < 0.7).astype(np.uint8)
    head = rng.integers(0, w, size=m).astype(np.int32)
    shift = rng.integers(0, 64, size=m).astype(np.int32)
    shift[0] = 0
    n_live = int(rng.integers(0, n + 1))
    order = (head[:, None].astype(np.int64) + np.arange(w)) % w
    x = np.take_along_axis(values, order[:, :, None], axis=1) >> shift.astype(np.int64)[:, None, None]
    ok = np.take_along_axis(valid, order[:, :, None], axis=1).astype(bool)
    ok[:, :, n_live:] = False
    staged_values = np.ascontiguousarray(x.astype(np.int32).transpose(0, 2, 1))
    staged_valid = np.ascontiguousarray(ok.transpose(0, 2, 1))
    for horizon in HORIZONS:
        got = ops_forecast.forecast_ring_reference(
            torch.from_numpy(values), torch.from_numpy(valid), torch.from_numpy(head), torch.from_numpy(shift),
            n_live, horizon,
        )
        want = jax_forecast.forecast_host(staged_values, staged_valid, horizon)
        for name, g, x in zip(got._fields, got, want):
            assert np.array_equal(g.numpy(), np.asarray(x)), (seed, horizon, name)


def test_ring_fit_on_cpu_is_the_plain_version():
    twins = TwinRings(window=4)
    for v in range(5):
        twins.write("m", {"a": 100 * v, "b": 7})
    twins.check()
    ring = twins.ring
    got = ops_forecast.forecast_ring_fit(ring.values, ring.valid, ring.head, ring.shift_dev, ring.n_live, 3)
    want = ops_forecast.forecast_ring_reference(ring.values, ring.valid, ring.head, ring.shift_dev, ring.n_live, 3)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_a_continued_ring_looks_up_only_its_new_samples():
    """A continued ring stages one slot a metric a pass; it looks up a new
    sample's nodes only when they differ, or come in another order, from
    the row's last sample's; a row restages whole only when its ring was
    replaced, and every row when the interning changed."""
    twins = TwinRings(window=4)
    names = [f"n{i}" for i in range(20)]
    metrics = ["a", "b", "c"]

    def staged(what):
        slots, lookups = twins.ring.slots, twins.ring.lookups
        twins.check(what)
        return twins.ring.slots - slots, twins.ring.lookups - lookups

    for step in range(6):
        order = names if step % 2 else names[::-1]  # the nodes in another order
        for metric in metrics:
            twins.write(metric, {n: step for n in order})
        assert staged(f"step {step}") == (len(metrics), len(metrics) * len(names))
    for step in range(4):
        for metric in metrics:
            twins.write(metric, {n: step for n in names[::-1]})
        assert staged(f"same order {step}") == (len(metrics), len(metrics) * len(names) * (step == 0))
    assert staged("nothing new") == (0, 0)
    twins.write("a", {n: 1 for n in names[::-1] + ["new"]})  # an interned node: every row restages
    assert staged("interned") == (3 * 4, 3 * len(names) + len(names) + 1)
    twins.register("b")
    twins.delete("b")  # its ring and its row go
    assert staged("deleted") == (0, 0)
    twins.register("b")
    twins.write("b", {n: 2 for n in names})  # registered again: its row alone restages
    twins.write("c", {n: 3 for n in names[::-1]})
    assert staged("registered again") == (2, len(names))


def test_forecaster_stages_a_sample_a_metric_a_pass():
    """The CPU forecaster refits through its ring: each refit stages one
    slot a metric, and looks nodes up only on the first pass (the later
    samples list the same nodes in the same order)."""
    clock = FakeClock()
    cache = AutoUpdatingCache(clock=clock.now)
    mirror = TensorStateMirror(device="cpu")
    mirror.attach(cache)
    forecaster = Forecaster(cache, mirror, window=4, period_s=1.0, clock=clock, counters=CounterSet())
    names = [f"n{i}" for i in range(10)]
    for step in range(7):
        clock.advance(1.0)
        for metric in ("x", "y"):
            cache.write_metric(metric, {n: NodeMetric(value=Quantity(str(step + i))) for i, n in enumerate(names)})
        slots, lookups = forecaster._ring.slots, forecaster._ring.lookups
        forecaster.refresh()
        assert forecaster._ring.slots - slots == 2
        assert forecaster._ring.lookups - lookups == (2 * len(names) if step == 0 else 0)
        fit = forecaster.ensure_current()
        staged = build_history_tensor(mirror.device_view(), cache.history_snapshot()[1], 4)
        want = ops_forecast.forecast_reference(torch.from_numpy(staged.values), torch.from_numpy(staged.valid), 1)
        assert np.array_equal(fit.shift, staged.shift)
        for g, x in zip(fit.scaled, want):
            assert torch.equal(g, x)


def test_a_failed_stage_restages_every_row_next_time():
    """A stage that raises part way (here a sample value past int64, which
    the staging cannot hold) leaves the ring to be restaged whole."""
    twins = TwinRings(window=3)
    names = ["a", "b"]
    for v in range(3):
        twins.write("m", {n: v for n in names})
        twins.write("k", {n: -v for n in names})
        twins.check()
    view = twins.mirror.device_view()
    gen, history = twins.cache.history_snapshot()
    history = dict(history)
    history["m"] = history["m"] + [(99.0, {"a": 2**70})]
    with pytest.raises(OverflowError):
        twins.ring.stage(view, history, twins.window)
    slots = twins.ring.slots
    twins.check("after the failure")
    assert twins.ring.slots - slots == 2 * 3
