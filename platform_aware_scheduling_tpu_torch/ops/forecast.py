"""Batched telemetry forecasting: EWMA level + Holt linear trend for every
(metric, node) series in one pass.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/forecast.py``.
The fit turns the refresh history (``tas/cache.py`` rings, staged dense by
``ops/state.build_history_tensor``) into per-series estimates:

  * **level**: exponentially weighted estimate of where the series is;
  * **trend**: Holt's linear-trend term, milli-units per refresh step;
  * **resid**: mean absolute one-step-ahead residual, the noise scale;
  * **predicted**: ``level + trend * h`` at a horizon of ``h`` steps;
  * **band**: ``resid * (1 + h)``, an uncertainty band that widens with
    the extrapolation distance (degraded mode serves forecasts only while
    it stays inside its bound, ``tas/degraded.py``);
  * **samples**: the valid samples folded in.

All arithmetic is int32 in the staged (per-row de-scaled) milli domain,
with dyadic weights (alpha = 2^-ALPHA_SHIFT, beta = 2^-BETA_SHIFT), so an
update is adds and arithmetic shifts and every path gives the same bits:
XLA and numpy in the JAX package, :func:`forecast_reference` and the CUDA
kernel (``csrc/forecast.cu``) here.  Sums wrap in int32 as XLA's do (the
JAX package's parity test draws values in +-2^30, so wrap-around is normal
input), ``>>`` is arithmetic, ``abs(INT32_MIN)`` stays ``INT32_MIN`` and
the residual mean is a floor division.

:func:`forecast_fit` runs on the inputs' device (the plain version for CPU
tensors, the kernel for CUDA tensors) and returns CPU tensors; it raises
when the kernel cannot run.  :func:`forecast_ring_fit` does the same for
the forecaster's history ring (``ops/state.HistoryRing``), which the
kernel reads in place.  Unlike the JAX package's ``forecast_fit``,
neither swallows a device failure into the host mirror: the forecaster's
``refresh`` logs the failure and keeps the last published fit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: dyadic smoothing weights: alpha = 1/2 (level), beta = 1/4 (trend)
ALPHA_SHIFT = 1
BETA_SHIFT = 2

_INT32_SPAN = 1 << 32
_INT32_MIN = -(1 << 31)


class ForecastResult(NamedTuple):
    """Per-(metric, node) fit in the SCALED int32 domain (values were
    arithmetic-right-shifted per metric row at staging; callers shift
    outputs back up, ``ops/state.HistoryTensor.shift``).  Six int32
    ``[M, N]`` tensors on one device, the same bits from either path."""

    level: torch.Tensor  # smoothed current value
    trend: torch.Tensor  # slope per refresh step
    resid: torch.Tensor  # mean |one-step-ahead error|
    predicted: torch.Tensor  # level + trend * horizon
    band: torch.Tensor  # resid * (1 + horizon)
    samples: torch.Tensor  # valid samples folded in


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32's two's-complement range (still
    int64): the int32 wrap of a sum or product, with no overflow in the
    int64 arithmetic that formed it."""
    return ((x - _INT32_MIN) & (_INT32_SPAN - 1)) + _INT32_MIN


def _wrap_int(value: int) -> int:
    return ((int(value) - _INT32_MIN) % _INT32_SPAN) + _INT32_MIN


def _tail(level: torch.Tensor, trend: torch.Tensor, resid: torch.Tensor, horizon: int):
    """(predicted, band) at ``horizon`` in int32 arithmetic, as int64
    tensors holding int32 values."""
    h = _wrap_int(horizon)
    predicted = _wrap(level + _wrap(trend * h))
    band = _wrap(resid * _wrap_int(1 + h))
    return predicted, band


def forecast_reference(values: torch.Tensor, valid: torch.Tensor, horizon: int) -> ForecastResult:
    """The plain PyTorch version of the fit (the JAX package's
    ``_forecast_kernel`` and ``forecast_host``): a loop over the W samples
    that updates every series at once, on the inputs' device.  The state
    is held in int64 and wrapped to int32 after each sum, so it gives
    int32's bits without relying on signed overflow.

    Per valid sample past the first::

        err  = x - (L + b)            # one-step-ahead surprise
        adj  = err >> ALPHA_SHIFT     # alpha * err
        L'   = L + b + adj            # Holt level update
        b'   = b + (adj >> BETA_SHIFT)

    The first valid sample seeds L = x, b = 0; an invalid slot carries the
    state through untouched."""
    if values.dim() != 3 or tuple(valid.shape) != tuple(values.shape):
        raise ValueError(
            f"forecast: want values and valid [M, N, W], got {tuple(values.shape)} and {tuple(valid.shape)}"
        )
    x_all = values.to(torch.int64)
    ok_all = valid.to(torch.bool)
    m, n, w = values.shape
    zero = torch.zeros((m, n), dtype=torch.int64, device=values.device)
    level, trend, count, acc = zero, zero, zero, zero
    for t in range(w):
        x = x_all[:, :, t]
        v = ok_all[:, :, t]
        first = v & (count == 0)
        later = v & (count > 0)
        pred1 = _wrap(level + trend)
        err = _wrap(x - pred1)
        adj = err >> ALPHA_SHIFT
        level = torch.where(first, x, torch.where(later, _wrap(pred1 + adj), level))
        trend = torch.where(later, _wrap(trend + (adj >> BETA_SHIFT)), torch.where(first, zero, trend))
        acc = torch.where(later, _wrap(acc + _wrap(err.abs())), acc)
        count = torch.where(v, count + 1, count)
    # the mean |residual| over the count-1 one-step-ahead errors: a floor
    # division, as XLA's and numpy's ``//`` (acc may have wrapped negative)
    resid = torch.div(acc, torch.clamp(count - 1, min=1), rounding_mode="floor")
    predicted, band = _tail(level, trend, resid, horizon)
    return ForecastResult(
        *(part.to(torch.int32) for part in (level, trend, resid, predicted, band, count))
    )


def forecast_fit(values: torch.Tensor, valid: torch.Tensor, horizon: int) -> ForecastResult:
    """The fit on the inputs' device, returned as CPU tensors:
    :func:`forecast_reference` for CPU tensors, the CUDA kernel
    (``ops/cuda_forecast.forecast_cuda``) for CUDA tensors, its six
    outputs read back in one copy.  A kernel that cannot build or launch
    raises here: a CUDA caller never gets the plain version's result."""
    if values.device != valid.device:
        raise ValueError(f"forecast inputs on different devices: {values.device}, {valid.device}")
    if values.device.type == "cpu":
        return forecast_reference(values, valid, horizon)
    if values.device.type == "cuda":
        from platform_aware_scheduling_tpu_torch.ops.cuda_forecast import forecast_cuda

        return ForecastResult(*forecast_cuda(values, valid, horizon).cpu().unbind(0))
    raise ValueError(f"forecast has no path for device {values.device}")


def forecast_ring_reference(
    values: torch.Tensor, valid: torch.Tensor, head: torch.Tensor, shift: torch.Tensor, n_live: int, horizon: int
) -> ForecastResult:
    """The plain PyTorch version of the ring kernel, on the inputs' device:
    the fit of a history ring (``ops/state.HistoryRing``: raw milli
    ``values`` int64 and ``valid`` ``[M, W, N]``, each row's oldest slot
    ``head[m]`` and de-scale ``shift[m]``).  It gathers each row's slots
    oldest first, shifts each value right by its row's ``shift`` and keeps
    the low 32 bits (numpy's ``astype(np.int32)`` after the staging's
    shift), drops the columns from ``n_live`` on, and runs
    :func:`forecast_reference` on the ``[M, N, W]`` result."""
    if values.dim() != 3 or tuple(valid.shape) != tuple(values.shape):
        raise ValueError(
            f"forecast ring: want values and valid [M, W, N], got {tuple(values.shape)} and {tuple(valid.shape)}"
        )
    m, w, n = values.shape
    order = (head.to(torch.int64)[:, None] + torch.arange(w, device=values.device)) % w
    index = order[:, :, None].expand(m, w, n)
    x = torch.gather(values.to(torch.int64), 1, index) >> shift.to(torch.int64)[:, None, None]
    ok = torch.gather(valid.to(torch.bool), 1, index)
    ok[:, :, n_live:] = False
    return forecast_reference(_wrap(x).permute(0, 2, 1), ok.permute(0, 2, 1), horizon)


def forecast_ring_fit(
    values: torch.Tensor, valid: torch.Tensor, head: torch.Tensor, shift: torch.Tensor, n_live: int, horizon: int
) -> ForecastResult:
    """The fit of a history ring on its device, returned as CPU tensors:
    :func:`forecast_ring_reference` for CPU tensors, the CUDA kernel
    (``ops/cuda_forecast.forecast_ring_cuda``) for CUDA tensors, its six
    outputs read back in one copy.  A kernel that cannot build or launch
    raises here: a CUDA ring never gets the plain version's result."""
    if values.device.type == "cpu":
        return forecast_ring_reference(values, valid, head, shift, n_live, horizon)
    if values.device.type == "cuda":
        from platform_aware_scheduling_tpu_torch.ops.cuda_forecast import forecast_ring_cuda

        return ForecastResult(*forecast_ring_cuda(values, valid, head, shift, n_live, horizon).cpu().unbind(0))
    raise ValueError(f"forecast has no path for device {values.device}")


def extend_horizon(fit: ForecastResult, horizon: int) -> ForecastResult:
    """Re-extrapolate a stored fit to a new horizon WITHOUT refitting (the
    degraded-mode path: through an outage no samples arrive, the fit
    stands, and only (predicted, band) move as the horizon grows).  The
    same int32 tail as the fit's, so a fit extended to ``h`` equals a
    fresh fit at ``h``.  Plain tensor arithmetic on the fit's device."""
    predicted, band = _tail(
        fit.level.to(torch.int64), fit.trend.to(torch.int64), fit.resid.to(torch.int64), horizon
    )
    return fit._replace(predicted=predicted.to(torch.int32), band=band.to(torch.int32))
