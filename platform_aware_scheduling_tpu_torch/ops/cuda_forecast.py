"""Wrapper of the hand-written CUDA Holt forecast kernel.

The kernel (``csrc/forecast.cu``) replaces the device program of
``platform_aware_scheduling_tpu/ops/forecast.py`` (``_forecast_kernel``);
its source note gives the design and the bound.  This wrapper checks its
inputs, launches on PyTorch's current stream, raises on a launch error
and returns the six outputs as the planes of one ``[6, M, N]`` tensor, in
``ForecastResult``'s field order, so a caller reads them back in one
copy.  Its plain counterpart is ``ops/forecast.forecast_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from platform_aware_scheduling_tpu_torch.ops import _build
from platform_aware_scheduling_tpu_torch.ops.forecast import _wrap_int

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature
    declared (every pointer and the stream as ``c_void_p``)."""
    global _lib
    if _lib is None:
        lib = _build.load("forecast")
        lib.forecast_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.forecast_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(values: torch.Tensor, valid: torch.Tensor) -> None:
    for label, tensor, dtype in (("values", values, torch.int32), ("valid", valid, torch.bool)):
        if tensor.device.type != "cuda":
            raise ValueError(f"forecast_cuda: {label} is on {tensor.device}, not cuda")
        if not tensor.is_contiguous():
            raise ValueError(f"forecast_cuda: {label} is not contiguous")
        if tensor.dtype != dtype:
            raise TypeError(f"forecast_cuda: {label} must be {dtype}, got {tensor.dtype}")
    if values.device != valid.device:
        raise ValueError("forecast_cuda: inputs on different cards")
    if values.dim() != 3 or tuple(valid.shape) != tuple(values.shape):
        raise ValueError(
            f"forecast_cuda: want values and valid [M, N, W], got {tuple(values.shape)} and {tuple(valid.shape)}"
        )
    if values.shape[2] >= 2**31:
        raise ValueError("forecast_cuda: W exceeds int32")


def forecast_cuda(values: torch.Tensor, valid: torch.Tensor, horizon: int) -> torch.Tensor:
    """Fit every series of the int32 ``values`` / bool ``valid`` ``[M, N,
    W]`` staging at ``horizon`` steps by the CUDA kernel; the int32 ``[6,
    M, N]`` result on the card.  Counts each launch in
    ``forecast_cuda.LAUNCHES``."""
    _check(values, valid)
    m, n, w = values.shape
    out = torch.empty((6, m, n), dtype=torch.int32, device=values.device)
    series = m * n
    if series:
        lib = _library()
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            err = lib.forecast_launch(
                values.data_ptr(), valid.data_ptr(), out.data_ptr(), series, w, _wrap_int(horizon), stream
            )
        if err != 0:
            raise RuntimeError(f"forecast kernel launch failed: cudaError {err}")
        forecast_cuda.LAUNCHES += 1
    return out


forecast_cuda.LAUNCHES = 0
