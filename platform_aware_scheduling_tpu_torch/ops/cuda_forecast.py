"""Wrapper of the hand-written CUDA Holt forecast kernel.

The kernel (``csrc/forecast.cu``) replaces the device program of
``platform_aware_scheduling_tpu/ops/forecast.py`` (``_forecast_kernel``);
its source note gives the design and the bound.  It reads the
forecaster's history ring (``ops/state.HistoryRing``) in place.
:func:`forecast_ring_cuda` checks its inputs, launches on PyTorch's
current stream, raises on a launch error and returns the six outputs as
the planes of one ``[6, M, N]`` tensor, in ``ForecastResult``'s field
order, so a caller reads them back in one copy.  :func:`forecast_cuda`
takes the JAX package's ``[M, N, W]`` int32 staging through the same
kernel.  The plain counterparts are ``ops/forecast.forecast_ring_reference``
and ``forecast_reference``.
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
        lib.forecast_ring_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.forecast_ring_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(label: str, tensor: torch.Tensor, dtypes, device=None) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"forecast_cuda: {label} is on {tensor.device}, not cuda")
    if device is not None and tensor.device != device:
        raise ValueError("forecast_cuda: inputs on different cards")
    if not tensor.is_contiguous():
        raise ValueError(f"forecast_cuda: {label} is not contiguous")
    if tensor.dtype not in dtypes:
        raise TypeError(f"forecast_cuda: {label} must be {' or '.join(map(str, dtypes))}, got {tensor.dtype}")


def forecast_ring_cuda(
    values: torch.Tensor, valid: torch.Tensor, head: torch.Tensor, shift: torch.Tensor, n_live: int, horizon: int
) -> torch.Tensor:
    """Fit every series of a history ring at ``horizon`` steps by the CUDA
    kernel: raw milli ``values`` int64 and ``valid`` (uint8 or bool)
    ``[M, W, N]``, ``head`` and ``shift`` int32 ``[M]`` (each in ``[0,
    W)`` and ``[0, 64)``, as ``HistoryRing`` keeps them), columns from
    ``n_live`` on never valid; the int32 ``[6, M, N]`` result on the card.
    Counts each launch in ``forecast_ring_cuda.LAUNCHES``."""
    _check("values", values, (torch.int64,))
    device = values.device
    _check("valid", valid, (torch.uint8, torch.bool), device)
    _check("head", head, (torch.int32,), device)
    _check("shift", shift, (torch.int32,), device)
    if values.dim() != 3 or tuple(valid.shape) != tuple(values.shape):
        raise ValueError(
            f"forecast_cuda: want values and valid [M, W, N], got {tuple(values.shape)} and {tuple(valid.shape)}"
        )
    m, w, n = values.shape
    if tuple(head.shape) != (m,) or tuple(shift.shape) != (m,):
        raise ValueError(f"forecast_cuda: want head and shift [{m}], got {tuple(head.shape)} and {tuple(shift.shape)}")
    if max(m, w, n) >= 2**31:
        raise ValueError("forecast_cuda: a dimension exceeds int32")
    if not 0 <= n_live <= n:
        raise ValueError(f"forecast_cuda: n_live {n_live} outside [0, {n}]")
    out = torch.empty((6, m, n), dtype=torch.int32, device=device)
    if m * n:
        lib = _library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.forecast_ring_launch(
                values.data_ptr(),
                valid.data_ptr(),
                head.data_ptr(),
                shift.data_ptr(),
                out.data_ptr(),
                m,
                w,
                n,
                int(n_live),
                _wrap_int(horizon),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"forecast kernel launch failed: cudaError {err}")
        forecast_ring_cuda.LAUNCHES += 1
    return out


forecast_ring_cuda.LAUNCHES = 0


def forecast_cuda(values: torch.Tensor, valid: torch.Tensor, horizon: int) -> torch.Tensor:
    """Fit every series of the int32 ``values`` / bool ``valid`` ``[M, N,
    W]`` staging at ``horizon`` steps: widened to int64 and permuted to
    ``[M, W, N]`` on the card, then :func:`forecast_ring_cuda` with head 0
    and shift 0 (its launch counts there).  The int32 ``[6, M, N]`` result
    on the card."""
    _check("values", values, (torch.int32,))
    _check("valid", valid, (torch.bool,), values.device)
    if values.dim() != 3 or tuple(valid.shape) != tuple(values.shape):
        raise ValueError(
            f"forecast_cuda: want values and valid [M, N, W], got {tuple(values.shape)} and {tuple(valid.shape)}"
        )
    m, n, _w = values.shape
    ring_values = values.permute(0, 2, 1).to(torch.int64).contiguous()
    ring_valid = valid.permute(0, 2, 1).contiguous()
    zeros = torch.zeros(m, dtype=torch.int32, device=values.device)
    return forecast_ring_cuda(ring_values, ring_valid, zeros, zeros, n, horizon)
