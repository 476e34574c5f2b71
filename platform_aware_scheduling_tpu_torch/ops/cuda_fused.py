"""Wrapper of the hand-written CUDA kernel of the fused solve's scan.

The kernel (``csrc/fused_schedule.cu``) replaces the ``lax.scan`` over pods
of ``platform_aware_scheduling_tpu/models/fused.py`` (``fused_schedule``);
its source note gives the design and the bound.  This wrapper checks its
inputs (device, dtype, contiguity, shapes, the kernel's limits and that
every pod's class is in ``[0, T)``), allocates the outputs and the
partials buffer of the grid's reduction, makes one cooperative launch on
PyTorch's current stream and raises on a launch error.  Its plain
counterpart is ``models/fused.fused_scan_reference``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from platform_aware_scheduling_tpu_torch.ops import _build
from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState

_lib = None
_limits = None


class _Limits(NamedTuple):
    cards: int  # largest C
    containers: int  # largest Tc
    row: int  # largest C x R


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared (every pointer and the stream as ``c_void_p``)."""
    global _lib, _limits
    if _lib is None:
        lib = _build.load("fused_schedule")
        lib.fused_schedule_launch.argtypes = (
            [ctypes.c_void_p] * 21 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        lib.fused_schedule_launch.restype = ctypes.c_int
        lib.fused_schedule_blocks.argtypes = [ctypes.c_int]
        lib.fused_schedule_blocks.restype = ctypes.c_int
        for name in ("fused_schedule_max_cards", "fused_schedule_max_containers", "fused_schedule_max_row"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _limits = _Limits(
            lib.fused_schedule_max_cards(), lib.fused_schedule_max_containers(), lib.fused_schedule_max_row()
        )
        _lib = lib
    return _lib


def _check(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus) -> None:
    tensors = {
        "score": (score, torch.int64),
        "eligible": (eligible, torch.bool),
        "capacity": (capacity, torch.int32),
        "req_class": (req_class, torch.int32),
        "fits0": (fits0, torch.bool),
        "used": (gas.used, torch.int64),
        "gas capacity": (gas.capacity, torch.int64),
        "cap_present": (gas.cap_present, torch.bool),
        "card_valid": (gas.card_valid, torch.bool),
        "card_real": (gas.card_real, torch.bool),
        "card_order": (gas.card_order, torch.int32),
        "need": (requests.need, torch.int64),
        "need_active": (requests.need_active, torch.bool),
        "num_gpus": (requests.num_gpus, torch.int32),
        "container_active": (requests.container_active, torch.bool),
    }
    for label, (tensor, dtype) in tensors.items():
        if tensor.device.type != "cuda":
            raise ValueError(f"fused_schedule_cuda: {label} is on {tensor.device}, not cuda")
        if not tensor.is_contiguous():
            raise ValueError(f"fused_schedule_cuda: {label} is not contiguous")
        if tensor.dtype != dtype:
            raise TypeError(f"fused_schedule_cuda: {label} must be {dtype}, got {tensor.dtype}")
    if len({tensor.device for tensor, _dtype in tensors.values()}) != 1:
        raise ValueError("fused_schedule_cuda: inputs on different cards")
    if score.dim() != 2 or gas.used.dim() != 3 or requests.need.dim() != 3:
        raise ValueError(
            "fused_schedule_cuda: want score [P, N], used [N, C, R] and need [T, Tc, R]; got "
            f"{tuple(score.shape)}, {tuple(gas.used.shape)}, {tuple(requests.need.shape)}"
        )
    p, n = score.shape
    _n, c, r = gas.used.shape
    t, tc, _r = requests.need.shape
    want = {
        "eligible": (eligible, (p, n)),
        "capacity": (capacity, (n,)),
        "req_class": (req_class, (p,)),
        "fits0": (fits0, (t, n)),
        "used": (gas.used, (n, c, r)),
        "gas capacity": (gas.capacity, (n, r)),
        "cap_present": (gas.cap_present, (n, r)),
        "card_valid": (gas.card_valid, (n, c)),
        "card_real": (gas.card_real, (n, c)),
        "card_order": (gas.card_order, (n, c)),
        "need": (requests.need, (t, tc, r)),
        "need_active": (requests.need_active, (t, tc, r)),
        "num_gpus": (requests.num_gpus, (t, tc)),
        "container_active": (requests.container_active, (t, tc)),
    }
    for label, (tensor, shape) in want.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(
                f"fused_schedule_cuda: {label} has shape {tuple(tensor.shape)}, want {shape} for "
                f"score {tuple(score.shape)}, used {tuple(gas.used.shape)} and need {tuple(requests.need.shape)}"
            )
    if max_gpus < 0:
        raise ValueError(f"fused_schedule_cuda: max_gpus {max_gpus} is negative")
    if n >= 2**31 or t >= 2**31 or max_gpus >= 2**31:
        raise ValueError("fused_schedule_cuda: a dimension exceeds int32")
    _library()
    if c == 0 or c > _limits.cards:
        raise ValueError(f"fused_schedule_cuda: C={c} card lanes, the kernel takes 1 to {_limits.cards}")
    if tc > _limits.containers:
        raise ValueError(f"fused_schedule_cuda: Tc={tc} containers, the kernel takes at most {_limits.containers}")
    if c * r > _limits.row:
        raise ValueError(f"fused_schedule_cuda: C x R = {c * r} amounts a node, the kernel takes at most {_limits.row}")
    if p:
        low, high = (int(x) for x in torch.aminmax(req_class))
        if low < 0 or high >= t:
            raise ValueError(f"fused_schedule_cuda: request classes span [{low}, {high}], outside [0, {t})")


def fused_schedule_cuda(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
    req_class: torch.Tensor,  # int32 [P]
    fits0: torch.Tensor,  # bool [T, N]
    gas: BinpackNodeState,
    requests,  # models/fused.FusedRequests
    max_gpus: int,
):
    """The scan by the CUDA kernel: a ``models/fused.FusedScan``.  Counts
    each launch in ``fused_schedule_cuda.LAUNCHES``."""
    from platform_aware_scheduling_tpu_torch.models.fused import FusedScan

    _check(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)
    p, n = score.shape
    if p == 0 or n == 0:
        node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=score.device)
        return FusedScan(node_for_pod, capacity.clone(), gas.used.clone(), fits0.clone())
    return FusedScan(*launch(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus))


def launch(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus):
    """One launch on inputs :func:`fused_schedule_cuda` has checked, P and
    N > 0: (node_for_pod, capacity_left, used, fits).  Counted in
    ``fused_schedule_cuda.LAUNCHES``; it syncs nowhere, so the timing in
    ``chip_smoke.py`` can capture it in a CUDA graph."""
    p, n = score.shape
    _n, c, r = gas.used.shape
    t, tc, _r = requests.need.shape
    device = score.device
    lib = _library()
    with torch.cuda.device(device):
        blocks = lib.fused_schedule_blocks(n)
        if blocks <= 0:
            raise RuntimeError("fused_schedule_blocks failed: CUDA error")
        node_for_pod = torch.empty(p, dtype=torch.int32, device=device)
        capacity_left = torch.empty(n, dtype=torch.int32, device=device)
        used = torch.empty_like(gas.used)
        fits = torch.empty_like(fits0)
        partial_score = torch.empty(2 * blocks, dtype=torch.int64, device=device)
        partial_node = torch.empty(2 * blocks, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_schedule_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            req_class.data_ptr(),
            fits0.data_ptr(),
            *(tensor.data_ptr() for tensor in gas),
            *(tensor.data_ptr() for tensor in requests),
            node_for_pod.data_ptr(),
            capacity_left.data_ptr(),
            used.data_ptr(),
            fits.data_ptr(),
            partial_score.data_ptr(),
            partial_node.data_ptr(),
            p,
            n,
            c,
            r,
            t,
            tc,
            max_gpus,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_schedule kernel launch failed: cudaError {err}")
    fused_schedule_cuda.LAUNCHES += 1
    return node_for_pod, capacity_left, used, fits


fused_schedule_cuda.LAUNCHES = 0
