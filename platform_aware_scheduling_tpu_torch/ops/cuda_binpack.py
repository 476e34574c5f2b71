"""Wrapper of the hand-written CUDA first-fit bin-pack kernel.

The kernel (``csrc/binpack.cu``) replaces the device program of
``platform_aware_scheduling_tpu/ops/binpack.py`` (``binpack_kernel``); its
source note gives the design and the bound.  This wrapper checks its
inputs, allocates the outputs (and, for a request of many resources, the
scratch the kernel asks for), launches on PyTorch's current stream and
raises on a launch error.  Its plain counterpart is
``ops/binpack.binpack_reference``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from platform_aware_scheduling_tpu_torch.ops import _build
from platform_aware_scheduling_tpu_torch.ops.binpack import (
    BinpackNodeState,
    BinpackRequest,
    BinpackResult,
)

_lib = None
_limits = None

_DTYPES = {
    "used": torch.int64,
    "capacity": torch.int64,
    "cap_present": torch.bool,
    "card_valid": torch.bool,
    "card_real": torch.bool,
    "card_order": torch.int32,
    "need": torch.int64,
    "need_active": torch.bool,
    "num_gpus": torch.int32,
    "container_active": torch.bool,
}


class _Limits(NamedTuple):
    cards: int  # largest C
    containers: int  # largest T
    register_resources: int  # largest R that never needs a scratch


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared (every pointer and the stream as ``c_void_p``) and its limits
    read once."""
    global _lib, _limits
    if _lib is None:
        lib = _build.load("binpack")
        lib.binpack_launch.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.binpack_launch.restype = ctypes.c_int
        lib.binpack_scratch_elems.argtypes = [ctypes.c_int] * 3
        lib.binpack_scratch_elems.restype = ctypes.c_longlong
        for name in ("binpack_max_cards", "binpack_max_containers", "binpack_register_resources"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _limits = _Limits(
            lib.binpack_max_cards(), lib.binpack_max_containers(), lib.binpack_register_resources()
        )
        _lib = lib
    return _lib


def max_cards() -> int:
    """Largest C (card lanes a node) the kernel takes."""
    _library()
    return _limits.cards


def max_containers() -> int:
    """Largest T (containers a pod) the kernel takes."""
    _library()
    return _limits.containers


def _check(state: BinpackNodeState, request: BinpackRequest, max_gpus: int) -> None:
    tensors = {**state._asdict(), **request._asdict()}
    for label, tensor in tensors.items():
        if tensor.device.type != "cuda":
            raise ValueError(f"binpack_cuda: {label} is on {tensor.device}, not cuda")
        if not tensor.is_contiguous():
            raise ValueError(f"binpack_cuda: {label} is not contiguous")
        if tensor.dtype != _DTYPES[label]:
            raise TypeError(f"binpack_cuda: {label} must be {_DTYPES[label]}, got {tensor.dtype}")
    if len({tensor.device for tensor in tensors.values()}) != 1:
        raise ValueError("binpack_cuda: inputs on different cards")
    if state.used.dim() != 3:
        raise ValueError(f"binpack_cuda: want used [N, C, R], got {tuple(state.used.shape)}")
    n, c, r = state.used.shape
    t = request.need.shape[0] if request.need.dim() == 2 else -1
    want = {
        "capacity": (n, r),
        "cap_present": (n, r),
        "card_valid": (n, c),
        "card_real": (n, c),
        "card_order": (n, c),
        "need": (t, r),
        "need_active": (t, r),
        "num_gpus": (t,),
        "container_active": (t,),
    }
    for label, shape in want.items():
        if tuple(tensors[label].shape) != shape:
            raise ValueError(
                f"binpack_cuda: {label} has shape {tuple(tensors[label].shape)}, want {shape} "
                f"for used {tuple(state.used.shape)} and need {tuple(request.need.shape)}"
            )
    if max_gpus < 0:
        raise ValueError(f"binpack_cuda: max_gpus {max_gpus} is negative")
    if n >= 2**31 or r >= 2**31 or max_gpus >= 2**31:
        raise ValueError("binpack_cuda: a dimension exceeds int32")
    _library()
    if c == 0 or c > _limits.cards:
        raise ValueError(f"binpack_cuda: C={c} card lanes, the kernel takes 1 to {_limits.cards}")
    if t > _limits.containers:
        raise ValueError(f"binpack_cuda: T={t} containers, the kernel takes at most {_limits.containers}")


def binpack_cuda(state: BinpackNodeState, request: BinpackRequest, max_gpus: int) -> BinpackResult:
    """Fit ``request`` against every node by the CUDA kernel.  Counts each
    launch in ``binpack_cuda.LAUNCHES``."""
    _check(state, request, max_gpus)
    n, c, r = state.used.shape
    t = request.need.shape[0]
    device = state.used.device
    fits = torch.empty(n, dtype=torch.bool, device=device)
    cards = torch.empty((n, t, max_gpus), dtype=torch.int32, device=device)
    if n == 0:
        return BinpackResult(fits=fits, cards=cards)
    scratch = None
    if r > _limits.register_resources:
        elems = _lib.binpack_scratch_elems(n, c, r)
        if elems:
            scratch = torch.empty(elems, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib.binpack_launch(
            *(tensor.data_ptr() for tensor in (*state, *request)),
            fits.data_ptr(),
            cards.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n,
            c,
            r,
            t,
            max_gpus,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"binpack kernel launch failed: cudaError {err}")
    binpack_cuda.LAUNCHES += 1
    return BinpackResult(fits=fits, cards=cards)


binpack_cuda.LAUNCHES = 0
