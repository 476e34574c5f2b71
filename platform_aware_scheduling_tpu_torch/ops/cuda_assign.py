"""Wrapper of the hand-written CUDA greedy-assign kernel.

The kernel (``csrc/greedy_assign.cu``) replaces the TPU kernel
``platform_aware_scheduling_tpu/ops/pallas_assign.py:_kernel``; its source
note gives the design and the bound.  This wrapper checks its inputs,
allocates the outputs, launches on PyTorch's current stream and raises on
a launch error.  Its plain counterpart is
``ops/assign.greedy_assign_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from platform_aware_scheduling_tpu_torch.ops import _build
from platform_aware_scheduling_tpu_torch.ops.assign import AssignResult

_lib = None
_max_nodes = {}


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures
    declared (every pointer and the stream as ``c_void_p``)."""
    global _lib
    if _lib is None:
        lib = _build.load("greedy_assign")
        lib.greedy_assign_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.greedy_assign_launch.restype = ctypes.c_int
        lib.greedy_assign_max_nodes.argtypes = [ctypes.c_int]
        lib.greedy_assign_max_nodes.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_nodes(device: torch.device) -> int:
    """Largest N whose capacity vector fits one block's shared memory."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _max_nodes:
        limit = _library().greedy_assign_max_nodes(index)
        if limit < 0:
            raise RuntimeError("greedy_assign_max_nodes failed: CUDA error")
        _max_nodes[index] = limit
    return _max_nodes[index]


def greedy_assign_cuda(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool or uint8 [P, N]
    capacity: torch.Tensor,  # int32 [N]
) -> AssignResult:
    """Exact greedy-in-order assignment by the CUDA kernel.  Counts each
    launch in ``greedy_assign_cuda.LAUNCHES``."""
    for label, tensor in (("score", score), ("eligible", eligible), ("capacity", capacity)):
        if tensor.device.type != "cuda":
            raise ValueError(f"greedy_assign_cuda: {label} is on {tensor.device}, not cuda")
        if not tensor.is_contiguous():
            raise ValueError(f"greedy_assign_cuda: {label} is not contiguous")
    if score.dtype != torch.int64:
        raise TypeError(f"greedy_assign_cuda: score must be int64, got {score.dtype}")
    if eligible.dtype not in (torch.bool, torch.uint8):
        raise TypeError(
            f"greedy_assign_cuda: eligible must be bool or uint8, got {eligible.dtype}"
        )
    if capacity.dtype != torch.int32:
        raise TypeError(f"greedy_assign_cuda: capacity must be int32, got {capacity.dtype}")
    if score.dim() != 2 or eligible.shape != score.shape or capacity.dim() != 1:
        raise ValueError(
            "greedy_assign_cuda: want score [P, N], eligible [P, N], capacity [N]; "
            f"got {tuple(score.shape)}, {tuple(eligible.shape)}, {tuple(capacity.shape)}"
        )
    p, n = score.shape
    if capacity.shape[0] != n:
        raise ValueError(f"greedy_assign_cuda: capacity has {capacity.shape[0]} nodes, score {n}")
    if len({score.device, eligible.device, capacity.device}) != 1:
        raise ValueError("greedy_assign_cuda: inputs on different cards")
    device = score.device
    node_for_pod = torch.empty(p, dtype=torch.int32, device=device)
    capacity_left = torch.empty(n, dtype=torch.int32, device=device)
    if p == 0 or n == 0:
        node_for_pod.fill_(-1)
        capacity_left.copy_(capacity)
        return AssignResult(node_for_pod=node_for_pod, capacity_left=capacity_left)
    if p >= 2**31:
        raise ValueError(f"greedy_assign_cuda: P={p} pods exceed int32")
    limit = max_nodes(device)
    if n > limit:
        raise ValueError(
            f"greedy_assign_cuda: N={n} nodes exceed the {limit} that fit one "
            "block's shared memory on this card"
        )
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.greedy_assign_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            node_for_pod.data_ptr(),
            capacity_left.data_ptr(),
            p,
            n,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"greedy_assign kernel launch failed: cudaError {err}")
    greedy_assign_cuda.LAUNCHES += 1
    return AssignResult(node_for_pod=node_for_pod, capacity_left=capacity_left)


greedy_assign_cuda.LAUNCHES = 0
