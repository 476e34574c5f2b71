"""Wrapper of the hand-written CUDA greedy-assign kernel.

The kernel (``csrc/greedy_assign.cu``) replaces the TPU kernel
``platform_aware_scheduling_tpu/ops/pallas_assign.py:_kernel``; its source
note gives the design and the bound.  This wrapper checks its inputs,
allocates the outputs and the stage-1 scratch (candidate lists [P, K] and
counts [P]), launches the two stages on PyTorch's current stream and
raises on the first launch error.  Its plain counterpart is
``ops/assign.greedy_assign_reference``; ``greedy_assign_staged_reference``
there models the two stages.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
        lib.greedy_assign_candidates_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.greedy_assign_candidates_launch.restype = ctypes.c_int
        lib.greedy_assign_resolve_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.greedy_assign_resolve_launch.restype = ctypes.c_int
        lib.greedy_assign_max_nodes.argtypes = [ctypes.c_int]
        lib.greedy_assign_max_nodes.restype = ctypes.c_int
        lib.greedy_assign_list_size.argtypes = []
        lib.greedy_assign_list_size.restype = ctypes.c_int
        _lib = lib
    return _lib


def list_size() -> int:
    """K, the length of each pod's candidate list in the kernel."""
    return _library().greedy_assign_list_size()


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
    call, which launches both stages, in ``greedy_assign_cuda.LAUNCHES``."""
    return greedy_assign_cuda_with_rescans(score, eligible, capacity)[0]


def greedy_assign_cuda_with_rescans(
    score: torch.Tensor, eligible: torch.Tensor, capacity: torch.Tensor
) -> Tuple[AssignResult, torch.Tensor]:
    """:func:`greedy_assign_cuda`, also returning the number of pods the
    resolve stage rescanned (int32 [1] on the card)."""
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
    if p == 0 or n == 0:
        node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=device)
        capacity_left = capacity.clone()
        rescans = torch.zeros(1, dtype=torch.int32, device=device)
        return AssignResult(node_for_pod=node_for_pod, capacity_left=capacity_left), rescans
    if p >= 2**31:
        raise ValueError(f"greedy_assign_cuda: P={p} pods exceed int32")
    limit = max_nodes(device)
    if n > limit:
        raise ValueError(
            f"greedy_assign_cuda: N={n} nodes exceed the {limit} that fit one "
            "block's shared memory on this card"
        )
    lists, counts = launch_candidates(score, eligible, capacity)
    result = launch_resolve(score, eligible, capacity, lists, counts)
    greedy_assign_cuda.LAUNCHES += 1
    return result


def _raise_on(err: int, stage: str) -> None:
    if err != 0:
        raise RuntimeError(f"greedy_assign {stage} kernel launch failed: cudaError {err}")


def launch_candidates(
    score: torch.Tensor, eligible: torch.Tensor, capacity: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 alone, on inputs :func:`greedy_assign_cuda` has checked:
    each pod's best starting-ok lanes in rank order (int32 [P, K], the
    first min(K, count) valid) and its count of starting-ok lanes (int32
    [P]).  Not counted in ``LAUNCHES``; the timing in ``chip_smoke.py``
    calls it on its own."""
    p, n = score.shape
    device = score.device
    lists = torch.empty((p, list_size()), dtype=torch.int32, device=device)
    counts = torch.empty(p, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().greedy_assign_candidates_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            lists.data_ptr(),
            counts.data_ptr(),
            p,
            n,
            stream,
        )
    _raise_on(err, "candidate")
    return lists, counts


def launch_resolve(
    score: torch.Tensor,
    eligible: torch.Tensor,
    capacity: torch.Tensor,
    lists: torch.Tensor,
    counts: torch.Tensor,
) -> Tuple[AssignResult, torch.Tensor]:
    """Stage 2 alone, on checked inputs and stage 1's output: the result
    and the number of rescanned pods (int32 [1]).  Not counted in
    ``LAUNCHES``."""
    p, n = score.shape
    device = score.device
    node_for_pod = torch.empty(p, dtype=torch.int32, device=device)
    capacity_left = torch.empty(n, dtype=torch.int32, device=device)
    rescans = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().greedy_assign_resolve_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            lists.data_ptr(),
            counts.data_ptr(),
            node_for_pod.data_ptr(),
            capacity_left.data_ptr(),
            rescans.data_ptr(),
            p,
            n,
            stream,
        )
    _raise_on(err, "resolve")
    return AssignResult(node_for_pod=node_for_pod, capacity_left=capacity_left), rescans


greedy_assign_cuda.LAUNCHES = 0
