"""Wrapper of the hand-written CUDA kernel of the fused solve's scan.

The kernel (``csrc/fused_schedule.cu``) replaces the ``lax.scan`` over pods
of ``platform_aware_scheduling_tpu/models/fused.py`` (``fused_schedule``);
its source note gives the design, the exactness argument and the bound.
This wrapper checks its inputs (device, dtype, contiguity, shapes, the
kernel's limits, the resolve block's shared memory and that every pod's
class is in ``[0, T)``), allocates the outputs and the scratch, makes the
two launches (the candidate pass, then the resolve) on PyTorch's current
stream and raises on a launch error.  Its plain counterpart is
``models/fused.fused_scan_reference``; ``models/fused.fused_scan_staged_reference``
is the plain model of the two launches, rescans and revivals included.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from platform_aware_scheduling_tpu_torch.ops import _build
from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState

# The kernel's list length and revived-list room (its L and REVIVED); the
# library's values are checked against these when it loads.
LIST_SIZE = 128
REVIVED_SIZE = 256

_lib = None
_limits = None
_max_shared = {}


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
        lib.fused_schedule_candidates_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fused_schedule_candidates_launch.restype = ctypes.c_int
        lib.fused_schedule_resolve_launch.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.fused_schedule_resolve_launch.restype = ctypes.c_int
        lib.fused_schedule_shared_bytes.argtypes = [ctypes.c_int] * 5
        lib.fused_schedule_shared_bytes.restype = ctypes.c_longlong
        lib.fused_schedule_max_shared.argtypes = [ctypes.c_int]
        lib.fused_schedule_max_shared.restype = ctypes.c_int
        lib.fused_schedule_max_nodes.argtypes = [ctypes.c_int] * 5
        lib.fused_schedule_max_nodes.restype = ctypes.c_int
        for name in (
            "fused_schedule_list_size",
            "fused_schedule_revived_size",
            "fused_schedule_max_cards",
            "fused_schedule_max_containers",
            "fused_schedule_max_row",
        ):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        sizes = (lib.fused_schedule_list_size(), lib.fused_schedule_revived_size())
        if sizes != (LIST_SIZE, REVIVED_SIZE):
            raise RuntimeError(f"fused_schedule kernel has list sizes {sizes}, the wrapper {(LIST_SIZE, REVIVED_SIZE)}")
        _limits = _Limits(
            lib.fused_schedule_max_cards(), lib.fused_schedule_max_containers(), lib.fused_schedule_max_row()
        )
        _lib = lib
    return _lib


def max_shared(device: torch.device) -> int:
    """Bytes of dynamic shared memory the resolve block may use on ``device``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _max_shared:
        avail = _library().fused_schedule_max_shared(index)
        if avail < 0:
            raise RuntimeError("fused_schedule_max_shared failed: CUDA error")
        _max_shared[index] = avail
    return _max_shared[index]


def shared_bytes(n: int, c: int, r: int, t: int, tc: int) -> int:
    """Bytes of dynamic shared memory the resolve block needs at this shape:
    N x (T + 4) for the capacity and fits, plus what does not grow with N."""
    return _library().fused_schedule_shared_bytes(n, c, r, t, tc)


def max_nodes(device: torch.device, c: int, r: int, t: int, tc: int) -> int:
    """The largest N the resolve block takes on ``device`` at C, R, T, Tc."""
    index = torch.device(device).index
    limit = _library().fused_schedule_max_nodes(torch.cuda.current_device() if index is None else index, c, r, t, tc)
    if limit < 0:
        raise RuntimeError("fused_schedule_max_nodes failed: CUDA error")
    return limit


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
    if p >= 2**31 or n >= 2**31 or t >= 2**31 or max_gpus >= 2**31:
        raise ValueError("fused_schedule_cuda: a dimension exceeds int32")
    _library()
    if c == 0 or c > _limits.cards:
        raise ValueError(f"fused_schedule_cuda: C={c} card lanes, the kernel takes 1 to {_limits.cards}")
    if tc > _limits.containers:
        raise ValueError(f"fused_schedule_cuda: Tc={tc} containers, the kernel takes at most {_limits.containers}")
    if c * r > _limits.row:
        raise ValueError(f"fused_schedule_cuda: C x R = {c * r} amounts a node, the kernel takes at most {_limits.row}")
    if n and t:
        need, avail = shared_bytes(n, c, r, t, tc), max_shared(score.device)
        if need > avail:
            raise ValueError(
                f"fused_schedule_cuda: N={n} nodes need {need} bytes of the resolve block's shared memory "
                f"(N x (T + 4) = {n * (t + 4)} of them), the card gives {avail}: at C={c}, R={r}, T={t}, Tc={tc} "
                f"the kernel takes at most {max_nodes(score.device, c, r, t, tc)} nodes"
            )
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
    each call, which launches both stages, in ``fused_schedule_cuda.LAUNCHES``."""
    return fused_schedule_cuda_with_stats(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)[0]


def fused_schedule_cuda_with_stats(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus):
    """:func:`fused_schedule_cuda` and the resolve's counts: (FusedScan,
    int32 [2] on the card: the pods rescanned, the revivals)."""
    from platform_aware_scheduling_tpu_torch.models.fused import FusedScan

    _check(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)
    p, n = score.shape
    if p == 0 or n == 0:
        node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=score.device)
        stats = torch.zeros(2, dtype=torch.int32, device=score.device)
        return FusedScan(node_for_pod, capacity.clone(), gas.used.clone(), fits0.clone()), stats
    *scan, stats = launch(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)
    return FusedScan(*scan), stats


def _raise_on(err: int, stage: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_schedule {stage} kernel launch failed: cudaError {err}")


def launch(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus):
    """Both launches on inputs :func:`fused_schedule_cuda` has checked, P
    and N > 0: (node_for_pod, capacity_left, used, fits, stats).  Counted in
    ``fused_schedule_cuda.LAUNCHES``; it syncs nowhere, so the timing in
    ``chip_smoke.py`` can capture it in a CUDA graph."""
    lists, counts, used = launch_candidates(score, eligible, capacity, req_class, fits0, gas)
    out = launch_resolve(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus, lists, counts, used)
    fused_schedule_cuda.LAUNCHES += 1
    return out


def launch_candidates(score, eligible, capacity, req_class, fits0, gas) -> Tuple[torch.Tensor, ...]:
    """The candidate pass alone, on checked inputs: each pod's best
    starting-ok lanes in rank order (int32 [P, L], the first min(L,
    count) valid), its count of starting-ok lanes (int32 [P]) and a copy
    of the usage for the resolve to book into.  Not counted in
    ``LAUNCHES``."""
    p, n = score.shape
    _n, c, r = gas.used.shape
    device = score.device
    lists = torch.empty((p, LIST_SIZE), dtype=torch.int32, device=device)
    counts = torch.empty(p, dtype=torch.int32, device=device)
    used = torch.empty_like(gas.used)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().fused_schedule_candidates_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            req_class.data_ptr(),
            fits0.data_ptr(),
            gas.used.data_ptr(),
            used.data_ptr(),
            lists.data_ptr(),
            counts.data_ptr(),
            p,
            n,
            c,
            r,
            stream,
        )
    _raise_on(err, "candidate")
    return lists, counts, used


def launch_resolve(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus, lists, counts, used):
    """The resolve alone, on checked inputs and the candidate pass's
    output; books into ``used`` in place.  Returns (node_for_pod,
    capacity_left, used, fits, stats).  Not counted in ``LAUNCHES``."""
    p, n = score.shape
    _n, c, r = gas.used.shape
    t, tc, _r = requests.need.shape
    device = score.device
    node_for_pod = torch.empty(p, dtype=torch.int32, device=device)
    capacity_left = torch.empty(n, dtype=torch.int32, device=device)
    fits = torch.empty_like(fits0)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().fused_schedule_resolve_launch(
            score.data_ptr(),
            eligible.data_ptr(),
            capacity.data_ptr(),
            req_class.data_ptr(),
            fits0.data_ptr(),
            gas.capacity.data_ptr(),
            gas.cap_present.data_ptr(),
            gas.card_valid.data_ptr(),
            gas.card_real.data_ptr(),
            gas.card_order.data_ptr(),
            *(tensor.data_ptr() for tensor in requests),
            lists.data_ptr(),
            counts.data_ptr(),
            node_for_pod.data_ptr(),
            capacity_left.data_ptr(),
            used.data_ptr(),
            fits.data_ptr(),
            stats.data_ptr(),
            p,
            n,
            c,
            r,
            t,
            tc,
            max_gpus,
            stream,
        )
    _raise_on(err, "resolve")
    return node_for_pod, capacity_left, used, fits, stats


fused_schedule_cuda.LAUNCHES = 0
