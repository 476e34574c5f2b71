"""Greedy capacity-constrained batch assignment.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/assign.py``
(``greedy_assign_kernel``) and ``ops/pallas_assign.py``
(``greedy_assign_pallas``).  For each pod in order, take the node with the
largest int64 score among ``eligible[p] & (capacity > 0)``, ties to the
lowest node index, then decrement that node's capacity.  Greedy in pod
order is what the sequential scheduler would decide, one pod at a time.

:func:`greedy_assign` dispatches on where the tensors live: the plain
version for CPU tensors, the hand-written CUDA kernel
(``ops/cuda_assign.py``) for CUDA tensors.  A CUDA tensor never takes the
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platform_aware_scheduling_tpu_torch.ops import i64


class AssignResult(NamedTuple):
    node_for_pod: torch.Tensor  # int32 [P] — node index or -1
    capacity_left: torch.Tensor  # int32 [N]


def greedy_assign_reference(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
) -> AssignResult:
    """The plain PyTorch version: a loop over pods, one masked argmax each.

    ``found`` comes from "any lane ok", never from comparing the max with
    a sentinel, so an eligible lane scoring INT64_MIN is still chosen.
    Runs on whatever device the inputs live on, without host syncs."""
    p, n = eligible.shape
    device = score.device
    node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=device)
    cap = capacity.to(torch.int32).clone()
    if p == 0 or n == 0:
        return AssignResult(node_for_pod=node_for_pod, capacity_left=cap)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    none = torch.full((), n, dtype=torch.int64, device=device)
    floor = torch.full((), i64.INT64_MIN, dtype=torch.int64, device=device)
    for pod in range(p):
        ok = eligible[pod].bool() & (cap > 0)
        row = score[pod]
        best = torch.where(ok, row, floor).max()
        chosen = torch.where(ok & (row == best), lanes, none).min()
        found = ok.any()
        node_for_pod[pod] = torch.where(found, chosen, -1).to(torch.int32)
        cap -= ((lanes == chosen) & found).to(torch.int32)
    return AssignResult(node_for_pod=node_for_pod, capacity_left=cap)


def greedy_assign(
    score: torch.Tensor, eligible: torch.Tensor, capacity: torch.Tensor
) -> AssignResult:
    """Exact greedy-in-order assignment on the inputs' device: the plain
    version on the CPU, the CUDA kernel on a GPU."""
    devices = {score.device, eligible.device, capacity.device}
    if len(devices) != 1:
        raise ValueError(f"greedy_assign inputs on different devices: {devices}")
    device = score.device
    if device.type == "cpu":
        return greedy_assign_reference(score, eligible, capacity)
    if device.type == "cuda":
        from platform_aware_scheduling_tpu_torch.ops.cuda_assign import (
            greedy_assign_cuda,
        )

        return greedy_assign_cuda(score, eligible, capacity)
    raise ValueError(f"greedy_assign has no path for device {device}")
