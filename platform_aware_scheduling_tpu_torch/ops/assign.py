"""Greedy capacity-constrained batch assignment.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/assign.py``
(``greedy_assign_kernel``, ``lex_argmin``, ``_row_lex_argmax`` and
``auction_assign_kernel``) and ``ops/pallas_assign.py``
(``greedy_assign_pallas``).  For each pod in order, take the node with the
largest int64 score among ``eligible[p] & (capacity > 0)``, ties to the
lowest node index, then decrement that node's capacity.  Greedy in pod
order is what the sequential scheduler would decide, one pod at a time.
:func:`auction_assign` reaches the same result as a fixpoint of row
argmaxes, in a handful of rounds of ``[P, N]`` passes on the device.

:func:`greedy_assign` dispatches on where the tensors live: the plain
version for CPU tensors, the hand-written CUDA kernel
(``ops/cuda_assign.py``) for CUDA tensors.  A CUDA tensor never takes the
plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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
    for pod in range(p):
        _assign_one(score[pod], eligible[pod].bool() & (cap > 0), lanes, pod, node_for_pod, cap)
    return AssignResult(node_for_pod=node_for_pod, capacity_left=cap)


def lex_argmin(key: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the smallest int64 key among valid lanes of the last axis,
    ties to the lowest index: (idx int32, found bool), idx -1 where no
    lane is valid.  ``found`` is "any lane valid", so a valid lane keying
    INT64_MAX is still chosen."""
    n = key.shape[-1]
    lanes = torch.arange(n, dtype=torch.int64, device=key.device)
    least = torch.where(valid, key, i64.INT64_MAX).amin(dim=-1, keepdim=True)
    idx = torch.where(valid & (key == least), lanes, n).amin(dim=-1)
    found = valid.any(dim=-1)
    return torch.where(found, idx, -1).to(torch.int32), found


def _row_lex_argmax(score: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per-row argmax of int64 scores over the ok lanes, ties to the lowest
    index; -1 where no lane is ok.  [P, N] -> int32 [P]."""
    n = score.shape[-1]
    lanes = torch.arange(n, dtype=torch.int64, device=score.device)
    best = torch.where(ok, score, i64.INT64_MIN).amax(dim=-1, keepdim=True)
    idx = torch.where(ok & (score == best), lanes, n).amin(dim=-1)
    return torch.where(ok.any(dim=-1), idx, -1).to(torch.int32)


def auction_assign(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
) -> Tuple[AssignResult, int]:
    """The fixpoint form of greedy-in-order (JAX ``auction_assign_kernel``):
    exactly :func:`greedy_assign_reference`'s result, and the number of
    rounds it took.

    Every round, each pod takes its best eligible node among those whose
    holds by lower-index pods (an exclusive cumsum of the one-hot choices
    down the pod axis) are below capacity.  Pod p is stable after p rounds,
    and in practice the rounds follow the depth of contention.  Plain
    PyTorch on the inputs' device; one host read of "changed" a round."""
    p, n = eligible.shape
    capacity = capacity.to(torch.int32)
    eligible = eligible.bool()
    if p == 0 or n == 0:
        node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=capacity.device)
        return AssignResult(node_for_pod=node_for_pod, capacity_left=capacity.clone()), 0

    def holds_below(choice: torch.Tensor) -> torch.Tensor:
        # F.one_hot refuses -1, which JAX's one_hot maps to a zero row
        onehot = F.one_hot(choice.clamp(min=0).long(), n) * (choice >= 0).unsqueeze(-1)
        return onehot.cumsum(dim=0) - onehot  # exclusive: holds by lower indices

    choice = _row_lex_argmax(score, eligible & (capacity > 0).unsqueeze(0))
    rounds = 0
    changed = True
    while changed:
        room = holds_below(choice) < capacity.unsqueeze(0)
        new_choice = _row_lex_argmax(score, eligible & room)
        rounds += 1
        changed = bool((new_choice != choice).any())
        choice = new_choice
    taken = torch.zeros(n, dtype=torch.int32, device=capacity.device)
    taken.scatter_add_(0, choice.clamp(min=0).long(), (choice >= 0).to(torch.int32))
    return AssignResult(node_for_pod=choice, capacity_left=capacity - taken), rounds


def _assign_one(row, ok, lanes, pod, node_for_pod, cap) -> None:
    """One greedy step in place: the best ok lane of ``row`` (ties to the
    lowest index) takes pod ``pod`` and loses one capacity; no ok lane
    leaves -1 and the capacity as they are."""
    best = torch.where(ok, row, i64.INT64_MIN).max()
    chosen = torch.where(ok & (row == best), lanes, lanes.numel()).min()
    found = ok.any()
    node_for_pod[pod] = torch.where(found, chosen, -1).to(torch.int32)
    cap -= ((lanes == chosen) & found).to(torch.int32)


def greedy_assign_staged_reference(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
    k: int,
) -> Tuple[AssignResult, int]:
    """The CUDA kernel's two stages in plain PyTorch, for tests and
    ``chip_smoke.py``; returns the result and the number of rescans.

    Stage 1 lists, for each pod, its best ``k`` starting-ok lanes
    (``eligible & capacity > 0``) by (score descending, index ascending).
    Stage 2 walks the pods in order: the first listed lane that still has
    capacity takes the pod; when every listed lane is used up and the row
    had more starting-ok lanes, the pod's whole row is rescanned against
    the current capacity; otherwise the pod gets -1.  Equal to
    :func:`greedy_assign_reference`, since capacity only goes down."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    p, n = eligible.shape
    device = score.device
    node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=device)
    cap = capacity.to(torch.int32).clone()
    if p == 0 or n == 0:
        return AssignResult(node_for_pod=node_for_pod, capacity_left=cap), 0
    start_ok = eligible.bool() & (cap > 0)
    counts = start_ok.sum(dim=1).tolist()
    # stable sorts: score descending keeps equal scores in index order, then
    # starting-ok lanes ahead of the rest
    by_score = torch.sort(score, dim=1, descending=True, stable=True).indices
    ok_first = torch.sort((~start_ok.gather(1, by_score)).to(torch.uint8), dim=1, stable=True)
    lists = by_score.gather(1, ok_first.indices[:, : min(k, n)]).tolist()
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    cap_host = cap.tolist()
    rescans = 0
    for pod in range(p):
        taken = next((lane for lane in lists[pod][: counts[pod]] if cap_host[lane] > 0), None)
        if taken is not None:
            node_for_pod[pod] = taken
            cap_host[taken] -= 1
        elif counts[pod] > k:
            rescans += 1
            cap = torch.tensor(cap_host, dtype=torch.int32, device=device)
            _assign_one(score[pod], eligible[pod].bool() & (cap > 0), lanes, pod, node_for_pod, cap)
            cap_host = cap.tolist()
    cap = torch.tensor(cap_host, dtype=torch.int32, device=device)
    return AssignResult(node_for_pod=node_for_pod, capacity_left=cap), rescans


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
