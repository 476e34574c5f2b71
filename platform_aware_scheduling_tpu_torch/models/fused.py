"""The fused TAS+GAS solve: telemetry scoring and per-card bin-packing
feasibility in one pass over the pending set.

The port's counterpart of ``platform_aware_scheduling_tpu/models/fused.py``
(``fused_schedule``, ``_all_fits``).  The reference ships this composition
as two chained extenders: TAS filters and scores a pod on telemetry, then
GAS prunes the nodes where no card fits the request and books the cards at
Bind.  Here the whole pending set is solved at once:

  1. TAS half: dontschedule violations, per-pod score keys and candidate
     eligibility (``models/batch_scheduler.score_and_filter``);
  2. GAS half: the first-fit feasibility of each request class against
     every node, ``fits[T, N]`` (:func:`_all_fits`: ``ops/binpack.binpack``
     once a class, the CUDA bin-pack kernel on a GPU);
  3. the scan in pod order: each pod takes its best-scoring node among
     ``eligible & capacity > 0 & fits[class]`` (ties to the lowest index);
     booking it re-packs that node's cards first-fit exactly as GAS Bind
     does, takes one slot of its capacity and refits that one node for
     every class, since no other node's fits can change.

Pod i gets its best feasible node given pods 0..i-1's bookings, the
sequential composition's decision.  Step 3 is :func:`fused_scan`: the
plain loop :func:`fused_scan_reference` on the CPU, the hand-written CUDA
kernel (``ops/cuda_fused.py`` → ``csrc/fused_schedule.cu``) on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from platform_aware_scheduling_tpu_torch.models.batch_scheduler import (
    ClusterState,
    PendingPods,
    score_and_filter,
)
from platform_aware_scheduling_tpu_torch.ops import i64
from platform_aware_scheduling_tpu_torch.ops.assign import lex_argmin
from platform_aware_scheduling_tpu_torch.ops.binpack import (
    BinpackNodeState,
    BinpackRequest,
    binpack,
    binpack_reference,
    fit_one_node,
)


class FusedRequests(NamedTuple):
    """T request classes, each a stacked :class:`BinpackRequest`."""

    need: torch.Tensor  # int64 [T, Tc, R] per-GPU share per container
    need_active: torch.Tensor  # bool [T, Tc, R]
    num_gpus: torch.Tensor  # int32 [T, Tc]
    container_active: torch.Tensor  # bool [T, Tc]

    def request(self, t: int) -> BinpackRequest:
        return BinpackRequest(self.need[t], self.need_active[t], self.num_gpus[t], self.container_active[t])


class FusedScan(NamedTuple):
    """What the scan produces: the four outputs of :class:`FusedOutput`
    that the kernel computes."""

    node_for_pod: torch.Tensor  # int32 [P] — node index or -1
    capacity_left: torch.Tensor  # int32 [N]
    used: torch.Tensor  # int64 [N, C, R] card usage after all bookings
    fits: torch.Tensor  # bool [T, N] feasibility after all bookings


class FusedOutput(NamedTuple):
    node_for_pod: torch.Tensor  # int32 [P] — node index or -1
    capacity_left: torch.Tensor  # int32 [N]
    used: torch.Tensor  # int64 [N, C, R] card usage after all bookings
    fits: torch.Tensor  # bool [T, N] feasibility after all bookings
    violating: torch.Tensor  # bool [N] — TAS dontschedule mask


def _all_fits(gas: BinpackNodeState, requests: FusedRequests, max_gpus: int, fit=binpack) -> torch.Tensor:
    """fits[T, N]: every request class against every node, one bin-pack
    call a class (``fit``: :func:`ops.binpack.binpack`, or its plain
    version)."""
    return torch.stack([fit(gas, requests.request(k), max_gpus).fits for k in range(requests.need.shape[0])])


def fused_scan_reference(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
    req_class: torch.Tensor,  # int32 [P], each in [0, T)
    fits0: torch.Tensor,  # bool [T, N] — _all_fits before any booking
    gas: BinpackNodeState,
    requests: FusedRequests,
    max_gpus: int,
) -> FusedScan:
    """The plain version of the scan (JAX ``fused_schedule``'s ``step``):
    a loop over pods, each one masked argmax, one first-fit re-pack of the
    chosen node (:func:`ops.binpack.fit_one_node`) and its refit for every
    class.  Runs on the inputs' device; it reads ``req_class`` to the host
    once and syncs nowhere else.

    A pod with no ok lane books nothing (JAX re-packs node 0 and throws the
    result away).  The fits gate means the chosen node takes the whole
    request, so the re-pack's usage is booked as it is."""
    p, n = eligible.shape
    device = eligible.device
    node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=device)
    cap = capacity.to(torch.int32).clone()
    used = gas.used.clone()
    fits = fits0.clone()
    if p == 0 or n == 0:
        return FusedScan(node_for_pod, cap, used, fits)
    t = requests.need.shape[0]
    card_ok = gas.card_valid & gas.card_real
    eligible = eligible.bool()
    classes = req_class.tolist()
    for pod in range(p):
        cls = classes[pod]
        ok = eligible[pod] & (cap > 0) & fits[cls]
        best, found = lex_argmin(i64.flip(score[pod]), ok)
        node_for_pod[pod] = best
        node = best.clamp(min=0).long().view(1)  # a safe index when nothing was found
        node_args = (
            gas.capacity.index_select(0, node)[0],
            gas.cap_present.index_select(0, node)[0],
            card_ok.index_select(0, node)[0],
            gas.card_order.index_select(0, node)[0],
        )
        used_n = used.index_select(0, node)[0]
        _fit, _picks, booked_n = fit_one_node(used_n, *node_args, requests.request(cls), max_gpus)
        used.index_copy_(0, node, torch.where(found, booked_n, used_n).unsqueeze(0))
        column = torch.stack(
            [fit_one_node(booked_n, *node_args, requests.request(k), max_gpus)[0] for k in range(t)]
        )
        fits.index_copy_(1, node, torch.where(found, column, fits.index_select(1, node)[:, 0]).unsqueeze(1))
        cap.index_add_(0, node, -found.to(torch.int32).view(1))
    return FusedScan(node_for_pod, cap, used, fits)


class StagedStats(NamedTuple):
    rescans: int  # pods whose whole row was rescanned
    revivals: int  # refits that turned a class fit from false to true


def fused_scan_staged_reference(
    score: torch.Tensor,
    eligible: torch.Tensor,
    capacity: torch.Tensor,
    req_class: torch.Tensor,
    fits0: torch.Tensor,
    gas: BinpackNodeState,
    requests: FusedRequests,
    max_gpus: int,
    list_size: int,
    revived_size: int,
) -> Tuple[FusedScan, StagedStats]:
    """The CUDA kernel's two launches in plain PyTorch, for tests and
    ``chip_smoke.py``: the scan and the resolve's counts.  Equal to
    :func:`fused_scan_reference`; the source note of
    ``csrc/fused_schedule.cu`` argues why.

    The candidate pass lists, for each pod, its best ``list_size``
    starting-ok lanes (``eligible & capacity > 0 & fits0[class]``) by
    (score descending, index ascending) and counts them all.  The resolve
    walks the pods in order.  A refit that turns class t on for a node puts
    the node on class t's revived list (unless it is on it; a list full at
    ``revived_size`` marks the class overflowed for good).  A pod of class
    t whose class overflowed is rescanned; otherwise it drops the revived
    nodes no longer ok for the class, takes the first listed lane still ok
    and weighs it against the best revived node ok and eligible for it;
    with no listed lane ok it rescans when the row had more starting-ok
    lanes than the list, and otherwise takes the best revived node or
    -1."""
    if list_size < 1 or revived_size < 1:
        raise ValueError(f"list_size and revived_size must be at least 1, got {list_size}, {revived_size}")
    p, n = eligible.shape
    device = eligible.device
    used = gas.used.clone()
    if p == 0 or n == 0:
        node_for_pod = torch.full((p,), -1, dtype=torch.int32, device=device)
        return FusedScan(node_for_pod, capacity.to(torch.int32).clone(), used, fits0.clone()), StagedStats(0, 0)
    t = requests.need.shape[0]
    eligible = eligible.bool()
    start_ok = eligible & (capacity > 0) & fits0[req_class.long()]
    counts = start_ok.sum(dim=1).tolist()
    # stable sorts: score descending keeps equal scores in index order, then
    # starting-ok lanes ahead of the rest
    by_score = torch.sort(score, dim=1, descending=True, stable=True).indices
    ok_first = torch.sort((~start_ok.gather(1, by_score)).to(torch.uint8), dim=1, stable=True).indices
    lists = by_score.gather(1, ok_first[:, : min(list_size, n)]).tolist()
    classes = req_class.tolist()
    cap = capacity.tolist()
    fits = fits0.tolist()
    card_ok = gas.card_valid & gas.card_real
    revived = [[] for _ in range(t)]
    overflow = [False] * t
    node_for_pod = [-1] * p
    rescans = revivals = 0
    for pod in range(p):
        cls = classes[pod]
        fit = fits[cls]
        winner = None  # None: rescan
        if not overflow[cls]:
            revived[cls] = [node for node in revived[cls] if cap[node] > 0 and fit[node]]
            live = next((node for node in lists[pod][: counts[pod]] if cap[node] > 0 and fit[node]), None)
            if live is not None or counts[pod] <= list_size:
                weighed = [node for node in revived[cls] if bool(eligible[pod, node])]
                weighed += [] if live is None else [live]
                winner = max(weighed, key=lambda node: (int(score[pod, node]), -node), default=-1)
        if winner is None:
            rescans += 1
            ok = eligible[pod] & (torch.tensor(cap, device=device) > 0) & torch.tensor(fit, device=device)
            best, found = lex_argmin(i64.flip(score[pod]), ok)
            winner = int(best) if bool(found) else -1
        node_for_pod[pod] = winner
        if winner < 0:
            continue
        node = torch.tensor([winner], device=device)
        node_args = (
            gas.capacity.index_select(0, node)[0],
            gas.cap_present.index_select(0, node)[0],
            card_ok.index_select(0, node)[0],
            gas.card_order.index_select(0, node)[0],
        )
        _fit, _picks, booked = fit_one_node(used[winner], *node_args, requests.request(cls), max_gpus)
        used[winner] = booked
        cap[winner] -= 1
        for k in range(t):
            now = bool(fit_one_node(booked, *node_args, requests.request(k), max_gpus)[0])
            if now and not fits[k][winner]:
                revivals += 1
                if winner not in revived[k]:
                    if len(revived[k]) < revived_size:
                        revived[k].append(winner)
                    else:
                        overflow[k] = True
            fits[k][winner] = now
    scan = FusedScan(
        torch.tensor(node_for_pod, dtype=torch.int32, device=device),
        torch.tensor(cap, dtype=torch.int32, device=device),
        used,
        torch.tensor(fits, dtype=torch.bool, device=device),
    )
    return scan, StagedStats(rescans, revivals)


def fused_scan(
    score: torch.Tensor,
    eligible: torch.Tensor,
    capacity: torch.Tensor,
    req_class: torch.Tensor,
    fits0: torch.Tensor,
    gas: BinpackNodeState,
    requests: FusedRequests,
    max_gpus: int,
) -> FusedScan:
    """The scan on the inputs' device: the plain version on the CPU, the
    CUDA kernel on a GPU."""
    tensors = (score, eligible, capacity, req_class, fits0, *gas, *requests)
    devices = {tensor.device for tensor in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_scan inputs on different devices: {devices}")
    device = score.device
    if device.type == "cpu":
        return fused_scan_reference(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)
    if device.type == "cuda":
        from platform_aware_scheduling_tpu_torch.ops.cuda_fused import fused_schedule_cuda

        return fused_schedule_cuda(score, eligible, capacity, req_class, fits0, gas, requests, max_gpus)
    raise ValueError(f"fused_scan has no path for device {device}")


def fused_schedule(
    state: ClusterState,
    pods: PendingPods,
    req_class: torch.Tensor,  # int32 [P] — request class per pod
    gas: BinpackNodeState,
    requests: FusedRequests,
    max_gpus: int,
) -> FusedOutput:
    """One fused TAS+GAS solve over the pending set (module doc) on the
    inputs' device: on a GPU, T bin-pack launches and one scan launch."""
    violating, score, eligible = score_and_filter(state, pods)
    fits0 = _all_fits(gas, requests, max_gpus)
    scan = fused_scan(score, eligible, state.capacity, req_class, fits0, gas, requests, max_gpus)
    return FusedOutput(*scan, violating=violating)


def fused_schedule_reference(
    state: ClusterState,
    pods: PendingPods,
    req_class: torch.Tensor,
    gas: BinpackNodeState,
    requests: FusedRequests,
    max_gpus: int,
) -> FusedOutput:
    """:func:`fused_schedule` by the plain versions alone, on whatever
    device the inputs live on: ``binpack_reference`` for the fits and
    :func:`fused_scan_reference` for the scan."""
    violating, score, eligible = score_and_filter(state, pods)
    fits0 = _all_fits(gas, requests, max_gpus, fit=binpack_reference)
    scan = fused_scan_reference(score, eligible, state.capacity, req_class, fits0, gas, requests, max_gpus)
    return FusedOutput(*scan, violating=violating)
