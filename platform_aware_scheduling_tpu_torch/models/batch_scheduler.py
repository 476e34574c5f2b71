"""The batched scheduling solve: filter + score + assign over dense tensors.

The port's counterpart of
``platform_aware_scheduling_tpu/models/batch_scheduler.py``.  The WHOLE
pending set is solved at once:

  1. dontschedule violations over the metric matrix  (ops/rules.py)
  2. per-pod score keys from each pod's scheduleonmetric rule
  3. greedy capacity-constrained assignment           (ops/assign.py)

Greedy in pod order reproduces what the sequential scheduler would
decide, so the per-pod verbs can be answered from this solution.  Steps 1
and 2 are plain PyTorch on the inputs' device; step 3 runs the CUDA kernel
on a GPU and its plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.ops import i64
from platform_aware_scheduling_tpu_torch.ops.assign import AssignResult, greedy_assign
from platform_aware_scheduling_tpu_torch.ops.rules import (
    OP_GREATER_THAN,
    OP_LESS_THAN,
    RuleSet,
    violated_nodes,
)
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device


class ClusterState(NamedTuple):
    """Dense form of the cluster, maintained by the state mirror."""

    metric_values: torch.Tensor  # int64 [M, N] milli-units
    metric_present: torch.Tensor  # bool [M, N]
    dontschedule: RuleSet  # shared violation rules
    capacity: torch.Tensor  # int32 [N] — pods each node may still accept


class PendingPods(NamedTuple):
    """The pending set: one scheduleonmetric rule + candidate mask per pod."""

    metric_row: torch.Tensor  # int32 [P]
    op_id: torch.Tensor  # int32 [P]
    candidates: torch.Tensor  # bool [P, N]


class ScheduleOutput(NamedTuple):
    assignment: AssignResult
    violating: torch.Tensor  # bool [N]
    score: torch.Tensor  # int64 [P, N] keys used (larger = better)
    eligible: torch.Tensor  # bool [P, N] — candidates ∩ present ∩ ¬violating


def _score_keys(
    values: torch.Tensor, present: torch.Tensor, metric_row: torch.Tensor, op_id: torch.Tensor
) -> torch.Tensor:
    """Per-pod score keys where larger is better: GreaterThan keeps the
    metric value, LessThan flips it, anything else prefers low node index
    (``~index``, the deterministic stand-in for a map-order walk)."""
    v = values[metric_row.long()]  # [P, N]
    op = op_id[:, None]
    by_value = torch.where(op == OP_GREATER_THAN, v, i64.flip(v))
    index_key = i64.flip(torch.arange(v.shape[-1], dtype=torch.int64, device=v.device))
    sorts = (op == OP_LESS_THAN) | (op == OP_GREATER_THAN)
    return torch.where(sorts, by_value, index_key)


def score_and_filter(
    state: ClusterState, pods: PendingPods
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The non-assignment half of the solve: (violating, score, eligible)."""
    violating = violated_nodes(
        state.metric_values, state.metric_present, state.dontschedule
    )
    score = _score_keys(
        state.metric_values, state.metric_present, pods.metric_row, pods.op_id
    )
    present = state.metric_present[pods.metric_row.long()]  # [P, N]
    eligible = pods.candidates & present & ~violating[None, :]
    return violating, score, eligible


def scheduling_step(state: ClusterState, pods: PendingPods) -> ScheduleOutput:
    """One full solve over the pending set."""
    violating, score, eligible = score_and_filter(state, pods)
    assignment = greedy_assign(score, eligible, state.capacity)
    return ScheduleOutput(
        assignment=assignment, violating=violating, score=score, eligible=eligible
    )


def example_inputs(
    num_metrics: int = 4,
    num_nodes: int = 64,
    num_pods: int = 16,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[ClusterState, PendingPods]:
    """Small synthetic (state, pods) pair.  Draws the same numbers in the
    same order as the JAX package's ``example_inputs``, so one seed gives
    both packages the same problem."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1_000_000, size=(num_metrics, num_nodes)).astype(np.int64)
    present = rng.random((num_metrics, num_nodes)) > 0.05
    capacity = rng.integers(1, 4, size=num_nodes).astype(np.int32)
    metric_row = rng.integers(0, num_metrics, size=num_pods).astype(np.int32)
    op_id = rng.choice([OP_LESS_THAN, OP_GREATER_THAN], size=num_pods).astype(np.int32)
    candidates = rng.random((num_pods, num_nodes)) > 0.1

    def put(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    state = ClusterState(
        metric_values=put(values),
        metric_present=put(present),
        dontschedule=RuleSet(
            metric_row=put(np.array([0, 1], dtype=np.int32)),
            op_id=put(np.array([OP_GREATER_THAN, OP_GREATER_THAN], dtype=np.int32)),
            target=put(np.array([500_000, 900_000], dtype=np.int64)),
            active=put(np.array([True, True])),
        ),
        capacity=put(capacity),
    )
    pods = PendingPods(metric_row=put(metric_row), op_id=put(op_id), candidates=put(candidates))
    return state, pods
