"""Ordinal Prioritize scoring and the Filter verdict over dense tensors.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/scoring.py``.
Prioritize orders one metric's values (GreaterThan descending, LessThan
ascending, any other operator in node-index order) over the candidate ∩
metric-present lanes and scores them ordinally, ``10 - rank``.  Filter
passes a candidate unless the policy's dontschedule rules mark it
violating; :func:`filter_explain` also returns the first matching rule
per node, the integer reason the decision log decodes on the host.

Plain PyTorch on whatever device the inputs live on, over native int64.
The order is the JAX package's lexicographic ``(key, tiebreak)`` sort:
invalid lanes carry the key ``INT64_MAX`` and a tiebreak past every valid
lane, so a valid GreaterThan lane whose value is ``INT64_MIN`` (flipped to
``INT64_MAX``) still ranks before every invalid lane.  A single stable
sort by key would put it among them in index order, so the sort is two
stable passes: by tiebreak, then by key.

Each function counts its calls in its ``CALLS`` attribute, so a caller
can show which of them a verb went through.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from platform_aware_scheduling_tpu_torch.ops import i64
from platform_aware_scheduling_tpu_torch.ops.rules import (
    OP_GREATER_THAN,
    OP_LESS_THAN,
    RuleSet,
    first_violated_rule,
    violated_nodes,
)

IntLike = Union[int, torch.Tensor]


class PrioritizeResult(NamedTuple):
    scores: torch.Tensor  # int32 [..., N] — 10 - rank, meaningful on valid lanes
    valid: torch.Tensor  # bool [..., N] — candidate ∩ metric-present
    perm: torch.Tensor  # int32 [..., N] — node indices in rank order (valid first)
    valid_count: torch.Tensor  # int32 [...] — number of valid lanes


class FilterExplainResult(NamedTuple):
    passing: torch.Tensor  # bool [N] — candidate & not violating
    first_rule: torch.Tensor  # int32 [N] — first matching rule index, -1 clean


def _rank_keys(
    value: torch.Tensor,  # int64 [..., N] milli-units
    valid: torch.Tensor,  # bool [..., N]
    op_id: torch.Tensor,  # int32 [..., 1]
    index: torch.Tensor,  # int64 [N]
) -> torch.Tensor:
    """The int64 sort key of one rule's ordering: ``flip(value)`` for
    GreaterThan, ``value`` for LessThan, the node index for any other
    operator, and ``INT64_MAX`` on invalid lanes."""
    by_value = torch.where(op_id == OP_GREATER_THAN, i64.flip(value), value)
    sorts_by_value = (op_id == OP_LESS_THAN) | (op_id == OP_GREATER_THAN)
    key = torch.where(sorts_by_value, by_value, index)
    return torch.where(valid, key, torch.full_like(key, i64.INT64_MAX))


def ordinal_scores(value: torch.Tensor, valid: torch.Tensor, op_id: IntLike) -> PrioritizeResult:
    """Scores for one scheduling rule over all (padded) nodes; ``value``
    and ``valid`` may carry leading batch dimensions, which ``op_id``
    (an int or a tensor of the batch shape) matches."""
    ordinal_scores.CALLS += 1
    n = value.shape[-1]
    device = value.device
    index = torch.arange(n, dtype=torch.int64, device=device)
    op = torch.as_tensor(op_id, dtype=torch.int32, device=device)[..., None]
    key = _rank_keys(value, valid, op, index)
    # valid lanes win key ties against invalid sentinels; ties between
    # valid lanes break by node index
    tiebreak = torch.where(valid, index, index + n)
    by_tiebreak = torch.sort(tiebreak, dim=-1, stable=True).indices
    by_key = torch.sort(key.gather(-1, by_tiebreak), dim=-1, stable=True).indices
    perm = by_tiebreak.gather(-1, by_key)
    ranks = torch.empty_like(perm).scatter_(-1, perm, index.expand_as(perm))
    return PrioritizeResult(
        scores=(10 - ranks).to(torch.int32),
        valid=valid,
        perm=perm.to(torch.int32),
        valid_count=valid.sum(dim=-1, dtype=torch.int32),
    )


def prioritize(
    metric_values: torch.Tensor,  # int64 [M, N]
    metric_present: torch.Tensor,  # bool [M, N]
    metric_row: int,  # the scheduleonmetric rule[0] metric
    op_id: int,
    candidate_mask: torch.Tensor,  # bool [N]
) -> PrioritizeResult:
    """The Prioritize verb for one pod: candidate ∩ metric-present
    intersection, ordering, ordinal scores."""
    prioritize.CALLS += 1
    valid = candidate_mask & metric_present[metric_row]
    return ordinal_scores(metric_values[metric_row], valid, op_id)


def batch_prioritize(
    metric_values: torch.Tensor,  # int64 [M, N]
    metric_present: torch.Tensor,  # bool [M, N]
    metric_row: torch.Tensor,  # int [K] — per-row rule metric
    op_id: torch.Tensor,  # int32 [K]
    candidate_mask: torch.Tensor,  # bool [K, N]
) -> PrioritizeResult:
    """K rankings in one batched pass over ``[K, N]``."""
    batch_prioritize.CALLS += 1
    rows = metric_row.long()
    valid = candidate_mask & metric_present[rows]
    return ordinal_scores(metric_values[rows], valid, op_id)


def filter(
    metric_values: torch.Tensor,  # int64 [M, N]
    metric_present: torch.Tensor,  # bool [M, N]
    rules: RuleSet,
    candidate_mask: torch.Tensor,  # bool [N]
) -> torch.Tensor:
    """The Filter verb for one pod: a candidate passes unless the
    dontschedule rules mark it violating."""
    filter.CALLS += 1
    return candidate_mask & ~violated_nodes(metric_values, metric_present, rules)


def filter_explain(
    metric_values: torch.Tensor,  # int64 [M, N]
    metric_present: torch.Tensor,  # bool [M, N]
    rules: RuleSet,
    candidate_mask: torch.Tensor,  # bool [N]
) -> FilterExplainResult:
    """The Filter verb with provenance: the verdict of :func:`filter` and
    the per-node index of the first matching rule (-1 when clean)."""
    filter_explain.CALLS += 1
    first = first_violated_rule(metric_values, metric_present, rules)
    return FilterExplainResult(passing=candidate_mask & (first < 0), first_rule=first)


for _fn in (ordinal_scores, prioritize, batch_prioritize, filter, filter_explain):
    _fn.CALLS = 0
del _fn
