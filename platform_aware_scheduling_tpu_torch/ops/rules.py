"""Vectorized TAS rule evaluation over dense int64 tensors.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/rules.py``.
A rule set is four aligned tensors — ``metric_row [R]``, ``op_id [R]``,
``target [R]`` (int64 milli-units) and ``active [R]`` (masking the
``RULE_PAD`` padding) — and evaluating all R rules over all N nodes is one
compare/select pass over the ``[M, N]`` metric matrix.  A node takes part
in a rule only when it is present in that rule's metric; violation is the
OR across rules.  Plain PyTorch on whatever device the inputs live on.

:func:`violated_nodes` counts its calls in its ``CALLS`` attribute, as the
functions of ``ops/scoring.py`` do, so a caller can show that the
deschedule enforcer and the planner went through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

OP_LESS_THAN = 0
OP_GREATER_THAN = 1
OP_EQUALS = 2

OP_IDS = {"LessThan": OP_LESS_THAN, "GreaterThan": OP_GREATER_THAN, "Equals": OP_EQUALS}


class RuleSet(NamedTuple):
    """Dense form of ``[]TASPolicyRule``.  All tensors share leading dim R
    (padded; ``active`` masks real rules)."""

    metric_row: torch.Tensor  # int32 [R] — row in the metric matrix
    op_id: torch.Tensor  # int32 [R]
    target: torch.Tensor  # int64 [R] milli-units
    active: torch.Tensor  # bool [R]


def rule_matches(
    value: torch.Tensor, op_id: torch.Tensor, target: torch.Tensor
) -> torch.Tensor:
    """``value <op> target`` elementwise; broadcastable.  An unknown
    operator id falls to the Equals branch, as in the JAX package.  The
    GPU compares int64 natively, so each operator is one compare (the
    JAX package goes through ``i64.cmp`` on hi/lo pairs); fewer ops also
    mean fewer interpreter-lock handoffs when another thread is busy."""
    return torch.where(
        op_id == OP_LESS_THAN,
        value < target,
        torch.where(op_id == OP_GREATER_THAN, value > target, value == target),
    )


def evaluate_rules(
    metric_values: torch.Tensor,  # int64 [M, N] milli-units
    metric_present: torch.Tensor,  # bool [M, N]
    rules: RuleSet,
) -> torch.Tensor:
    """Per-rule match mask ``[R, N]``: node n matches rule r iff the node is
    present in rule r's metric and the compare holds."""
    rows = rules.metric_row.long()
    values = metric_values[rows]  # [R, N]
    present = metric_present[rows]
    matched = rule_matches(values, rules.op_id[:, None], rules.target[:, None])
    return matched & present & rules.active[:, None]


def violated_nodes(
    metric_values: torch.Tensor, metric_present: torch.Tensor, rules: RuleSet
) -> torch.Tensor:
    """OR-of-rules violation mask ``[N]``."""
    violated_nodes.CALLS += 1
    return evaluate_rules(metric_values, metric_present, rules).any(dim=0)


violated_nodes.CALLS = 0


def first_violated_rule(
    metric_values: torch.Tensor, metric_present: torch.Tensor, rules: RuleSet
) -> torch.Tensor:
    """Per-node index of the FIRST matching rule ``[N]`` (int32; -1 when
    the node violates nothing).  "First" is rule-list order."""
    matched = evaluate_rules(metric_values, metric_present, rules)  # [R, N]
    # argmax returns the first maximal index; 0 when nothing matches
    first = matched.to(torch.int8).argmax(dim=0).to(torch.int32)
    return torch.where(matched.any(dim=0), first, torch.full_like(first, -1))
