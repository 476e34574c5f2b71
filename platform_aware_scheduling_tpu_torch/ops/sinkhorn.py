"""Sinkhorn-guided global assignment.

The port's counterpart of ``platform_aware_scheduling_tpu/ops/sinkhorn.py``
(``sinkhorn_assign_kernel``, ``_normalize_scores``, ``total_utility``).
Greedy in pod order is faithful to the sequential scheduler but myopic:
pod 0 can take the node pod 7 needed far more.  Here the pending set is an
optimal-transport problem (pods unit masses, nodes integer capacities, the
normalised score as utility) solved by entropic Sinkhorn iterations, plain
row and column scaling over a dense ``[P, N]`` matrix for a fixed number of
iterations.  The soft plan then guides the exact greedy assignment: greedy
runs on the plan's log-probabilities, quantised to int64 micro-nats, so
the result is always capacity-feasible and deterministic.

Plain PyTorch on the inputs' device, in float32 as the JAX program.  The
rounding goes through :func:`ops.assign.greedy_assign`: the CUDA greedy
kernel on a GPU, the plain loop on the CPU.  ``logsumexp`` sums in another
order than XLA's, so plans agree with the JAX package's to a tolerance,
not bit for bit, and an assignment can differ only where two guide values
of a pod lie that close (``tests/test_torch_sinkhorn.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from platform_aware_scheduling_tpu_torch.ops.assign import AssignResult, greedy_assign

NEG = -1e30

#: anneal steps, the JAX package's default for the single-chip and mesh forms
DEFAULT_ITERATIONS = 50

#: the guide's quantum: a log-probability in nats times this, as int32
MICRO = 1e6
#: the clip before the int32 cast, inside int32's range
GUIDE_CLIP = 2.0e9


class SinkhornResult(NamedTuple):
    assignment: AssignResult
    plan: torch.Tensor  # float32 [P, N] — the soft transport plan
    guide: torch.Tensor  # int64 [P, N] — the quantised log-plan greedy rounded


def _normalize_scores(score: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """int64 scores -> per-pod [0, 1] float32 utilities over the eligible
    lanes, 0 elsewhere.  The value is built as JAX builds it from its two
    limbs, ``hi * 2**32 + lo`` in float32 (two roundings), so the
    utilities equal the JAX package's bit for bit."""
    hi = (score >> 32).to(torch.float32)
    lo = (score & 0xFFFFFFFF).to(torch.float32)
    value = hi * 2.0**32 + lo
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=score.device)
    lo_v = torch.where(eligible, value, inf).amin(dim=1, keepdim=True)
    hi_v = torch.where(eligible, value, -inf).amax(dim=1, keepdim=True)
    span = torch.clamp(hi_v - lo_v, min=1.0)
    return torch.where(eligible, (value - lo_v) / span, 0.0)


def sinkhorn_logits(score: torch.Tensor, eligible: torch.Tensor, tau: float) -> torch.Tensor:
    """The scaled utilities, ``NEG`` off the eligible lanes (float32 [P, N]).
    ``tau`` divides as a tensor on the device: CUDA turns a division by a
    host scalar into a product with its reciprocal, one rounding away from
    JAX's quotient."""
    utility = _normalize_scores(score, eligible)
    divisor = torch.full((1,), tau, dtype=torch.float32, device=score.device)
    return torch.where(eligible, utility / divisor, NEG)


def sinkhorn_scaling(
    logits: torch.Tensor,  # float32 [P, N]
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
    iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Sinkhorn iterations: (log_u float32 [P], log_v float32 [N]).

    Rows place exactly one unit each; columns are only scaled down, to at
    most their capacity (unbalanced transport).  A pod with no eligible
    node is pinned at ``NEG``, so it adds no phantom mass to any column;
    a column of capacity <= 0 is ``NEG``."""
    p, n = logits.shape
    device = logits.device
    cap_f = capacity.to(torch.float32)
    has_eligible = eligible.any(dim=1)
    log_cap = torch.log(torch.clamp(cap_f, min=1e-9))
    log_u = torch.zeros(p, dtype=torch.float32, device=device)
    log_v = torch.zeros(n, dtype=torch.float32, device=device)
    for _ in range(iterations):
        row_lse = torch.logsumexp(logits + log_v.unsqueeze(0), dim=1)
        log_u = torch.where(has_eligible, -row_lse, NEG)
        col_lse = torch.logsumexp(logits + log_u.unsqueeze(1), dim=0)
        log_v = torch.clamp(log_cap - col_lse, max=0.0)
        log_v = torch.where(cap_f > 0, log_v, NEG)
    return log_u, log_v


def quantize_guide(log_plan: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """The log-plan as int64 micro-nats for the exact greedy comparator:
    ``clip(guide * 1e6, -2e9, 2e9)`` cast to int32 (toward zero), then
    sign-extended, as the JAX package builds its split int64."""
    guide = torch.where(eligible, log_plan, NEG)
    scaled = torch.clamp(guide * MICRO, -GUIDE_CLIP, GUIDE_CLIP)
    return scaled.to(torch.int32).to(torch.int64)


def sinkhorn_assign(
    score: torch.Tensor,  # int64 [P, N] — larger is better
    eligible: torch.Tensor,  # bool [P, N]
    capacity: torch.Tensor,  # int32 [N]
    iterations: int = DEFAULT_ITERATIONS,
    tau: float = 0.05,
) -> SinkhornResult:
    """Globally coordinated assignment: the Sinkhorn plan rounded by the
    exact greedy assignment.  Always capacity-feasible; deterministic on
    one device."""
    eligible = eligible.bool()
    logits = sinkhorn_logits(score, eligible, tau)
    log_u, log_v = sinkhorn_scaling(logits, eligible, capacity, iterations)
    log_plan = logits + log_u.unsqueeze(1) + log_v.unsqueeze(0)
    plan = torch.where(eligible, torch.exp(log_plan), 0.0)
    guide = quantize_guide(log_plan, eligible)
    assignment = greedy_assign(guide, eligible, capacity)
    return SinkhornResult(assignment=assignment, plan=plan, guide=guide)


def total_utility(score: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """Sum of the normalised utilities of the chosen nodes (every lane
    eligible), the objective the tests compare solvers by."""
    eligible = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    utility = _normalize_scores(score, eligible)
    chosen = assignment.long().clamp(min=0).unsqueeze(1)
    picked = torch.where(assignment >= 0, utility.gather(1, chosen)[:, 0], 0.0)
    return picked.sum()
