"""Carry the JAX package's solve inputs across into the port.

The system's "weights" are its cluster state.  The JAX package holds
int64 as the ``(hi: int32, lo: uint32)`` split of its ``ops/i64.py``;
these functions take those arrays as numpy arrays, join every int64
exactly, and build the port's ``ClusterState`` / ``PendingPods`` and GAS
``BinpackNodeState`` / ``BinpackRequest`` and the fused solve's
``FusedRequests`` on ``device``.  The forecast
plane's staged history and fit outputs are int32 and bool already: they
cross as they are, onto ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from platform_aware_scheduling_tpu_torch.models.batch_scheduler import (
    ClusterState,
    PendingPods,
)
from platform_aware_scheduling_tpu_torch.models.fused import FusedRequests
from platform_aware_scheduling_tpu_torch.ops.binpack import BinpackNodeState, BinpackRequest
from platform_aware_scheduling_tpu_torch.ops.forecast import ForecastResult
from platform_aware_scheduling_tpu_torch.ops.i64 import join_int64
from platform_aware_scheduling_tpu_torch.ops.rules import RuleSet
from platform_aware_scheduling_tpu_torch.utils.device import DeviceLike, resolve_device


def _put(array, dtype, device: torch.device) -> torch.Tensor:
    # a copy: the caller's array may be read-only (a view of a JAX array)
    return torch.from_numpy(np.array(array, dtype=dtype, order="C")).to(device)


def cluster_state_from_numpy(
    values_hi,  # int32 [M, N]
    values_lo,  # uint32 [M, N]
    present,  # bool [M, N]
    rule_rows,  # int32 [R]
    rule_ops,  # int32 [R]
    target_hi,  # int32 [R]
    target_lo,  # uint32 [R]
    rule_active,  # bool [R]
    capacity,  # int32 [N]
    device: DeviceLike = None,
) -> ClusterState:
    device = resolve_device(device)
    return ClusterState(
        metric_values=_put(join_int64(values_hi, values_lo), np.int64, device),
        metric_present=_put(present, bool, device),
        dontschedule=RuleSet(
            metric_row=_put(rule_rows, np.int32, device),
            op_id=_put(rule_ops, np.int32, device),
            target=_put(join_int64(target_hi, target_lo), np.int64, device),
            active=_put(rule_active, bool, device),
        ),
        capacity=_put(capacity, np.int32, device),
    )


def pending_pods_from_numpy(
    metric_row,  # int32 [P]
    op_id,  # int32 [P]
    candidates,  # bool [P, N]
    device: DeviceLike = None,
) -> PendingPods:
    device = resolve_device(device)
    return PendingPods(
        metric_row=_put(metric_row, np.int32, device),
        op_id=_put(op_id, np.int32, device),
        candidates=_put(candidates, bool, device),
    )


def binpack_state_from_numpy(
    used_hi,  # int32 [N, C, R]
    used_lo,  # uint32 [N, C, R]
    capacity_hi,  # int32 [N, R]
    capacity_lo,  # uint32 [N, R]
    cap_present,  # bool [N, R]
    card_valid,  # bool [N, C]
    card_real,  # bool [N, C]
    card_order,  # int32 [N, C]
    device: DeviceLike = None,
) -> BinpackNodeState:
    """A JAX ``BinpackNodeState`` (split int64) as the port's."""
    device = resolve_device(device)
    return BinpackNodeState(
        used=_put(join_int64(used_hi, used_lo), np.int64, device),
        capacity=_put(join_int64(capacity_hi, capacity_lo), np.int64, device),
        cap_present=_put(cap_present, bool, device),
        card_valid=_put(card_valid, bool, device),
        card_real=_put(card_real, bool, device),
        card_order=_put(card_order, np.int32, device),
    )


def binpack_request_from_numpy(
    need_hi,  # int32 [T, R]
    need_lo,  # uint32 [T, R]
    need_active,  # bool [T, R]
    num_gpus,  # int32 [T]
    container_active,  # bool [T]
    device: DeviceLike = None,
) -> BinpackRequest:
    """A JAX ``BinpackRequest`` (split int64) as the port's."""
    device = resolve_device(device)
    return BinpackRequest(
        need=_put(join_int64(need_hi, need_lo), np.int64, device),
        need_active=_put(need_active, bool, device),
        num_gpus=_put(num_gpus, np.int32, device),
        container_active=_put(container_active, bool, device),
    )


def fused_requests_from_numpy(
    need_hi,  # int32 [T, Tc, R]
    need_lo,  # uint32 [T, Tc, R]
    need_active,  # bool [T, Tc, R]
    num_gpus,  # int32 [T, Tc]
    container_active,  # bool [T, Tc]
    device: DeviceLike = None,
) -> FusedRequests:
    """A JAX ``FusedRequests`` (split int64) as the port's."""
    device = resolve_device(device)
    return FusedRequests(
        need=_put(join_int64(need_hi, need_lo), np.int64, device),
        need_active=_put(need_active, bool, device),
        num_gpus=_put(num_gpus, np.int32, device),
        container_active=_put(container_active, bool, device),
    )


def history_tensor_from_numpy(
    values,  # int32 [M, N, W]
    valid,  # bool [M, N, W]
    device: DeviceLike = None,
):
    """A staged history (the JAX ``HistoryTensor``'s ``values`` and
    ``valid``) as the ``(values, valid)`` tensors ``ops/forecast.forecast_fit``
    takes."""
    device = resolve_device(device)
    return _put(values, np.int32, device), _put(valid, bool, device)


def forecast_result_from_numpy(
    level,  # int32 [M, N]
    trend,  # int32 [M, N]
    resid,  # int32 [M, N]
    predicted,  # int32 [M, N]
    band,  # int32 [M, N]
    samples,  # int32 [M, N]
    device: DeviceLike = None,
) -> ForecastResult:
    """A JAX ``ForecastResult`` (six int32 arrays, in field order) as the
    port's."""
    device = resolve_device(device)
    return ForecastResult(*(_put(part, np.int32, device) for part in (level, trend, resid, predicted, band, samples)))
