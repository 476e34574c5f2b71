"""GAS pod and resource helpers.

The port's copy of ``platform_aware_scheduling_tpu/gas/utils.py``.
Reference: gpu-aware-scheduling/pkg/gpuscheduler/utils.go and the constants
of scheduler.go:24-36.
"""

from __future__ import annotations

from typing import List

from platform_aware_scheduling_tpu_torch.gas.resource_map import ResourceMap
from platform_aware_scheduling_tpu_torch.kube.objects import Pod
from platform_aware_scheduling_tpu_torch.utils.quantity import Quantity, QuantityParseError

RESOURCE_PREFIX = "gpu.intel.com/"  # utils.go:10-12
GPU_LIST_LABEL = "gpu.intel.com/cards"  # scheduler.go:29
GPU_PLUGIN_RESOURCE = "gpu.intel.com/i915"  # scheduler.go:30
TS_ANNOTATION = "gas-ts"  # scheduler.go:25
CARD_ANNOTATION = "gas-container-cards"  # scheduler.go:26


def _as_int64(raw) -> int:
    """Quantity string -> int64 with AsInt64 semantics: a non-integer or
    out-of-range value reads as 0 (the reference ignores the ok flag,
    utils.go:23-24)."""
    try:
        value, _ok = Quantity(str(raw)).as_int64()
    except QuantityParseError:
        return 0
    return value


def container_requests(pod: Pod) -> List[ResourceMap]:
    """One ResourceMap per container, holding only the ``gpu.intel.com/*``
    requests (utils.go:14-32)."""
    all_resources: List[ResourceMap] = []
    for container in pod.containers:
        rm = ResourceMap()
        requests = (container.get("resources") or {}).get("requests") or {}
        for name, raw in requests.items():
            if name.startswith(RESOURCE_PREFIX):
                rm[name] = _as_int64(raw)
        all_resources.append(rm)
    return all_resources


def has_gpu_resources(pod) -> bool:
    """True if any container requests a ``gpu.intel.com/*`` resource
    (utils.go:34-50)."""
    if pod is None:
        return False
    for container in pod.containers:
        requests = (container.get("resources") or {}).get("requests") or {}
        for name in requests:
            if name.startswith(RESOURCE_PREFIX):
                return True
    return False


def is_completed_pod(pod: Pod) -> bool:
    """Deleted, Failed and Succeeded pods are 'completed' and release their
    cards (utils.go:52-71)."""
    if pod.deletion_timestamp is not None:
        return True
    return pod.phase in ("Failed", "Succeeded")
