"""Int64 resource vectors with overflow-safe transactional arithmetic.

The port's copy of ``platform_aware_scheduling_tpu/gas/resource_map.py``.
Reference: gpu-aware-scheduling/pkg/gpuscheduler/resource_map.go.  Semantics
reproduced exactly: ``add`` rejects negative inputs and detects int64
overflow (:77-98); ``subtract`` clamps at zero with a warning and errors on
missing keys (:103-127); ``divide`` floor-divides every entry (:129-145);
``add_rm``/``subtract_rm`` are transactional — they mutate only if every key
succeeds on a scratch copy (:38-73).

Python ints are unbounded, so int64 overflow is checked explicitly against
INT64_MAX — values beyond it must fail exactly like the Go wraparound check.
"""

from __future__ import annotations

from typing import Dict

from platform_aware_scheduling_tpu_torch.utils import klog

INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)


class ResourceMapError(ValueError):
    pass


class OverflowError64(ResourceMapError):
    """integer overflow (reference resource_map.go:15)"""


class InputError(ResourceMapError):
    """input error (reference resource_map.go:16)"""


class ResourceMap(Dict[str, int]):
    """name -> amount (reference resource_map.go:20)."""

    def new_copy(self) -> "ResourceMap":
        return ResourceMap(self)

    def copy_from(self, src: "ResourceMap") -> None:
        self.update(src)

    def add(self, key: str, value: int) -> None:
        """Add one resource amount; negative input or int64 overflow raise
        without mutating (resource_map.go:77-98)."""
        if value < 0:
            klog.error("bad input for add, key: %s", key)
            raise InputError("input error")
        if key in self:
            value += self[key]
            # the Go check is post-wraparound (value < 0); with unbounded
            # ints the equivalent is exceeding the int64 range
            if value > INT64_MAX:
                klog.error("overflow during add, key: %s", key)
                raise OverflowError64("integer overflow")
        self[key] = value

    def subtract(self, key: str, value: int) -> None:
        """Subtract one resource amount; clamps at zero, errors on missing
        key or negative input (resource_map.go:103-127)."""
        if value < 0:
            klog.error("bad input for subtract, key: %s", key)
            raise InputError("input error")
        if key not in self:
            klog.error("subtract attempted with non-existing key: %s", key)
            raise InputError("input error")
        result = self[key] - value
        if result < 0:
            klog.warning(
                "resource value for %s ended negative, capped to zero", key
            )
            result = 0
        self[key] = result

    def add_rm(self, src: "ResourceMap") -> None:
        """All-or-nothing add of another map (resource_map.go:38-53)."""
        scratch = self.new_copy()
        for key, value in src.items():
            scratch.add(key, value)
        self.copy_from(scratch)

    def subtract_rm(self, src: "ResourceMap") -> None:
        """All-or-nothing subtract of another map (resource_map.go:58-73)."""
        scratch = self.new_copy()
        for key, value in src.items():
            scratch.subtract(key, value)
        self.copy_from(scratch)

    def divide(self, divider: int) -> None:
        """Floor-divide every entry (resource_map.go:129-145)."""
        if divider < 1:
            klog.error("bad divider")
            raise InputError("input error")
        if divider == 1:
            return
        for key in self:
            v = self[key]
            # Go division truncates toward zero; // floors — differs on
            # negatives, which can't normally occur but cost nothing to match
            self[key] = -((-v) // divider) if v < 0 else v // divider


NodeResources = Dict[str, ResourceMap]  # card name -> used resources


def deep_copy_node_resources(src: NodeResources) -> NodeResources:
    return {card: rm.new_copy() for card, rm in src.items()}
