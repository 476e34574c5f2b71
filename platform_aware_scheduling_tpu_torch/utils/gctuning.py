"""Latency-service GC posture for the extender process.

The port's copy of ``platform_aware_scheduling_tpu/utils/gctuning.py``.
Request handling allocates bulk bytes (parsed bodies, response buffers)
but creates no reference cycles, so CPython's default generational
thresholds only add tail latency: every young-generation collection
scans the module graph for garbage that refcounting reclaims anyway.
The service main applies the usual tuning once, after the informers'
initial lists are in: freeze the warmed start-up heap out of collection
and raise the generation-0 threshold.
"""

from __future__ import annotations

import gc

from platform_aware_scheduling_tpu_torch.utils import klog


def tune_for_serving() -> None:
    """Apply the serving GC posture."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(100_000, 50, 50)
    klog.v(2).info_s(
        "GC tuned for serving (startup heap frozen, gen0 threshold 100k)", component="extender"
    )
