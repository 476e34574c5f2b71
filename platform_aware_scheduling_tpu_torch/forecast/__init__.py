"""Predictive telemetry: schedule on trajectories, not snapshots.

The port's counterpart of ``platform_aware_scheduling_tpu/forecast``."""

from platform_aware_scheduling_tpu_torch.forecast.engine import Forecaster

__all__ = ["Forecaster"]
