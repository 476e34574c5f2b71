"""Service entry points (``python -m platform_aware_scheduling_tpu_torch.cmd.tas``)."""
