"""The port's device rule: entry points run on the GPU unless told not to."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    With no device given and no GPU present this raises instead of
    running on the CPU: a caller that wants the CPU (the tests) says so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """``cuda`` and ``cuda:0`` name the same card when 0 is current."""
    if b is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current
    )
