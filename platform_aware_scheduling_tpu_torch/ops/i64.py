"""Exact int64 ordering helpers on native ``torch.int64``.

The JAX package keeps int64 as a ``(hi: int32, lo: uint32)`` pair because
the TPU has no fast 64-bit integers (``platform_aware_scheduling_tpu/ops/
i64.py``).  The GPU compares int64 natively, so inside the port a value is
one ``torch.int64`` element.  The split survives only in
:func:`split_int64` / :func:`join_int64`, which carry the JAX package's
arrays across (``convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


def flip(a: torch.Tensor) -> torch.Tensor:
    """Bitwise complement: an order-*reversing* bijection on int64, so the
    largest ``flip(x)`` is the smallest ``x`` (``~x == -x - 1``, no
    overflow at either end)."""
    return torch.bitwise_not(a)


def cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise sign(a - b) in {-1, 0, 1} as int32, without the
    overflow a subtraction would hit at the ends of the range."""
    return (a > b).to(torch.int32) - (a < b).to(torch.int32)


def split_int64(values) -> Tuple[np.ndarray, np.ndarray]:
    """numpy int64 -> (hi int32 = v >> 32, lo uint32 = v & 0xffffffff)."""
    arr = np.asarray(values, dtype=np.int64)
    return (arr >> np.int64(32)).astype(np.int32), (
        arr & np.int64(0xFFFFFFFF)
    ).astype(np.uint32)


def join_int64(hi, lo) -> np.ndarray:
    """Exact inverse of :func:`split_int64`."""
    hi64 = np.asarray(hi).astype(np.int32).astype(np.int64)
    lo64 = np.asarray(lo).astype(np.uint32).astype(np.int64)
    return (hi64 << np.int64(32)) | lo64
