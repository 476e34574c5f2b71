"""The port's small counter set: named, optionally labelled counters.

Only what ``tas/cache.py`` counts (refresh passes and refresh errors by
reason).  Exposition, gauges and histograms come with the serving layers.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


class CounterSet:
    """Thread-safe monotonic counters keyed by name and label set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}

    def inc(
        self, name: str, by: float = 1, labels: Optional[Dict[str, str]] = None
    ) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0) + by

    def get(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0)
