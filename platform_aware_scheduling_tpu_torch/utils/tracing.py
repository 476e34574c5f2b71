"""Latency histograms and counters with Prometheus text exposition.

The port's copy of ``platform_aware_scheduling_tpu/utils/tracing.py``:
every extender verb records into a :class:`LatencyRecorder`, and counters
and gauges live in a :class:`CounterSet`; both render as Prometheus text
(``# HELP``/``# TYPE``, ``_bucket``/``_sum``/``_count`` histogram series)
on ``/metrics``.  The span model and the metric-name inventory build on
these in ``utils/trace.py``.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

# bucket bounds in seconds: a doubling ladder from 100 µs to ~105 s,
# densified below 1 ms (250/500/750 µs); sorted and deduplicated by
# construction so the cumulative-bucket invariant holds
BUCKETS: List[float] = sorted(
    {0.00025, 0.0005, 0.00075} | {0.0001 * (2**i) for i in range(21)}
)


def quantile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank quantile over an ascending-sorted sample: the
    ``ceil(q * n)``-th value."""
    if not sorted_values:
        return 0.0
    rank = math.ceil(q * len(sorted_values))
    idx = min(len(sorted_values) - 1, max(0, rank - 1))
    return sorted_values[idx]


def _fmt_value(value) -> str:
    """Prometheus sample value: ints stay exact, floats go %g."""
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return f"{value:g}"


#: a family's series map: label tuple (sorted (k, v) pairs) -> value.
#: The unlabeled series uses the empty tuple.
_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted(labels.items())) if labels else ()


def _escape_label_value(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_series(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return f"{name}{{{inner}}}"


class CounterSet:
    """Thread-safe named counters and gauges with Prometheus text
    exposition.  Names are emitted verbatim (``pas_*``; the inventory is
    ``trace.METRICS``).  A family may carry labelled series — one
    ``# TYPE`` line per family, one sample line per label set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}

    def inc(self, name: str, by: float = 1, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0) + by

    def set_gauge(self, name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def get(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        kind: Optional[str] = None,
    ) -> float:
        """The exact series when ``labels`` is given, else the sum over
        every series of ``name``.  When a counter and a gauge share a name,
        ``kind`` ("counter" or "gauge") picks one; without it the counter
        wins."""
        key = None if labels is None else _label_key(labels)

        def read(table: Dict[str, Dict[_LabelKey, float]]) -> float:
            series = table.get(name, {})
            if key is not None:
                return series.get(key, 0)
            return sum(series.values()) if series else 0

        with self._lock:
            if kind == "counter":
                return read(self._counters)
            if kind == "gauge":
                return read(self._gauges)
            if kind is not None:
                raise ValueError(f"unknown kind {kind!r}")
            if name in self._counters:
                return read(self._counters)
            return read(self._gauges)

    def remove(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        kind: Optional[str] = None,
    ) -> None:
        """Drop a series (or, with ``labels=None``, the whole family) from
        future exposition."""
        key = None if labels is None else _label_key(labels)
        tables = (
            [self._counters]
            if kind == "counter"
            else [self._gauges]
            if kind == "gauge"
            else [self._counters, self._gauges]
        )
        with self._lock:
            for table in tables:
                if key is None:
                    table.pop(name, None)
                    continue
                series = table.get(name)
                if series is not None:
                    series.pop(key, None)
                    if not series:
                        del table[name]

    def prometheus_text(self, help_texts: Optional[Dict[str, str]] = None) -> str:
        """``# HELP`` (for declared names) + ``# TYPE`` per family, then one
        sample per series.  A name that is both a counter and a gauge
        emits the counter only: two TYPE lines would be invalid."""
        with self._lock:
            counters = sorted(
                (name, sorted(series.items())) for name, series in self._counters.items()
            )
            gauges = sorted(
                (name, sorted(series.items()))
                for name, series in self._gauges.items()
                if name not in self._counters
            )
        lines: List[str] = []
        for kind, families in (("counter", counters), ("gauge", gauges)):
            for name, series in families:
                if help_texts and name in help_texts:
                    lines.append(f"# HELP {name} {help_texts[name]}")
                lines.append(f"# TYPE {name} {kind}")
                for key, value in series:
                    lines.append(f"{_render_series(name, key)} {_fmt_value(value)}")
        return "\n".join(lines) + ("\n" if lines else "")


class LatencyRecorder:
    """Thread-safe per-label latency stats: histogram buckets, a bounded
    window of raw samples for exact quantiles, and the newest trace id per
    bucket (an exemplar)."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = window
        self._samples: Dict[str, Deque[float]] = {}
        self._counts: Dict[str, int] = {}
        self._sums: Dict[str, float] = {}
        self._buckets: Dict[str, List[int]] = {}
        self._exemplars: Dict[str, Dict[int, Tuple[str, float]]] = {}

    def observe(self, label: str, seconds: float, trace_id: str = "") -> None:
        with self._lock:
            if label not in self._samples:
                self._samples[label] = deque(maxlen=self._window)
                self._counts[label] = 0
                self._sums[label] = 0.0
                self._buckets[label] = [0] * (len(BUCKETS) + 1)
            self._samples[label].append(seconds)
            self._counts[label] += 1
            self._sums[label] += seconds
            for i, bound in enumerate(BUCKETS):
                if seconds <= bound:
                    self._buckets[label][i] += 1
                    break
            else:
                i = len(BUCKETS)
                self._buckets[label][-1] += 1
            if trace_id:
                self._exemplars.setdefault(label, {})[i] = (trace_id, seconds)

    def exemplars(self) -> Dict[str, Dict[int, Tuple[str, float]]]:
        with self._lock:
            return {label: dict(per_bucket) for label, per_bucket in self._exemplars.items()}

    def labels(self) -> List[str]:
        with self._lock:
            return list(self._counts)

    def summary(self, label: str) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples.get(label, ()))
            count = self._counts.get(label, 0)
            total = self._sums.get(label, 0.0)
        return {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "p50": quantile(samples, 0.50),
            "p90": quantile(samples, 0.90),
            "p99": quantile(samples, 0.99),
            "max": samples[-1] if samples else 0.0,
        }

    def snapshot(self) -> Dict[str, Tuple[List[int], int, float]]:
        """label -> (bucket counts copy, count, sum)."""
        with self._lock:
            return {
                label: (list(buckets), self._counts[label], self._sums[label])
                for label, buckets in self._buckets.items()
            }


HISTOGRAM_METRIC = "pas_request_duration_seconds"


def histograms_text(
    recorders: Iterable[LatencyRecorder],
    metric: str = HISTOGRAM_METRIC,
    help_texts: Optional[Dict[str, str]] = None,
    label_name: str = "verb",
) -> str:
    """Every recorder's labels merged under ONE histogram family with a
    single ``# TYPE`` line.  Bucket lines carry the newest trace id that
    landed there as an OpenMetrics exemplar (``... 12 # {trace_id="..."}
    0.000431``), which Prometheus' text parser ignores."""
    merged: Dict[str, Tuple[List[int], int, float]] = {}
    exemplars: Dict[str, Dict[int, Tuple[str, float]]] = {}
    for recorder in recorders:
        for label, (buckets, count, total) in recorder.snapshot().items():
            if label in merged:
                old_buckets, old_count, old_sum = merged[label]
                merged[label] = (
                    [a + b for a, b in zip(old_buckets, buckets)],
                    old_count + count,
                    old_sum + total,
                )
            else:
                merged[label] = (buckets, count, total)
        for label, per_bucket in recorder.exemplars().items():
            exemplars.setdefault(label, {}).update(per_bucket)
    if not merged:
        return ""

    def exemplar_suffix(label: str, index: int) -> str:
        entry = exemplars.get(label, {}).get(index)
        if entry is None:
            return ""
        trace_id, seconds = entry
        return f' # {{trace_id="{_escape_label_value(trace_id)}"}} {seconds:.9f}'

    help_text = (help_texts or {}).get(metric)
    lines: List[str] = []
    if help_text:
        lines.append(f"# HELP {metric} {help_text}")
    lines.append(f"# TYPE {metric} histogram")
    for label in sorted(merged):
        buckets, count, total = merged[label]
        cumulative = 0
        for i, (bound, n) in enumerate(zip(BUCKETS, buckets)):
            cumulative += n
            lines.append(
                f'{metric}_bucket{{{label_name}="{label}",le="{bound:g}"}} '
                f"{cumulative}{exemplar_suffix(label, i)}"
            )
        cumulative += buckets[-1]
        lines.append(
            f'{metric}_bucket{{{label_name}="{label}",le="+Inf"}} '
            f"{cumulative}{exemplar_suffix(label, len(BUCKETS))}"
        )
        lines.append(f'{metric}_sum{{{label_name}="{label}"}} {total:.9f}')
        lines.append(f'{metric}_count{{{label_name}="{label}"}} {count}')
    return "\n".join(lines) + "\n"
