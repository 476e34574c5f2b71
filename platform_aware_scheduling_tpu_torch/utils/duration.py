"""Go-style duration parsing (``time.ParseDuration`` equivalent).

The port's copy of ``platform_aware_scheduling_tpu/utils/duration.py``.
The service parses its ``--syncPeriod`` and retry flags with it: a signed
sequence of decimal numbers with optional fraction and a unit suffix from
ns/us/µs/ms/s/m/h, e.g. "2s", "1.5h", "300ms".  Returns seconds as a
float.
"""

from __future__ import annotations

import re

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "μs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_PART_RE = re.compile(r"([0-9]*\.?[0-9]+)(ns|us|µs|μs|ms|s|m|h)")


class DurationParseError(ValueError):
    pass


def parse_duration(text: str) -> float:
    s = text.strip()
    if not s:
        raise DurationParseError("empty duration")
    sign = 1.0
    if s[0] in "+-":
        if s[0] == "-":
            sign = -1.0
        s = s[1:]
    if s == "0":
        return 0.0
    total = 0.0
    pos = 0
    for m in _PART_RE.finditer(s):
        if m.start() != pos:
            raise DurationParseError(f"invalid duration: {text!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise DurationParseError(f"invalid duration: {text!r}")
    return sign * total
