"""Exact Kubernetes ``resource.Quantity`` arithmetic.

The reference's entire rule engine compares telemetry values as k8s
quantities: ``EvaluateRule`` dispatches on ``Quantity.CmpInt64`` and
``OrderedList`` sorts by ``Quantity.Cmp`` (reference
telemetry-aware-scheduling/pkg/strategies/core/operator.go:13-42), and GAS
reads capacities with ``Quantity.AsInt64`` (reference
gpu-aware-scheduling/pkg/gpuscheduler/scheduler.go:150-162).  This module
implements the same semantics exactly, backed by ``fractions.Fraction`` so
that comparisons are arbitrary precision, plus the scaled-integer accessors
the tensorized device path needs (``milli_value_exact``).

Grammar (k8s apimachinery/pkg/api/resource):
    <quantity>  ::= <signedNumber><suffix>
    <suffix>    ::= <binarySI> | <decimalExponent> | <decimalSI>
    <binarySI>  ::= Ki | Mi | Gi | Ti | Pi | Ei
    <decimalSI> ::= n | u | m | "" | k | M | G | T | P | E
    <decimalExponent> ::= "e"<signedNumber> | "E"<signedNumber>
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Tuple, Union

_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<int>[0-9]*)(?:\.(?P<frac>[0-9]*))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE]|[eE][+-]?[0-9]+)?$"
)
# the unsigned integers and milli-integers telemetry is written in
_PLAIN_RE = re.compile(r"([0-9]+)(m?)")


class QuantityParseError(ValueError):
    """Raised when a string is not a valid k8s quantity."""


class Quantity:
    """An exact, immutable k8s resource quantity."""

    __slots__ = ("_value", "_text", "_milli")

    def __init__(self, value: Union[str, int, float, Fraction, "Quantity"]):
        # lazily-computed milli_value_exact cache: Quantity is immutable,
        # so the Fraction scaling can run once per object instead of once
        # per telemetry pass per node (the mirror reads every value in
        # fixed-point form each refresh)
        self._milli: Union[Tuple[int, bool], None] = None
        if isinstance(value, Quantity):
            self._value = value._value
            self._text = value._text
            self._milli = value._milli
            return
        if isinstance(value, str):
            self._text = value
            # telemetry arrives as plain or milli integers ("110", "12345m"),
            # 80,000 of them a refresh at 10k nodes: build those without the
            # general grammar's Fraction arithmetic
            plain = _PLAIN_RE.fullmatch(value)
            if plain is None:
                self._value = _parse(value)
                return
            digits = int(plain.group(1))
            if plain.group(2):
                self._value = Fraction(digits, 1000)
                milli = digits
            else:
                self._value = Fraction(digits)
                milli = digits * 1000
            self._milli = (milli, True) if milli <= _INT64_MAX else (_INT64_MAX, False)
            return
        if isinstance(value, bool):
            raise QuantityParseError(f"not a quantity: {value!r}")
        if isinstance(value, int):
            self._value = Fraction(value)
            self._text = None
            return
        if isinstance(value, float):
            self._value = Fraction(value).limit_denominator(10**9)
            self._text = None
            return
        if isinstance(value, Fraction):
            self._value = value
            self._text = None
            return
        raise QuantityParseError(f"not a quantity: {value!r}")

    # -- comparisons (reference semantics: Cmp / CmpInt64) -------------------

    def cmp(self, other: Union["Quantity", int, Fraction]) -> int:
        """Three-way compare, matching Go ``Quantity.Cmp``: -1, 0, or 1."""
        ov = other._value if isinstance(other, Quantity) else Fraction(other)
        if self._value < ov:
            return -1
        if self._value > ov:
            return 1
        return 0

    def cmp_int64(self, target: int) -> int:
        """Three-way compare against an int64, matching ``Quantity.CmpInt64``."""
        return self.cmp(Fraction(target))

    # -- accessors -----------------------------------------------------------

    @property
    def value(self) -> Fraction:
        return self._value

    def as_int64(self) -> Tuple[int, bool]:
        """(value, ok) like Go ``Quantity.AsInt64``: ok only when the value is
        an integer representable in int64; otherwise ``(0, False)``.  GAS uses
        the value and ignores ok (reference gpuscheduler/utils.go:25), so a
        fractional capacity reads as 0 there, exactly as in the reference."""
        if self._value.denominator != 1:
            return 0, False
        v = self._value.numerator
        if v < _INT64_MIN or v > _INT64_MAX:
            return 0, False
        return v, True

    def as_approximate_float(self) -> float:
        return float(self._value)

    def milli_value_exact(self) -> Tuple[int, bool]:
        """(milli_value, exact): the value scaled by 1000 as an int64 plus a
        flag saying whether the scaling was lossless AND in int64 range.  The
        device-tensor mirror stores metric values in this fixed-point form;
        when ``exact`` is false for any node the host fallback path is used so
        rule evaluation stays bit-identical to the reference."""
        cached = self._milli
        if cached is not None:
            return cached
        scaled = self._value * 1000
        exact = scaled.denominator == 1
        if exact:
            v = scaled.numerator
        else:
            # round toward zero for the approximate device value
            v = int(scaled)
        if v > _INT64_MAX:
            result = (_INT64_MAX, False)
        elif v < _INT64_MIN:
            result = (_INT64_MIN, False)
        else:
            result = (v, exact)
        self._milli = result
        return result

    def as_dec(self) -> str:
        """Decimal string (used in log lines, like Go ``AsDec``)."""
        v = self._value
        if v.denominator == 1:
            return str(v.numerator)
        f = float(v)
        return repr(f)

    # -- dunder plumbing -----------------------------------------------------

    def __eq__(self, other) -> bool:
        if isinstance(other, Quantity):
            return self._value == other._value
        if isinstance(other, (int, Fraction)):
            return self._value == other
        return NotImplemented

    def __lt__(self, other) -> bool:
        ov = other._value if isinstance(other, Quantity) else Fraction(other)
        return self._value < ov

    def __hash__(self) -> int:
        return hash(self._value)

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"

    def __str__(self) -> str:
        if self._text is not None:
            return self._text
        return self.as_dec()


def _parse(text: str) -> Fraction:
    s = text.strip()
    if not s:
        raise QuantityParseError("empty quantity")
    m = _QUANTITY_RE.match(s)
    if m is None:
        raise QuantityParseError(f"invalid quantity: {text!r}")
    int_part = m.group("int") or ""
    frac_part = m.group("frac")
    if not int_part and not frac_part:
        raise QuantityParseError(f"invalid quantity: {text!r}")
    digits = int_part or "0"
    number = Fraction(int(digits))
    if frac_part:
        number += Fraction(int(frac_part or "0"), 10 ** len(frac_part))
    if m.group("sign") == "-":
        number = -number
    suffix = m.group("suffix") or ""
    if suffix in _BINARY_SUFFIXES:
        number *= _BINARY_SUFFIXES[suffix]
    elif suffix in _DECIMAL_SUFFIXES:
        number *= _DECIMAL_SUFFIXES[suffix]
    elif suffix and suffix[0] in "eE":
        exp = int(suffix[1:])
        number *= Fraction(10) ** exp
    elif suffix:
        raise QuantityParseError(f"invalid suffix in quantity: {text!r}")
    return number


def parse_quantity(text: Union[str, int, float]) -> Quantity:
    return Quantity(text)
