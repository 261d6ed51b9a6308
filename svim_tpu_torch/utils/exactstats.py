"""Bit-identical fast ``statistics.stdev`` for the consolidation hot path.

Cluster consolidation computes ``statistics.stdev`` twice per cluster
(reference: SVIM_clustering.py:223-227) — with thousands of clusters this is
a real cost because ``statistics._ss`` builds per-element exact ratios.  The
inputs here are always integers (spans) or exact half-integers (centers
``(start + end) / 2``), so the exact sum of squared deviations reduces to
plain Python big-int arithmetic:

    ss = (n * Σx² - (Σx)²) / n          (statistics._ss's own formula)
    stdev = sqrt(ss / (n - 1))

``statistics.stdev`` converts the exact Fraction through
``_float_sqrt_of_frac`` (correctly-rounded rational square root); calling the
same helper on the integer-derived numerator/denominator yields the identical
float.  A pinned differential test (tests/test_exactstats.py) fuzzes this
against ``statistics.stdev``; when the private helper is missing the public
function is used directly.
"""

from __future__ import annotations

from fractions import Fraction
from statistics import stdev as _stdev

try:
    from statistics import _float_sqrt_of_frac
except ImportError:  # pragma: no cover - future-python fallback
    _float_sqrt_of_frac = None


def stdev_ints(values) -> float:
    """``statistics.stdev(values)`` for a sequence of Python ints."""
    if _float_sqrt_of_frac is None:
        return _stdev(values)
    n = len(values)
    total = 0
    total_sq = 0
    for value in values:
        total += value
        total_sq += value * value
    mss = Fraction(n * total_sq - total * total, n * (n - 1))
    return _float_sqrt_of_frac(mss.numerator, mss.denominator)


def stdev_half_ints(doubled_values) -> float:
    """``statistics.stdev`` of values k/2, given the integer doubles k.

    Exact: each float k/2 is exactly representable, so statistics' own exact
    ratios give ss = (n·Σk² - (Σk)²)/(4n) — the same Fraction this computes
    from integer arithmetic."""
    if _float_sqrt_of_frac is None:
        return _stdev([value / 2 for value in doubled_values])
    n = len(doubled_values)
    total = 0
    total_sq = 0
    for value in doubled_values:
        total += value
        total_sq += value * value
    mss = Fraction(n * total_sq - total * total, 4 * n * (n - 1))
    return _float_sqrt_of_frac(mss.numerator, mss.denominator)
