"""The benchmark's arithmetic on samples, frozen with it."""

from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    the two closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> float:
    """``amount`` over ``seconds``: a window's work over its wall time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return amount / seconds

