"""Arithmetic of the end-to-end metrics over a whole window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value, linearly interpolated between
    the two nearest ranks (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work completed over the whole window, per second of the window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds
