"""The benchmark's clock and small statistics: every time is
``time.perf_counter`` seconds (the engine's tracer is given the same
clock, so its events and the client's times share one axis)."""
from __future__ import annotations

import math
import time

now = time.perf_counter


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all values, linear between the
    two nearest ranks (numpy's default), over every sample given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
