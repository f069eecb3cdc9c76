"""Statistics the harness and its tools share."""

from __future__ import annotations

import statistics


def spread(values) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and reach < hi:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        out.append((reach, hi))
    return out
