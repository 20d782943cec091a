"""The benchmark's arithmetic: percentiles, quartile spreads and the union
of device intervals. Plain Python, so the CPU tests check it by hand."""

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all ``values``, linearly interpolated
    between the two nearest ranks (numpy's default): rank ``q / 100 *
    (n - 1)`` of the sorted values."""
    if not values:
        raise ValueError("no values to take a percentile of")
    ordered = sorted(values)
    rank = q / 100.0 * (len(ordered) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (rank - lo)


def quartile_spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted intervals that cover exactly what ``intervals``
    cover (touching intervals merge)."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def clip(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """Each interval cut to ``[lo, hi]``; empty ones dropped."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length that the union of ``intervals`` covers."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        out.append((cursor, hi))
    return out
