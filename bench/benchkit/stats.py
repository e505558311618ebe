"""Statistics of one run and of a set of runs.

A percentile is taken over every request the window completed, a rate
over all the work and all the time of the window, and the spread of a
set of runs is the distance between the first and the third quartile
(`statistics.quantiles`, n=4) as a share of the median.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile (1..99) of ``values``, interpolated
    between order statistics (`statistics.quantiles`, inclusive)."""
    vals = list(values)
    if not vals:
        raise ValueError("no values")
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[q - 1])


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median of a set of runs."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med


def spread_without_farthest(values: Sequence[float]) -> float:
    """The spread once the run farthest from the median is left out."""
    vals = list(values)
    med = statistics.median(vals)
    vals.remove(max(vals, key=lambda v: abs(v - med)))
    return spread(vals)


def phase_sums(spans: Iterable, lo: float = float("-inf"),
               hi: float = float("inf")) -> Dict[str, float]:
    """Seconds of the sweep pipeline's spans by phase, clipped to
    ``[lo, hi)`` on the tracer's clock: ``compile_grid`` spans, host prep
    (``prep[...]``) and device simulation (``sim[...]``, which ends in a
    copy to the host and so covers execution)."""
    out = {"compile_s": 0.0, "host_prep_s": 0.0, "device_s": 0.0}
    for s in spans:
        dur = max(0.0, min(s.start + s.dur, hi) - max(s.start, lo))
        if s.name == "compile_grid":
            out["compile_s"] += dur
        elif s.name.startswith("prep["):
            out["host_prep_s"] += dur
        elif s.name.startswith("sim["):
            out["device_s"] += dur
    return out
