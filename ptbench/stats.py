"""The percentile of the end-to-end metrics over a window's frames."""

from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile (1 <= q <= 99), interpolated between the closest
    ranks of all values."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
