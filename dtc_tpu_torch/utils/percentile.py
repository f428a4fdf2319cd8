"""Nearest-rank percentile — THE percentile definition shared by bench
rows, the trace analyzer, and the quantile-histogram parity tests.

Extracted from bench.py's private ``_pct``: three
call sites had started growing their own copies, and the registry
histogram's bucketed p50/p99 needs one exact oracle to be tested
against. Nearest-rank (no interpolation) is deliberate: for the small
samples serving benches produce (tens of requests), interpolated
percentiles manufacture values nobody measured.
"""

from __future__ import annotations

import math
from typing import Iterable


def round_opt(v: float | None, ndigits: int = 4) -> float | None:
    """Round a possibly-``None`` metric — the one rounding rule every
    percentile surface shares (the mixed-fleet reducer, the router's
    fleet summary, bench rows), so a policy change lands once."""
    return None if v is None else round(v, ndigits)


def nearest_rank(vals: Iterable[float], q: float) -> float | None:
    """Nearest-rank percentile of ``vals`` at quantile ``q`` in [0, 1].

    Returns ``None`` for an empty sample. ``q=0`` is the minimum,
    ``q=1`` the maximum; with one sample every quantile is that sample.
    The returned value is always an element of ``vals`` (never
    interpolated).
    """
    vals = sorted(vals)
    if not vals:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    # Nearest-rank: the ceil(q*n)-th smallest (1-based), clamped so q=0
    # yields the minimum instead of an out-of-range rank 0.
    rank = max(1, math.ceil(q * len(vals)))
    return vals[rank - 1]
