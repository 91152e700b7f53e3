"""Aggregation functions for Dataset.groupby / global aggregates.

Analog of the reference's python/ray/data/aggregate.py: AggregateFn with
init/accumulate/merge/finalize, plus the standard Count/Sum/Min/Max/Mean/Std.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


class AggregateFn:
    def __init__(self, init: Callable[[Any], Any],
                 accumulate_block: Callable[[Any, Any], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Callable[[Any], Any] = lambda a: a,
                 name: str = "agg"):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize
        self.name = name


def _col(batch, on):
    if on is None:
        # first column
        key = next(iter(batch))
        return batch[key]
    return batch[on]


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda k: 0,
            accumulate_block=lambda a, batch: a + len(_col(batch, None)),
            merge=lambda a, b: a + b,
            name="count()")


class Sum(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda k: 0,
            accumulate_block=lambda a, batch: a + float(np.sum(_col(batch, on))),
            merge=lambda a, b: a + b,
            name=f"sum({on or ''})")


class Min(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda k: None,
            accumulate_block=lambda a, batch: (
                float(np.min(_col(batch, on))) if a is None
                else min(a, float(np.min(_col(batch, on))))),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            name=f"min({on or ''})")


class Max(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda k: None,
            accumulate_block=lambda a, batch: (
                float(np.max(_col(batch, on))) if a is None
                else max(a, float(np.max(_col(batch, on))))),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"max({on or ''})")


class Mean(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda k: [0.0, 0],
            accumulate_block=lambda a, batch: [
                a[0] + float(np.sum(_col(batch, on))),
                a[1] + len(_col(batch, on))],
            merge=lambda a, b: [a[0] + b[0], a[1] + b[1]],
            finalize=lambda a: a[0] / a[1] if a[1] else None,
            name=f"mean({on or ''})")


class Std(AggregateFn):
    """Streaming variance via sum / sum-of-squares / count."""

    def __init__(self, on: Optional[str] = None, ddof: int = 1):
        def finalize(a):
            s, ss, n = a
            if n <= ddof:
                return None
            var = (ss - s * s / n) / (n - ddof)
            return float(np.sqrt(max(var, 0.0)))

        super().__init__(
            init=lambda k: [0.0, 0.0, 0],
            accumulate_block=lambda a, batch: [
                a[0] + float(np.sum(_col(batch, on))),
                a[1] + float(np.sum(np.square(np.asarray(_col(batch, on),
                                                         dtype=float)))),
                a[2] + len(_col(batch, on))],
            merge=lambda a, b: [a[0] + b[0], a[1] + b[1], a[2] + b[2]],
            finalize=finalize,
            name=f"std({on or ''})")
