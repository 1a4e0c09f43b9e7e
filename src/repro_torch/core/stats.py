"""Bounded metric accumulators shared by consumer clients and baselines.

Per-step latency lists previously grew one float per step for the life of the
run — unbounded on a production trainer. ``LatencyWindow`` keeps a fixed-size
tail (recent samples, enough for percentile estimates) plus an exact running
count/sum, so long-run throughput math stays exact while memory stays O(1).

It iterates like the list it replaces (``sorted(w)``, ``len(w)``,
``list(w)``), so existing percentile helpers keep working unchanged.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator, Sequence

__all__ = ["LatencyWindow", "percentile", "percentiles"]


def percentile(xs: Iterable[float], p: float) -> float:
    """Nearest-rank percentile (``p`` in [0, 100]) over any sample iterable.

    The single shared implementation for every p50/p95/p99 in the repo —
    benchmarks, baselines, and registry histograms all call this, so figures
    stay comparable across backends. NaN on an empty sample set (plots skip
    it) rather than raising: stats surfaces are read mid-run, often before
    the first sample lands.
    """
    xs = sorted(xs)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, int(p / 100.0 * len(xs)))
    return xs[i]


def percentiles(xs: Iterable[float],
                ps: Sequence[float] = (50.0, 95.0, 99.0),
                ) -> Dict[float, float]:
    """Several nearest-rank percentiles over one sort of the samples."""
    xs = sorted(xs)
    out: Dict[float, float] = {}
    for p in ps:
        if not xs:
            out[p] = float("nan")
        else:
            out[p] = xs[min(len(xs) - 1, int(p / 100.0 * len(xs)))]
    return out


class LatencyWindow:
    """Fixed-size sample tail + exact running count/sum."""

    __slots__ = ("_tail", "count", "total")

    def __init__(self, maxlen: int = 1024, samples: Iterable[float] = ()):
        self._tail: "deque[float]" = deque(maxlen=maxlen)
        self.count = 0      # exact number of samples ever recorded
        self.total = 0.0    # exact sum of all samples ever recorded
        self.extend(samples)

    @property
    def maxlen(self) -> int:
        return self._tail.maxlen

    def append(self, x: float) -> None:
        self._tail.append(x)
        self.count += 1
        self.total += x

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.append(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    # -- list-compatible read surface (tail only) ---------------------------
    def __len__(self) -> int:
        return len(self._tail)

    def __iter__(self) -> Iterator[float]:
        return iter(self._tail)

    def __bool__(self) -> bool:
        return bool(self._tail)

    def __repr__(self) -> str:
        return (f"LatencyWindow(count={self.count}, mean={self.mean:.6f}, "
                f"tail={len(self._tail)}/{self.maxlen})")
