"""Clock abstraction so the data plane can run on real or virtual time.

Benchmarks run on real (optionally scaled) time; deterministic unit tests use
``VirtualClock`` so latency-model sleeps advance instantly.
"""
from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Wall-clock time, optionally scaled (scale=0.1 -> sleeps are 10x shorter).

    ``now()`` is always unscaled wall time; only sleeps are scaled. This keeps
    benchmark wall-time bounded while preserving the *relative* dynamics of the
    latency model (every sleep shrinks by the same factor).
    """

    def __init__(self, sleep_scale: float = 1.0):
        self.sleep_scale = sleep_scale

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds * self.sleep_scale)


class VirtualClock(Clock):
    """Thread-safe virtual time: ``sleep`` advances the clock without blocking.

    Suitable for single-threaded protocol tests and hypothesis properties where
    we want the latency model's arithmetic without wall-clock cost.
    """

    def __init__(self, start: float = 0.0):
        self._t = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        if seconds < 0:
            seconds = 0.0
        with self._lock:
            self._t += seconds

    def advance(self, seconds: float) -> None:
        self.sleep(seconds)
