"""Lightweight span tracer for the data-plane hot paths.

A span is one timed region — ``with TRACER.span("consumer.fetch",
cat="read"): ...`` — recorded into a bounded ring buffer with monotonic
timestamps. The tracer is **disabled by default** and, when disabled,
``span()`` returns a shared no-op context manager: the hot paths (commit
protocol, ranged reads, prefetch) pay one attribute load and one call, which
keeps the fig12 overhead budget (<5%) honest even with instrumentation
compiled in everywhere.

Two export surfaces:

  * ``chrome_trace()`` — Chrome-trace-format event list (``ph: "X"``
    complete events, microsecond timestamps) that loads directly into
    Perfetto / ``chrome://tracing``.
  * ``stall_report()`` — plain-text attribution: per-category and per-name
    totals, and the headline split the paper's fig5/fig12 arguments turn
    on — how much wall time went to data-plane waits vs compute.

Span taxonomy (catalog in docs/OBSERVABILITY.md): categories are ``commit``,
``read``, ``prefetch``, ``derive``, ``checkpoint``, ``compute``; names are
``<component>.<phase>`` (e.g. ``commit.cput``, ``consumer.footer``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.core.stats import percentiles

__all__ = ["Span", "Tracer", "TRACER", "enable_tracing", "disable_tracing",
           "trace_span"]

#: default ring-buffer capacity (spans; oldest evicted first)
DEFAULT_CAPACITY = 8192

#: categories counted as data-plane wait in the stall report; everything
#: except ``compute`` is time the trainer could not spend on the model
COMPUTE_CAT = "compute"


class Span:
    """One completed timed region (seconds, monotonic origin)."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "args")

    def __init__(self, name: str, cat: str, t0: float, dur: float, tid: int,
                 args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.args = args

    def __repr__(self) -> str:
        return f"Span({self.name!r}, cat={self.cat!r}, dur={self.dur:.6f})"


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager that records one span on exit (exceptions included —
    a failed cput is exactly the span you want to see)."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._record(self.name, self.cat, self.t0,
                             time.perf_counter() - self.t0, self.args)
        return False


class Tracer:
    """Bounded-ring span recorder with Chrome-trace and stall-report export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._ring: "deque[Span]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}  # thread ident -> small stable id

    # -- recording ---------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one region. Free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args or None)

    def _record(self, name: str, cat: str, t0: float, dur: float,
                args: Optional[dict]) -> None:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            self._ring.append(Span(name, cat, t0, dur, tid, args))

    # -- read surface ------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- exports -----------------------------------------------------------
    def chrome_trace(self) -> List[dict]:
        """Chrome-trace-format complete events (load in Perfetto)."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            ev = {
                "name": s.name,
                "cat": s.cat or "default",
                "ph": "X",
                "ts": s.t0 * 1e6,      # Chrome trace wants microseconds
                "dur": s.dur * 1e6,
                "pid": pid,
                "tid": s.tid,
            }
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        return events

    def write_chrome_trace(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; returns the event count."""
        events = self.chrome_trace()
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)

    def stall_report(self) -> str:
        """Plain-text attribution report: where did the wall time go?

        Groups spans by name (count, total, p50/p95) and closes with the
        data-plane-wait vs compute split. Concurrent spans are summed per
        span, not deduplicated — the report attributes *work*, not
        wall-clock occupancy.
        """
        spans = self.spans()
        if not spans:
            return "no spans recorded (is tracing enabled?)\n"
        by_name: Dict[str, List[Span]] = {}
        by_cat: Dict[str, float] = {}
        for s in spans:
            by_name.setdefault(s.name, []).append(s)
            cat = s.cat or "default"
            by_cat[cat] = by_cat.get(cat, 0.0) + s.dur
        lines = [f"{'span':<28} {'count':>7} {'total_ms':>10} "
                 f"{'p50_ms':>9} {'p95_ms':>9}"]
        for name in sorted(by_name,
                           key=lambda n: -sum(s.dur for s in by_name[n])):
            ss = by_name[name]
            ps = percentiles([s.dur for s in ss], (50.0, 95.0))
            lines.append(f"{name:<28} {len(ss):>7} "
                         f"{sum(s.dur for s in ss) * 1e3:>10.2f} "
                         f"{ps[50.0] * 1e3:>9.3f} {ps[95.0] * 1e3:>9.3f}")
        compute = by_cat.get(COMPUTE_CAT, 0.0)
        data = sum(t for c, t in by_cat.items() if c != COMPUTE_CAT)
        lines.append("")
        for cat in sorted(by_cat, key=by_cat.get, reverse=True):
            lines.append(f"category {cat:<18} {by_cat[cat] * 1e3:>10.2f} ms")
        total = compute + data
        if total > 0:
            lines.append(f"data-plane wait {data * 1e3:.2f} ms vs compute "
                         f"{compute * 1e3:.2f} ms "
                         f"({100.0 * data / total:.1f}% data-plane)")
        return "\n".join(lines) + "\n"


#: process-wide tracer every instrumented component uses
TRACER = Tracer()


def enable_tracing(capacity: Optional[int] = None) -> Tracer:
    """Turn on the global tracer (optionally resizing its ring)."""
    if capacity is not None:
        with TRACER._lock:
            TRACER._ring = deque(TRACER._ring, maxlen=capacity)
    return TRACER.enable()


def disable_tracing() -> Tracer:
    return TRACER.disable()


def trace_span(name: str, cat: str = "", **args):
    """Module-level shortcut: ``with trace_span("commit.cput", cat="commit")``."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _LiveSpan(TRACER, name, cat, args or None)
