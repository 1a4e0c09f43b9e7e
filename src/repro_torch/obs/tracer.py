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

Span taxonomy (the data plane's catalog is docs/OBSERVABILITY.md; the
port's own spans are listed below): categories are ``commit``,
``read``, ``prefetch``, ``derive``, ``checkpoint``, ``compute``; names are
``<component>.<phase>`` (e.g. ``commit.cput``, ``consumer.footer``).

Each span records the id of the span open on its thread when it began
(``parent``). A span that opens on a thread with none open while that
thread runs an autograd backward (the engine's device thread running a
rematerialized forward on CUDA) hangs under the innermost device span still
open, which is the trainer's ``train.backward``.

A span opened with ``device=True`` also times the device: while CUDA is
there it records a ``torch.cuda.Event`` pair on the current stream, and it
opens ``torch.profiler.record_function(name)`` so a profiler trace shows the
same names. Its ``device_s`` and any 0-d tensors among its args are read
only when spans are read or exported (``spans()``), never at span exit, so
the traced code takes no host sync. Host ``t0`` / ``dur`` stay on
``time.perf_counter``. Torch is imported only inside a live device span:
the data plane's writer runs before torch loads.

Spans of the port beside the data plane's:

  ===================  =======  ==============================================
  name                 cat      region (args)
  ===================  =======  ==============================================
  ``consumer.get``     read     one object-store GET of the read path: footer,
                                slice or vectored, direct or prefetch, timed
                                at the consumer's call into the store, so a
                                resilient store's retries, hedges and
                                governor waits are inside (``bytes``); the
                                always-on histogram
                                ``consumer.<instance>.get_latencies`` holds
                                the same latencies in seconds
  ``train.step``       compute  device span: one ``make_train_step`` call
  ``train.forward``    compute  device span: ``loss_fn`` of one microbatch
  ``train.backward``   compute  device span: the grads (a remat's recompute
                                inside), their cast to fp32 or accumulation
  ``train.optimizer``  compute  device span: ``adamw_update``, the global norm
                                included
  ``moe.dispatch``     compute  device span: router, top-k, ``plan``,
                                dispatch, gather back, combine (``choices`` =
                                T·K, ``kept`` = the choices within capacity,
                                ``slots`` = E·cap; ``choices − kept`` are the
                                dropped choices)
  ``moe.experts``      compute  device span inside ``moe.dispatch``: the
                                expert bmms
  ``wkv6.forward``     compute  device span: one WKV6 forward, K4 on CUDA
                                (``tokens`` = B·S, ``heads``, ``chunk``);
                                under per-layer remat twice a layer, in the
                                forward and in the recompute inside
                                ``train.backward``
  ``wkv6.backward``    compute  device span: WKV6's backward, K4's backward
                                kernel on CUDA, the vjp of the chunked plain
                                form elsewhere (same args, and
                                ``kernel_tokens``: the B·S the kernel took,
                                0 where the plain rule ran)
  ===================  =======  ==============================================

On CUDA, ``FusedTrainLoop`` also writes ``host_syncs`` into each
``pipeline.compute`` span's args while the tracer is enabled: the syncs
torch's sync debug mode reports for the step on the trainer's thread (a
lower bound: torch says the mode does not yet see every synchronizing
operation).
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.stats import percentiles

__all__ = ["Span", "Tracer", "TRACER", "enable_tracing", "disable_tracing",
           "trace_span"]

#: default ring-buffer capacity (spans; oldest evicted first)
DEFAULT_CAPACITY = 8192

#: categories counted as data-plane wait in the stall report; everything
#: except ``compute`` is time the trainer could not spend on the model
COMPUTE_CAT = "compute"


class Span:
    """One completed timed region (seconds, monotonic origin).

    ``id`` / ``parent`` link it to the span that was open when it began
    (``parent`` None: a root). ``device_s`` is the device time between its
    CUDA events, None for a host span or where there is no CUDA."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "args", "id", "parent",
                 "device_s", "_events", "_tensors")

    def __init__(self, name: str, cat: str, t0: float, dur: float, tid: int,
                 args: Optional[dict], id: int = 0,
                 parent: Optional[int] = None, events: Optional[Tuple] = None):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.args = args
        self.id = id
        self.parent = parent
        self.device_s: Optional[float] = None
        self._events = events                  # (start, end) CUDA events
        self._tensors = bool(args) and any(_is_tensor(v) for v in args.values())

    def _resolve(self) -> None:
        """Read the device: the events' elapsed time, and 0-d tensor args as
        Python numbers (this waits for the events, so only at read time)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_s = start.elapsed_time(end) / 1e3
            self._events = None
        if self._tensors:
            self.args = {k: v.item() if _is_tensor(v) else v
                         for k, v in self.args.items()}
            self._tensors = False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, cat={self.cat!r}, dur={self.dur:.6f})"


def _is_tensor(v) -> bool:
    """A 0-d tensor arg (duck-typed: no torch import here)."""
    return getattr(v, "ndim", None) == 0 and hasattr(v, "item") \
        and hasattr(v, "device")


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager that records one span on exit (exceptions included —
    a failed cput is exactly the span you want to see)."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "id", "parent",
                 "device", "_start", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict], device: bool = False):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.device = device
        self._start = self._range = None

    def annotate(self, **args) -> None:
        """Add args known only inside the span (a byte count, a device
        tensor to read later)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self):
        tracer = self._tracer
        tracer._open(self)
        if self.device:
            import torch
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if tracer._cuda(torch):
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        events = None
        if self._start is not None:
            import torch
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self._start, end)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._tracer._close(self)
        self._tracer._record(self, dur, events)
        return False


class Tracer:
    """Bounded-ring span recorder with Chrome-trace and stall-report export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._ring: "deque[Span]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}  # thread ident -> small stable id
        self._ids = itertools.count(1)
        self._local = threading.local()  # .stack: this thread's open spans
        self._open_device: List[_LiveSpan] = []  # open device spans, in order
        self._has_cuda: Optional[bool] = None

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

    def span(self, name: str, cat: str = "", device: bool = False, **args):
        """Context manager timing one region (``device``: its device time
        too). Free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args or None, device)

    def _cuda(self, torch) -> bool:
        if self._has_cuda is None:
            self._has_cuda = torch.cuda.is_available()
        return self._has_cuda

    def _open(self, span: _LiveSpan) -> None:
        """Give a span opening on this thread its id and parent."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        span.parent = stack[-1].id if stack else self._adoptive_parent()
        span.id = next(self._ids)
        stack.append(span)
        if span.device:
            with self._lock:
                self._open_device.append(span)

    def _adoptive_parent(self) -> Optional[int]:
        """The parent of a span opening with nothing open on its thread: on
        a thread running an autograd backward, the innermost device span
        open elsewhere (the backward's caller blocks inside it)."""
        torch = sys.modules.get("torch")
        if torch is None or torch._C._current_graph_task_id() == -1:
            return None
        with self._lock:
            return self._open_device[-1].id if self._open_device else None

    def _close(self, span: _LiveSpan) -> None:
        stack = getattr(self._local, "stack", [])
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
        if span.device:
            with self._lock:
                if span in self._open_device:
                    self._open_device.remove(span)

    def _record(self, span: _LiveSpan, dur: float,
                events: Optional[Tuple]) -> None:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            self._ring.append(Span(span.name, span.cat, span.t0, dur, tid,
                                   span.args, span.id, span.parent,
                                   events=events))

    # -- read surface ------------------------------------------------------
    def spans(self) -> List[Span]:
        """The recorded spans, oldest first, their device times and device
        args read (this waits for the device where one is pending)."""
        with self._lock:
            out = list(self._ring)
        for s in out:
            if s._events is not None or s._tensors:
                s._resolve()
        return out

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
            if s.device_s is not None:
                ev["args"] = {**(s.args or {}), "device_ms": s.device_s * 1e3}
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
        data-plane-wait vs compute split. The split counts each span's self
        time (its duration less the part its child spans cover), so a span
        nested in another (``train.*`` in ``pipeline.compute``,
        ``consumer.get`` in ``consumer.fetch``) is counted once. Concurrent
        spans are summed per span, not deduplicated — the report attributes
        *work*, not wall-clock occupancy.
        """
        spans = self.spans()
        if not spans:
            return "no spans recorded (is tracing enabled?)\n"
        by_name: Dict[str, List[Span]] = {}
        by_cat: Dict[str, float] = {}
        for s, self_s in zip(spans, self_times(spans)):
            by_name.setdefault(s.name, []).append(s)
            cat = s.cat or "default"
            by_cat[cat] = by_cat.get(cat, 0.0) + self_s
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


def self_times(spans: List[Span]) -> List[float]:
    """Each span's duration less the union of its children's intervals
    clipped to its own (children found by ``parent``)."""
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.t0, s.t0 + s.dur))
    out = []
    for s in spans:
        lo, hi = s.t0, s.t0 + s.dur
        covered, end = 0.0, lo
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, end), min(b, hi)
            if b > a:
                covered += b - a
                end = b
        out.append(s.dur - covered)
    return out


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


def trace_span(name: str, cat: str = "", device: bool = False, **args):
    """Module-level shortcut: ``with trace_span("commit.cput", cat="commit")``
    (``device=True``: the region's device time too)."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _LiveSpan(TRACER, name, cat, args or None, device)
