"""The traced slices of a window: ``torch.profiler`` over a few steps, read
back from its Chrome trace.

Two slices: the first records no input shapes, so the profiler adds as
little host work as it can to the steps whose device time and idle gaps it
reads; the second records the host operators' input shapes too, for the
kernel metrics' attribution by operator (a kernel's device time does not
depend on the host's pace): the calls of every ``repro_torch::`` operator
are collected once the slice has closed.

The profiler drops the first device events of each session, more as the
process ages, so each slice opens with ``MARKERS`` spin kernels that are
waited for before the steps: the events lost are theirs, and a slice in
which none of them is seen fails. One more spin kernel, launched at a known
``time.perf_counter`` instant on an idle device, ties the trace's clock to
the host's, so the program's host spans (``obs.tracer``) label the
device's idle gaps.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

MARKERS = 256
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LABEL_SPANS = ("pipeline.data_wait", "pipeline.compute", "pipeline.h2d")


class TracedSlice:
    """``with TracedSlice(torch, ops) as s:`` profiles what runs inside,
    after the markers (``ops``: host operators and shapes too);
    ``s.events()`` reads the trace once the block is left."""

    def __init__(self, torch, ops: bool = False):
        self.torch, self.ops = torch, ops
        self.prof = None
        self.t_clock = None

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        # device activity alone gives every device event a zero timestamp on
        # the card's machine (torch 2.11, CUPTI 26): host activity is on in both
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=self.ops)
        self.prof.__enter__()
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.t_clock = time.perf_counter()
        torch.cuda._sleep(1)      # the clock kernel: the last spin kernel
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        # export now: once a later session has run, this one's device events
        # read back with zero timestamps (torch 2.11 on the card's machine)
        fd, self.path = tempfile.mkstemp(suffix=".json", prefix="weavebench-trace-")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        return False

    def events(self) -> List[dict]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        finally:
            os.unlink(self.path)
        return data["traceEvents"] if isinstance(data, dict) else data


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _outermost(events: List[dict]) -> List[dict]:
    """Drop events nested in another of the same list on the same thread."""
    out: List[dict] = []
    for e in sorted(events, key=lambda e: (e.get("tid"), e["ts"], -e.get("dur", 0))):
        if out and out[-1].get("tid") == e.get("tid") and \
                e["ts"] + e.get("dur", 0) <= out[-1]["ts"] + out[-1].get("dur", 0):
            continue
        out.append(e)
    return out


def summarize(events: List[dict], t_clock: float, host_lo: float, host_hi: float,
              spans=(), ops: str = "") -> dict:
    """Read a slice's trace over the host interval [host_lo, host_hi]
    (``perf_counter`` seconds): the device's busy and window seconds, the
    ten device operations that took most time, the ten longest idle gaps
    labelled by the program's span open on the host at the time, and for
    every host operator whose name starts with ``ops`` (none where it is
    empty) its calls as (input shapes, device seconds of every kernel
    launched inside the call), by operator name."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    spins = [e["ts"] for e in dev if "spin_kernel" in e.get("name", "")]
    if not spins:
        raise RuntimeError(f"the trace holds none of the {MARKERS} marker kernels: "
                           f"the profiler saw no device events")
    off = float(max(spins)) - t_clock * 1e6        # trace us = host s * 1e6 + off
    lo, hi = host_lo * 1e6 + off, host_hi * 1e6 + off
    inside = [e for e in dev if e["ts"] < hi and e["ts"] + e["dur"] > lo
              and "spin_kernel" not in e.get("name", "")]
    busy = _merge([(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in inside])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for e in inside:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labels = [(s.t0 * 1e6 + off, (s.t0 + s.dur) * 1e6 + off, s.name) for s in spans
              if s.name in LABEL_SPANS]

    def label(a, b):
        mid = 0.5 * (a + b)
        for s0, s1, name in labels:
            if s0 <= mid <= s1:
                return name
        return "none"
    idle = sorted(((label(a, b), (b - a) / 1e6) for a, b in gaps), key=lambda x: -x[1])[:10]
    calls = {}
    if ops:
        by_op: Dict[str, List[dict]] = {}
        for e in events:
            if e.get("cat") == "cpu_op" and "dur" in e and lo <= e["ts"] <= hi \
                    and e.get("name", "").startswith(ops):
                by_op.setdefault(e["name"], []).append(e)
        launches: Dict[object, list] = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                launches.setdefault(e.get("tid"), []).append(
                    (e["ts"], (e.get("args") or {}).get("correlation")))
        for v in launches.values():
            v.sort(key=lambda x: x[0])
        starts = {tid: [ts for ts, _ in v] for tid, v in launches.items()}
        by_corr = {}
        for e in dev:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                by_corr.setdefault(c, []).append(e["dur"])
        for op in sorted(by_op):
            out = []
            for e in _outermost(by_op[op]):
                tid = e.get("tid")
                ts = starts.get(tid, [])
                i0 = bisect.bisect_left(ts, e["ts"])
                i1 = bisect.bisect_right(ts, e["ts"] + e["dur"])
                us = sum(d for _, c in launches.get(tid, [])[i0:i1]
                         for d in by_corr.get(c, ()))
                out.append(((e.get("args") or {}).get("Input Dims"), us / 1e6))
            calls[op] = out
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "markers": len(spins),
            "device_ops": [[n, us / 1e6] for n, us in device_ops],
            "idle_gaps": [[n, s] for n, s in idle], "calls": calls}

