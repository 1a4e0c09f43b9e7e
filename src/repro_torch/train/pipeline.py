"""FusedTrainLoop (port of ``repro.train.pipeline``): drive the train step
straight off the data plane, on the CUDA card.

This is the layer that connects the repo's two halves — the object-store data
plane (``Consumer`` readers behind the dataplane facade) and the train step
(``repro_torch.train.step`` over the models and their Hopper kernels). The
paper claims the disaggregated plane keeps training *compute-bound*; this
loop is where that claim is measured rather than asserted (fig17).

Structure (one trainer process)::

      readers (d,c) --+                    +-------------------+
      or token pull   |   staging thread   |   staging ring    |   trainer
      ----------------+-> fetch -> pack -> | [N+1][N+2]..depth | -> step(N)
                          decode_slice     | pinned slot ->    |
                          np.block fan-in  | side-stream copy  |
                                           +-------------------+

  * **double-buffered staging ring** — a bounded ring of ``depth`` batches.
    The staging thread fetches batch N+1, assembles the ``(GB, S)`` grid,
    copies it into one of ``depth + 1`` pinned host slots, and issues a
    ``non_blocking`` copy to the card on a side stream the loop owns; it
    waits for that copy's event (so ``h2d_s`` is the landed transfer and the
    slot is free again) while the trainer runs the step on batch N. Before
    the step the trainer's stream waits on the batch's event and the device
    tensor is ``record_stream``-ed onto it, so the caching allocator cannot
    hand the block back to the side stream while the step still reads it.
    At ``depth=0`` the ring degenerates to a fully synchronous fetch + h2d on
    the critical path — the baseline arm.
  * **fused packing** — ``PackingTokenSource`` runs ``GlobalBatchPacker`` /
    ``decode_slice`` inside the staging thread, so tokenize-side packing
    never sits on the critical path; ``ReaderFanInSource`` does the per-rank
    ``Batch.tokens`` fan-in there for the same reason.
  * **stall attribution** — every step records data-wait / h2d / compute
    through ``repro_torch.obs`` spans (``pipeline.data_wait``,
    ``pipeline.h2d``, ``pipeline.compute``; the overlapped staging work is
    ``pipeline.stage.*`` so it never double-counts against the critical
    path), and ``FusedReport.attribution`` cross-checks measured compute
    against a roofline ideal the caller passes: compute drifting off the
    roofline is a kernel regression, data-wait growing under flat compute is
    a data-plane regression.

Tokens reach the step as ``int32`` tensors, as the reference hands them to
its step. The loop runs on the CUDA card unless the caller passes
``device="cpu"`` (tests); it raises without a card and when a parameter
lies on another device.

Checkpointing: the ring intentionally runs reader cursors *ahead* of the
trainer. ``aligned_checkpoint`` parks the staging thread, rewinds the source
to the consumed frontier (the cursor snapshot taken before the oldest staged
fetch), commits through the session's ``checkpoint`` so the run binds
exactly the next unconsumed batch, then resumes; re-fetching the drained
entries is idempotent (TGBs are immutable). Restart replays byte-identical
global batches — exactly-once at the token level.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import BatchTimeout
from repro_torch.data.packing import (GlobalBatchPacker, PackedBatch,
                                      assemble_grid)
from repro_torch.dataplane.types import Topology, UnsupportedOperation
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView
from repro_torch.obs.tracer import TRACER, trace_span

__all__ = ["FusedTrainLoop", "FusedReport", "StepTiming", "PipelineStats",
           "ReaderFanInSource", "PackingTokenSource"]


class PipelineStats(StatsView):
    """Registry-backed fused-loop counters (``fused.<instance>.*``)."""

    _FAMILY = "fused"
    _SPEC = {
        "steps": COUNTER,           # train steps completed
        "tokens": COUNTER,          # tokens consumed (grid cells, incl. pad)
        "staged_batches": COUNTER,  # batches staged ahead by the ring
        "align_rewinds": COUNTER,   # checkpoint alignments that drained it
        "ring_depth": GAUGE,        # staged batches currently in the ring
        "data_wait_s": GAUGE,       # cumulative critical-path stall seconds
        "h2d_s": GAUGE,             # cumulative critical-path h2d seconds
        "compute_s": GAUGE,         # cumulative step-fn seconds
    }


# ---------------------------------------------------------------------------
# Token-grid sources
# ---------------------------------------------------------------------------

class ReaderFanInSource:
    """Full ``(GB, S)`` grids from one decodable reader per (d, c) position.

    The readers are the session's own (``TrainSession.reader`` /
    ``session.reader``) — this wrapper only sequences ``next_batch`` calls and
    ``np.block``s the decoded slices back into packer order, so cursors stay
    exactly-once under the fused loop's checkpoint alignment.
    """

    def __init__(self, readers: Sequence, topology: Topology):
        if not topology.decodable:
            raise UnsupportedOperation(
                "ReaderFanInSource needs Topology(global_batch=..., "
                "seq_len=...) to decode slice payloads")
        grid: Dict[Tuple[int, int], object] = {}
        for r in readers:
            grid[(getattr(r, "dp_rank", 0), getattr(r, "cp_rank", 0))] = r
        want = {(d, c) for d in range(topology.dp) for c in range(topology.cp)}
        if set(grid) != want:
            raise ValueError(f"need one reader per mesh position {sorted(want)}"
                             f", got {sorted(grid)}")
        self.topology = topology
        self.readers = [grid[(d, c)] for d in range(topology.dp)
                        for c in range(topology.cp)]

    def next_tokens(self, timeout_s: Optional[float] = None) -> np.ndarray:
        """One full grid, transactionally: either every reader advances one
        step or none does.

        A successful ``next_batch`` moves that reader's cursor immediately, so
        a timeout on a *later* (d, c) position would otherwise leave earlier
        readers one step ahead — a retry would then assemble a grid mixing
        rows from different global steps and silently drop the earlier ranks'
        current-step slices. On any failure the already-advanced readers are
        rewound to their entry cursors before the exception propagates, so a
        retry re-fetches the same global step. ``timeout_s`` is a shared
        budget for the whole fan-in (one deadline, each reader gets what
        remains), not a per-reader allowance.
        """
        cp = self.topology.cp
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        snapshots = [r.checkpoint() for r in self.readers]
        fetched: List = []
        try:
            for r in self.readers:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                fetched.append(r.next_batch(timeout_s=remaining))
        except BaseException:
            for r, ck in zip(self.readers[:len(fetched)], snapshots):
                r.restore(ck)
            raise
        steps = {b.step for b in fetched}
        if len(steps) > 1:
            # cursors diverged before this call; rewind to the (equally
            # divergent but at least self-consistent) entry snapshot and
            # refuse to hand a torn grid to the trainer
            for r, ck in zip(self.readers, snapshots):
                r.restore(ck)
            raise RuntimeError(
                f"fan-in readers returned mixed global steps "
                f"{sorted(steps)}; cursors have diverged — refusing to "
                f"assemble a grid spanning more than one step")
        rows = [[fetched[d * cp + c].tokens for c in range(cp)]
                for d in range(self.topology.dp)]
        return np.block(rows)

    # -- cursor surface (exactly-once alignment) ---------------------------
    def cursors(self) -> tuple:
        return tuple(r.checkpoint() for r in self.readers)

    def restore(self, cursors: tuple) -> None:
        for r, ck in zip(self.readers, cursors):
            r.restore(ck)

    # -- prefetch passthrough ----------------------------------------------
    def start_prefetch(self) -> None:
        for r in self.readers:
            fn = getattr(r, "start_prefetch", None)
            if fn:
                fn()

    def stop_prefetch(self) -> None:
        for r in self.readers:
            fn = getattr(r, "stop_prefetch", None)
            if fn:
                fn()


class PackingTokenSource:
    """Full grids from a raw token stream, packed off the critical path.

    ``pull(timeout_s)`` returns the next chunk of preprocessed tokens (any
    shape; raveled) or ``None`` at end-of-stream — e.g. the colocated
    pipeline's sample indices mapped through a tokenizer. It may instead
    return a ``(tokens, num_samples)`` tuple to attribute a per-chunk sample
    count (the bare-array form counts one sample per chunk). A chunk of zero
    tokens, or a ``BatchTimeout`` raised inside ``pull``, both mean "no data
    yet" — neither perturbs sample accounting, and the deadline is re-checked
    before the next attempt. Each individual ``pull`` call is handed at most
    ``_PULL_POLL_S`` of the remaining budget, so a callable that ignores its
    timeout argument cannot overrun ``timeout_s`` unbounded. The packer and
    the ``decode_slice`` round-trip (slice at the run topology, reassemble)
    run wherever ``next_tokens`` runs — inside the staging thread under the
    fused loop, which is the "packing never on the critical path" half of the
    tentpole. At end-of-stream the buffered remainder is flushed padded.

    No cursor surface: ``cursors()`` returns ``None`` and checkpoint
    alignment over a staged ring is refused (use ``ReaderFanInSource`` and a
    ``TrainSession`` when exactly-once matters).
    """

    #: cap on a single ``pull`` slice — bounds how long one call can hold the
    #: thread even when the callable ignores its timeout argument, so the
    #: caller's deadline is honored to within one slice
    _PULL_POLL_S = 0.25

    def __init__(self, pull: Callable[[Optional[float]], Optional[np.ndarray]],
                 topology: Topology, pad_token: int = 0):
        if not topology.decodable:
            raise UnsupportedOperation(
                "PackingTokenSource needs Topology(global_batch=..., "
                "seq_len=...) to shape the packed grid")
        self.topology = topology
        self.pad_token = pad_token
        self._pull = pull
        self._packer = GlobalBatchPacker(topology.global_batch,
                                         topology.seq_len,
                                         topology.dp, topology.cp)
        self._pending: "deque[PackedBatch]" = deque()
        self._exhausted = False
        self.last_batch: Optional[PackedBatch] = None

    def next_tokens(self, timeout_s: Optional[float] = None) -> np.ndarray:
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while not self._pending:
            if self._exhausted:
                raise BatchTimeout("token source exhausted")
            if deadline is None:
                budget = None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise BatchTimeout(
                        f"no full global batch packed within {timeout_s}s "
                        f"({self._packer.buffered_tokens}/"
                        f"{self._packer.tokens_per_batch} tokens buffered)")
                budget = min(remaining, self._PULL_POLL_S)
            try:
                chunk = self._pull(budget)
            except BatchTimeout:
                continue   # no data within this slice; deadline re-checked
            if chunk is None:
                self._exhausted = True
                tail = self._packer.flush(self.pad_token)
                if tail is None:
                    raise BatchTimeout("token source exhausted")
                self._pending.append(tail)
                break
            chunk, samples = chunk if isinstance(chunk, tuple) else (chunk, 1)
            chunk = np.asarray(chunk)
            if chunk.size == 0:
                continue   # "no data yet": an empty chunk completes no sample
            self._pending.extend(self._packer.add_tokens(chunk,
                                                         samples=samples))
        batch = self._pending.popleft()
        self.last_batch = batch
        t = self.topology
        return assemble_grid(batch.slices, t.global_batch, t.seq_len,
                             t.dp, t.cp)

    def cursors(self):
        return None

    def restore(self, cursors) -> None:
        raise UnsupportedOperation(
            "PackingTokenSource has no replayable cursor")

    def start_prefetch(self) -> None:
        pass

    def stop_prefetch(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Per-step timing + run report
# ---------------------------------------------------------------------------

@dataclass
class StepTiming:
    """Critical-path split of one train step (seconds)."""

    step: int
    data_wait_s: float   # blocked on the ring / the store
    h2d_s: float         # host->device transfer on the critical path
    compute_s: float     # step fn dispatch + device execution (synced)
    wall_s: float        # whole-step wall clock
    loss: float

    @property
    def other_s(self) -> float:
        """Loop overhead not captured by the three attributed phases."""
        return max(0.0, self.wall_s
                   - self.data_wait_s - self.h2d_s - self.compute_s)


@dataclass
class FusedReport:
    """One ``FusedTrainLoop.run`` outcome: throughput + stall attribution."""

    steps: int
    tokens: int
    wall_s: float
    timings: List[StepTiming] = field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def losses(self) -> List[float]:
        return [t.loss for t in self.timings]

    def totals(self) -> Dict[str, float]:
        return {
            "data_wait_s": sum(t.data_wait_s for t in self.timings),
            "h2d_s": sum(t.h2d_s for t in self.timings),
            "compute_s": sum(t.compute_s for t in self.timings),
            "other_s": sum(t.other_s for t in self.timings),
            "wall_s": sum(t.wall_s for t in self.timings),
        }

    def stall_fractions(self) -> Dict[str, float]:
        """Each phase as a fraction of summed per-step wall clock."""
        t = self.totals()
        wall = max(t["wall_s"], 1e-12)
        return {k[:-2]: v / wall for k, v in t.items() if k != "wall_s"}

    @property
    def data_wait_frac(self) -> float:
        return self.stall_fractions()["data_wait"]

    def attribution(self, roofline_step_s: Optional[float] = None
                    ) -> Dict[str, object]:
        """Where did the time go, and whose fault is a regression?

        With ``roofline_step_s`` (see ``launch.roofline.ideal_step_s``) the
        report carries ``compute_vs_roofline`` — measured compute per step
        over the roofline ideal (1/MFU-shaped). Rising compute_vs_roofline
        at flat data_wait is a kernel problem; rising data_wait at flat
        compute_vs_roofline is a data-plane problem.
        """
        fr = self.stall_fractions()
        per_step = {k: v / max(self.steps, 1)
                    for k, v in self.totals().items()}
        out: Dict[str, object] = {
            **fr,
            "per_step": per_step,
            "bound": "data-plane"
            if fr["data_wait"] + fr["h2d"] > fr["compute"] else "compute",
        }
        if roofline_step_s:
            out["roofline_step_s"] = roofline_step_s
            out["compute_vs_roofline"] = \
                per_step["compute_s"] / roofline_step_s
        return out


# ---------------------------------------------------------------------------
# The fused loop
# ---------------------------------------------------------------------------

class _HostSyncCount:
    """Counts the device-to-host syncs this thread makes inside the block:
    torch's sync debug mode at "warn" warns at each one (``.item()``, a
    ``float()`` of a device tensor, ``nonzero``, a boolean index, a
    blocking copy; the autograd engine hands its threads' warnings to the
    caller). The count lands in ``span``'s ``host_syncs``; the previous mode
    and warning filters are restored after.

    The mode, the filters and ``warnings.showwarning`` are process-wide:
    a sync warning from another thread (staging, prefetch) is dropped, as
    it is with the mode off. The count is a lower bound: torch says the mode
    does not yet detect every synchronizing operation."""

    MESSAGE = "called a synchronizing CUDA operation"

    def __init__(self, span):
        self.span, self.n = span, 0

    def __enter__(self):
        self._ident = threading.get_ident()
        self._filters = warnings.catch_warnings()
        self._filters.__enter__()
        warnings.filterwarnings("always", message=f".*{self.MESSAGE}")
        show = warnings.showwarning

        def count(message, category, filename, lineno, file=None, line=None):
            if self.MESSAGE not in str(message):
                show(message, category, filename, lineno, file, line)
            elif threading.get_ident() == self._ident:
                self.n += 1
        warnings.showwarning = count
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._filters.__exit__(*exc)
        self.span.annotate(host_syncs=self.n)
        return False


@dataclass
class _Staged:
    """One ring entry: a device-resident batch plus its replay cursor."""

    device_tokens: torch.Tensor
    host_tokens: np.ndarray
    cursors: Optional[tuple]   # source cursors BEFORE this batch was fetched
    fetch_s: float
    h2d_s: float
    # the side-stream copy's event (CUDA ring entries only): the trainer's
    # stream waits on it before the step reads ``device_tokens``
    event: Optional[torch.cuda.Event] = None


class FusedTrainLoop:
    """Run ``train_step(params, opt_state, batch)`` off a token-grid source.

    ``source`` is a ``ReaderFanInSource`` / ``PackingTokenSource`` (anything
    with ``next_tokens``/``cursors``/``restore``/``start_prefetch``).
    ``step_fn`` is ``make_train_step(...)`` output. ``depth`` is the
    staging-ring size: 0 = synchronous baseline, >=1 overlaps fetch+pack+h2d
    of future batches with the current step (2 is classic double
    buffering). ``device`` is where the step runs: the CUDA card unless the
    caller asks for the CPU; every parameter leaf must already lie there.
    """

    #: staging-thread fetch slice — short so pause/stop are responsive even
    #: when the stream has gone quiet (each timeout just re-checks control
    #: flags and retries; readers treat a timed-out fetch as a no-op)
    _STAGE_POLL_S = 0.25

    def __init__(self, source, step_fn, params, opt_state, *,
                 topology: Optional[Topology] = None, depth: int = 2,
                 timeout_s: float = 60.0, instance: str = "loop",
                 device=None):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for leaf in tree_leaves(params):
            if leaf.device != dev:
                raise ValueError(
                    f"FusedTrainLoop runs on {dev}, but a parameter lies on "
                    f"{leaf.device}; move the parameters there first")
        self.device = dev
        self.source = source
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.depth = int(depth)
        self.timeout_s = timeout_s
        topo = topology or getattr(source, "topology", None)
        self.tokens_per_batch = (topo.global_batch * topo.seq_len) \
            if topo is not None and topo.decodable else 0
        self.consumed = 0          # batches fed to the step fn
        self.stats = PipelineStats(instance)
        # ring state, all guarded by one condition
        self._cond = threading.Condition()
        self._ring: "deque[_Staged]" = deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._pause = False
        self._idle = threading.Event()   # staging thread parked (not fetching)
        self._error: Optional[BaseException] = None
        # CUDA staging: the side stream the h2d copies run on and the pinned
        # host slots they copy from (allocated at the first staged batch)
        self._h2d_stream: Optional[torch.cuda.Stream] = None
        self._slots: List[torch.Tensor] = []
        self._next_slot = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the staging ring (no-op at depth 0 or if already running)."""
        if self.depth == 0 or self._thread is not None:
            return
        self.source.start_prefetch()
        self._stop = False
        # a stop()/start() cycle must fully recover: clear a pause left by a
        # failed alignment and an error from a dead predecessor thread
        self._pause = False
        self._error = None
        self._idle.clear()
        self._thread = threading.Thread(target=self._stage_loop, daemon=True,
                                        name="fused-staging")
        self._thread.start()

    def stop(self) -> None:
        """Stop the staging thread and drop staged-but-unconsumed entries,
        rewinding the source to the consumed frontier first.

        The rewind (to the oldest staged entry's pre-fetch cursors) is what
        makes "dropped" safe: after ``stop`` the source's cursors name
        exactly the next batch the trainer has not consumed, so a checkpoint
        taken afterwards — or a plain restart — replays the dropped entries
        instead of silently skipping them. A non-restorable source (no
        cursors) keeps its staged entries in the ring instead, so no data is
        lost; they are consumed first if the loop is started again."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._cond:
            entries = list(self._ring)
        if entries and entries[0].cursors is not None:
            self.source.restore(entries[0].cursors)
            with self._cond:
                self._ring.clear()
                self.stats.ring_depth = 0.0
        self.source.stop_prefetch()

    def __enter__(self) -> "FusedTrainLoop":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # -- host -> device ------------------------------------------------------
    def _stage_h2d(self, tokens: np.ndarray
                   ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Stage one grid on the staging thread: through a pinned slot and a
        side-stream copy on the card (waited for before returning, so the
        slot may be reused), a plain copy on the CPU."""
        if self.device.type != "cuda":
            return torch.from_numpy(tokens).clone(), None
        host = torch.from_numpy(tokens)
        if not self._slots or self._slots[0].shape != host.shape:
            # depth + 1 slots: one more than the ring can hold
            self._slots = [torch.empty(host.shape, dtype=host.dtype,
                                       pin_memory=True)
                           for _ in range(self.depth + 1)]
            self._next_slot = 0
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        slot.copy_(host)
        ev = torch.cuda.Event()
        with torch.cuda.stream(self._h2d_stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(slot, non_blocking=True)
            ev.record(self._h2d_stream)
        ev.synchronize()
        return dev, ev

    # -- staging thread ------------------------------------------------------
    def _stage_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            if self._h2d_stream is None:
                self._h2d_stream = torch.cuda.Stream(self.device)
        while True:
            with self._cond:
                while not self._stop and (self._pause
                                          or len(self._ring) >= self.depth):
                    self._idle.set()
                    self._cond.wait(0.05)
                if self._stop:
                    self._idle.set()
                    return
                self._idle.clear()
            try:
                cursors = self.source.cursors()
                t0 = time.perf_counter()
                with trace_span("pipeline.stage.fetch", cat="prefetch"):
                    tokens = self.source.next_tokens(
                        timeout_s=self._STAGE_POLL_S)
                fetch_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                with trace_span("pipeline.stage.h2d", cat="h2d"):
                    dev, ev = self._stage_h2d(tokens)
                h2d_s = time.perf_counter() - t1
            except BatchTimeout:
                continue   # re-check stop/pause, then retry the fetch
            except BaseException as e:
                with self._cond:
                    self._error = e
                    self._idle.set()
                    self._cond.notify_all()
                return
            with self._cond:
                self._ring.append(_Staged(dev, tokens, cursors,
                                          fetch_s, h2d_s, ev))
                self.stats.staged_batches += 1
                self.stats.ring_depth = float(len(self._ring))
                self._cond.notify_all()

    # -- acquiring the next device batch -------------------------------------
    def _acquire(self) -> Tuple[_Staged, float, float]:
        """Next staged batch + (data_wait_s, h2d_s) on the critical path."""
        if self.depth == 0:
            return self._acquire_sync()
        with trace_span("pipeline.data_wait", cat="read", step=self.consumed):
            t0 = time.perf_counter()
            deadline = t0 + self.timeout_s
            with self._cond:
                while not self._ring:
                    if self._error is not None:
                        raise self._error
                    if self._pause:
                        raise RuntimeError(
                            "ring paused (aligned_checkpoint in progress) "
                            "while the trainer asked for a batch")
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise BatchTimeout(
                            f"staging ring empty after {self.timeout_s}s")
                    self._cond.wait(min(remaining, 0.05))
                entry = self._ring.popleft()
                self.stats.ring_depth = float(len(self._ring))
                self._cond.notify_all()
            data_wait = time.perf_counter() - t0
        # the transfer already landed on the staging thread: h2d on the
        # critical path is zero (that overlap is the point of the ring)
        return entry, data_wait, 0.0

    def _acquire_sync(self) -> Tuple[_Staged, float, float]:
        with trace_span("pipeline.data_wait", cat="read", step=self.consumed):
            t0 = time.perf_counter()
            tokens = self.source.next_tokens(timeout_s=self.timeout_s)
            fetch_s = time.perf_counter() - t0
        with trace_span("pipeline.h2d", cat="h2d", step=self.consumed):
            t1 = time.perf_counter()
            if self.device.type == "cuda":
                dev = torch.from_numpy(tokens).to(self.device)
                torch.cuda.synchronize(self.device)
            else:
                dev = torch.from_numpy(tokens).clone()
            h2d_s = time.perf_counter() - t1
        return _Staged(dev, tokens, None, fetch_s, h2d_s), fetch_s, h2d_s

    # -- training -------------------------------------------------------------
    def run(self, num_steps: int,
            on_batch: Optional[Callable[[int, np.ndarray], None]] = None
            ) -> FusedReport:
        """Train ``num_steps`` steps; returns the throughput report.

        ``on_batch(step, host_tokens)`` observes every consumed grid (tests
        use it to assert byte-identical replay). Call ``start()`` first or
        use the loop as a context manager; ``run`` may be called repeatedly
        — state (params, opt, cursor position) carries across calls.
        """
        self.start()
        timings: List[StepTiming] = []
        tokens_total = 0
        t_run0 = time.perf_counter()
        for _ in range(num_steps):
            t0 = time.perf_counter()
            entry, data_wait_s, h2d_s = self._acquire()
            if entry.event is not None:
                # the copy ran on the side stream: order the step after it,
                # and keep the block alive until the step's stream is done
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(entry.event)
                entry.device_tokens.record_stream(stream)
            with trace_span("pipeline.compute", cat="compute",
                            step=self.consumed) as span, \
                    _HostSyncCount(span) if TRACER.enabled and \
                    self.device.type == "cuda" else contextlib.nullcontext():
                tc = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state,
                    {"tokens": entry.device_tokens})
                loss = float(metrics["loss"])   # forces device sync
                compute_s = time.perf_counter() - tc
            if on_batch is not None:
                on_batch(self.consumed, entry.host_tokens)
            wall_s = time.perf_counter() - t0
            timings.append(StepTiming(self.consumed, data_wait_s, h2d_s,
                                      compute_s, wall_s, loss))
            self.consumed += 1
            tokens_total += int(entry.host_tokens.size)
            self.stats.steps += 1
            self.stats.tokens += int(entry.host_tokens.size)
            self.stats.data_wait_s += data_wait_s
            self.stats.h2d_s += h2d_s
            self.stats.compute_s += compute_s
        return FusedReport(steps=num_steps, tokens=tokens_total,
                           wall_s=time.perf_counter() - t_run0,
                           timings=timings)

    # -- checkpoint alignment --------------------------------------------------
    def align(self) -> None:
        """Park the ring and rewind the source to the consumed frontier.

        After this returns, the source's cursors name exactly the first
        batch the trainer has *not* consumed — the state an aligned
        checkpoint must bind. Staged entries are dropped; the paused thread
        re-fetches them after ``resume_staging`` (byte-identical: the data
        plane is immutable).
        """
        if self._thread is not None:
            with self._cond:
                self._pause = True
                self._cond.notify_all()
            while not self._idle.wait(timeout=1.0):
                with self._cond:
                    if self._error is not None:
                        raise self._error
        with self._cond:
            if self._error is not None:
                raise self._error
            # drain whatever is staged even when the thread is gone (stopped
            # loop, depth 0 never stages) — alignment is about ring contents,
            # not thread liveness
            entries = list(self._ring)
            self._ring.clear()
            self.stats.ring_depth = 0.0
        if entries:
            cursors = entries[0].cursors
            if cursors is None:
                # non-restorable source: its staged tokens cannot be
                # re-fetched, so put them back untouched before refusing —
                # the loop keeps training through them after resume
                with self._cond:
                    self._ring.extendleft(reversed(entries))
                    self.stats.ring_depth = float(len(self._ring))
                raise UnsupportedOperation(
                    "source is not cursor-restorable: a staged ring cannot "
                    "be aligned for checkpointing (use ReaderFanInSource)")
            self.source.restore(cursors)
            self.stats.align_rewinds += 1

    def resume_staging(self) -> None:
        with self._cond:
            self._pause = False
            self._cond.notify_all()

    def aligned_checkpoint(self, session, state, **kw):
        """``TrainSession.checkpoint`` at the consumed frontier.

        Parks the ring, rewinds the session's readers to the next
        unconsumed batch, commits the RunManifest entry, then resumes
        staging. The committed cursor equals ``self.consumed`` — resuming
        from it replays the exact token stream the trainer would have seen.
        """
        try:
            with trace_span("pipeline.align", cat="checkpoint",
                            step=self.consumed):
                self.align()
            return session.checkpoint(state, **kw)
        finally:
            # guaranteed even when align() itself raises (non-restorable
            # source, propagated staging error) — a parked thread must never
            # outlive the alignment attempt
            self.resume_staging()
