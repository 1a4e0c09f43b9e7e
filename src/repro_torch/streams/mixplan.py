"""Deterministic weighted mixing schedule (multi-stream data plane).

A ``MixPlan`` maps every global training step to ``(stream, stream_step)``
via smooth weighted round-robin (SRR): each step every stream accrues credit
proportional to its normalized weight, the richest stream is chosen, and the
winner pays back one full unit. The resulting interleave is *stride-like* —
over any window of N steps each stream is scheduled ``~N * w`` times with
bounded (O(1)) deviation, so no stream is starved and per-stream consumption
is as smooth as the weights allow.

Two properties the rest of the subsystem leans on:

  * **Pure function of (weights, seed, step).** No schedule object is ever
    stored: a restored reader (or a reclaimer on another machine) rebuilds the
    identical step -> (stream, stream_step) mapping from the session config
    alone. The seed perturbs the initial credits, giving different-but-equally
    -smooth interleavings per run.
  * **Per-stream steps are dense and ordered.** The k-th time a stream is
    scheduled it is assigned stream_step k, so every stream's substream is
    consumed strictly sequentially — exactly what the single-stream consumer
    cursor ``<V, S>`` supports.

Memory is O(n_streams + recent window), not O(steps): the SRR state rolls
forward (credits + per-stream counts), a bounded window of recent entries
serves the reader's near-cursor revisits, and cold queries far behind the
frontier (restore validation, test replays) recompute from step 0 — O(step)
time, zero retained state.

Port of ``repro.streams.mixplan``, copied as it is but for its imports.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Mapping, Tuple

__all__ = ["MixPlan"]

# near-cursor entries kept for O(1) revisits; anything older is recomputed
_RECENT_WINDOW = 8192


class _Walker:
    """Rolling SRR state: O(n_streams) memory, one schedule step per advance."""

    __slots__ = ("w", "credits", "counts", "step")

    def __init__(self, w: List[float], init_credits: List[float]):
        self.w = w
        self.credits = list(init_credits)
        self.counts = [0] * len(w)
        self.step = 0  # next global step this walker will schedule

    def advance(self) -> Tuple[int, int]:
        """Schedule global step ``self.step``; returns (stream idx, stream_step)."""
        credits = self.credits
        for i, wi in enumerate(self.w):
            credits[i] += wi
        j = max(range(len(credits)), key=lambda i: (credits[i], -i))
        credits[j] -= 1.0  # weights are normalized: one unit per step
        sstep = self.counts[j]
        self.counts[j] += 1
        self.step += 1
        return j, sstep


class MixPlan:
    """Deterministic step -> (stream, stream_step) schedule."""

    def __init__(self, weights: Mapping[str, float], seed: int = 0):
        if not weights:
            raise ValueError("MixPlan needs at least one stream")
        for name, w in weights.items():
            if not name or not isinstance(name, str):
                raise ValueError(f"bad stream name {name!r}")
            if not (w > 0):
                raise ValueError(f"stream {name!r} weight must be > 0, got {w}")
        # sorted name order + a seeded RNG make the schedule a pure function
        # of (weights, seed) regardless of dict insertion order
        self.names: Tuple[str, ...] = tuple(sorted(weights))
        total = float(sum(weights[n] for n in self.names))
        self.weights: Dict[str, float] = {n: weights[n] / total
                                          for n in self.names}
        self.seed = seed
        rng = random.Random((seed, len(self.names), *self.names).__repr__())
        self._w = [self.weights[n] for n in self.names]
        # initial credit in [0, w_i): breaks ties and phase-shifts the
        # interleave per seed without disturbing long-run proportions
        self._init_credits = [rng.random() * wi for wi in self._w]
        self._head = _Walker(self._w, self._init_credits)
        self._recent: Dict[int, Tuple[int, int]] = {}  # step -> (idx, sstep)
        # dedicated monotone walker for stream_counts probes (reclaim/lag)
        self._counter = _Walker(self._w, self._init_credits)
        self._lock = threading.Lock()

    # -- schedule materialization -------------------------------------------
    def _advance_head_to(self, step: int) -> None:
        while self._head.step <= step:
            g = self._head.step
            self._recent[g] = self._head.advance()
            self._recent.pop(g - _RECENT_WINDOW, None)

    def _cold_entry(self, step: int) -> Tuple[int, int]:
        """Recompute one entry far behind the recent window from scratch."""
        w = _Walker(self._w, self._init_credits)
        for _ in range(step):
            w.advance()
        return w.advance()

    # -- queries -------------------------------------------------------------
    def position(self, step: int) -> Tuple[str, int]:
        """The (stream name, stream_step) serving global step ``step``.

        Amortized O(1) at or ahead of the frontier and within the recent
        window; O(step) recompute for cold queries far behind it."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        with self._lock:
            entry = self._recent.get(step)
            if entry is None and step >= self._head.step:
                self._advance_head_to(step)
                entry = self._recent[step]
        if entry is None:
            entry = self._cold_entry(step)
        j, sstep = entry
        return self.names[j], sstep

    def schedule(self, n_steps: int) -> List[Tuple[str, int]]:
        """The first ``n_steps`` entries of the step -> (stream, stream_step)
        mapping (test/replay helper; recomputed, nothing retained)."""
        w = _Walker(self._w, self._init_credits)
        out = []
        for _ in range(max(0, n_steps)):
            j, sstep = w.advance()
            out.append((self.names[j], sstep))
        return out

    def stream_counts(self, upto_step: int) -> Dict[str, int]:
        """Per-stream scheduled-step counts over global steps [0, upto_step).

        ``stream_counts(G)[name]`` is exactly the stream_step cursor stream
        ``name`` must hold when the mixed reader's next global step is ``G`` —
        the invariant composite checkpoints are validated against, and the
        mix-aware low-watermark used for per-stream trimming. Amortized O(1)
        for monotone probes; O(upto_step) recompute for backward ones."""
        if upto_step <= 0:
            return dict.fromkeys(self.names, 0)
        with self._lock:
            if upto_step >= self._counter.step:
                while self._counter.step < upto_step:
                    self._counter.advance()
                counts = list(self._counter.counts)
            else:  # backward probe (rare: restore validation): fresh walk
                w = _Walker(self._w, self._init_credits)
                for _ in range(upto_step):
                    w.advance()
                counts = w.counts
        return {self.names[i]: counts[i] for i in range(len(self.names))}

    def frontier(self, published: Mapping[str, int], start: int = 0) -> int:
        """Largest global step G >= start such that every step in [start, G)
        is backed by a published stream step (``published[name]`` = stream
        steps currently visible). The mixed reader's contiguous-progress
        probe — callers pass their cursor as ``start`` (everything below it
        was already served) so the walk covers only new ground."""
        g = max(0, start)
        while True:
            name, sstep = self.position(g)
            if sstep >= published.get(name, 0):
                return g
            g += 1

    def __repr__(self) -> str:
        ws = ", ".join(f"{n}={self.weights[n]:.3f}" for n in self.names)
        return f"MixPlan({ws}, seed={self.seed})"
