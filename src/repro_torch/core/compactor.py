"""Background compactor: folds cold shard-chain prefixes into segments.

Million-TGB histories must stay poll-cheap: without folding, every cold
reader of a sharded run replays K full shard chains, and per-shard flat
manifests regrow with history. The compactor walks the *stable* merged
prefix (entries below the checkpoint-aligned safe step) and folds it into
``manifest/compact/<seq>.seg`` segments in merged order, then advances each
shard chain's base via empty trim-only commits so the live chains stay
short.

Crash-idempotence (rehearsed by the ``compactor_midfold_kill`` chaos
scenario): the segment object is written FIRST via conditional put; the
per-shard trim commits follow. A crash in between leaves ``folds[k]``
(cumulative, recorded in the segment) ahead of the shard base — readers
deduplicate by skipping the already-folded live prefix, and the next cycle's
repair pass simply re-issues the missing trims. Nothing is ever readable
twice at different steps, and nothing is unreadable in any crash window.

Port of ``repro.core.compactor``, copied as it is but for its imports.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.core.lifecycle import read_trim_marker
from repro_torch.core.manifest import (CompactSegment, ShardedManifestStore)
from repro_torch.core.objectstore import Namespace
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView

__all__ = ["CompactStats", "Compactor"]


class CompactStats(StatsView):
    """Registry-backed compactor counters (``compact.<instance>.*``)."""

    _FAMILY = "compact"
    _SPEC = {
        "cycles": COUNTER,           # run_cycle invocations
        "segments_written": COUNTER,  # conditional segment puts that won
        "entries_folded": COUNTER,   # TGB entries moved into segments
        "bytes_written": COUNTER,    # segment object bytes
        "trim_commits": COUNTER,     # shard-base advances that won
        "trim_conflicts": COUNTER,   # shard-base advances that lost and retried
        "repairs": COUNTER,          # cycles that found folds ahead of trims
        "fold_horizon": GAUGE,       # global step up to which history is folded
    }


class Compactor:
    """Folds the cold merged prefix of a sharded run into compact segments.

    One compactor per run suffices, but running several is safe: the segment
    sequence is claimed by conditional put (first writer wins; losers reload),
    and trim commits are idempotent toward the recorded fold counts.
    """

    #: conditional-put retry budget per shard trim (conflicts with producer
    #: commits are expected; the next cycle retries anything left over)
    TRIM_ATTEMPTS = 8

    def __init__(self, ns: Namespace, manifests: ShardedManifestStore,
                 min_fold: int = 16, stats_instance: str = "compactor"):
        self.ns = ns
        self.store = ns.store
        self.manifests = manifests
        #: don't write a segment for fewer than this many foldable entries
        #: (tiny segments defeat the purpose: cold readers pay per object)
        self.min_fold = max(1, min_fold)
        self.stats = CompactStats(stats_instance)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def run_cycle(self, safe_step: Optional[int] = None) -> Dict[str, int]:
        """One fold cycle. ``safe_step`` bounds the fold (checkpoint-aligned);
        defaults to the run's trim marker. Returns a small summary dict."""
        self.stats.cycles += 1
        if safe_step is None:
            trim = read_trim_marker(self.ns)
            safe_step = trim[0] if trim is not None else 0
        # repair first: a predecessor may have died between segment write and
        # trim commits, leaving fold counts ahead of shard bases
        repaired = self._repair_trims()
        self.manifests.latest_version()  # refresh shard probes
        mv = self.manifests.load_view()
        # the segment chain is authoritative for what is already folded: a
        # warm merged view that absorbed those entries live never re-reads
        # segments, so its own fold accounting can lag
        latest_seq = self.manifests.segments.latest()
        if latest_seq >= 0:
            prev = self.manifests.segments.read(latest_seq)
            folds, folded_end = list(prev.folds), prev.end_step
        else:
            folds, folded_end = [0] * self.manifests.n_shards, 0
        stable_end = mv.base_step + len(mv.tgbs)  # merged == stable by def.
        target = min(safe_step, stable_end)
        self.stats.fold_horizon = float(folded_end)
        summary = {"folded": 0, "repaired": repaired, "segment": -1}
        if target - folded_end < self.min_fold:
            return summary
        lo = folded_end - mv.base_step
        hi = target - mv.base_step
        entries = mv.tgbs[lo:hi]
        shards_of = mv.entry_shards[lo:hi]
        for s in shards_of:
            if s < 0:
                raise RuntimeError(
                    f"{self.ns.prefix}: entry below fold horizon re-entered "
                    f"the fold window (segment accounting is torn; run fsck)")
            folds[s] += 1
        seg = CompactSegment(seq=latest_seq + 1,
                             base_step=folded_end, tgbs=entries, folds=folds)
        raw_len = len(seg.pack())
        if not self.manifests.segments.try_put(seg):
            return summary  # lost the race to a peer compactor; their fold wins
        self.stats.segments_written += 1
        self.stats.entries_folded += len(entries)
        self.stats.bytes_written += raw_len
        self.stats.fold_horizon = float(target)
        summary["folded"] = len(entries)
        summary["segment"] = seg.seq
        for k in range(self.manifests.n_shards):
            self._trim_shard(k, folds[k])
        return summary

    def _repair_trims(self) -> int:
        """Re-issue trim commits for any shard whose base lags the newest
        segment's cumulative fold count (predecessor crashed mid-fold)."""
        latest = self.manifests.segments.latest()
        if latest < 0:
            return 0
        seg = self.manifests.segments.read(latest)
        repaired = 0
        for k, fold_count in enumerate(seg.folds):
            shard = self.manifests.shards[k]
            head = shard.latest_version(hint=-1)
            if head < 0:
                continue
            if shard.load_view(head).base_step < fold_count:
                if self._trim_shard(k, fold_count):
                    repaired += 1
        if repaired:
            self.stats.repairs += 1
        return repaired

    def _trim_shard(self, k: int, fold_count: int) -> bool:
        """Advance shard ``k``'s base to its folded-entry count via an empty
        trim-only commit (bounded retries against producer conflicts)."""
        shard = self.manifests.shards[k]
        for _ in range(self.TRIM_ATTEMPTS):
            head = shard.latest_version(hint=-1)
            view = shard.load_view(head) if head >= 0 else None
            if view is None or view.base_step >= fold_count:
                return True
            version, raw = shard.encode_candidate(
                view, [], dict(view.producers), trim_to_step=fold_count)
            if shard.try_put_version(version, raw):
                self.stats.trim_commits += 1
                return True
            self.stats.trim_conflicts += 1
        return False

    # -- background thread ---------------------------------------------------
    def start(self, interval_s: float = 2.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.run_cycle()
                except Exception:
                    pass  # folding is best-effort; next cycle repairs
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="bw-compactor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
