"""One named TGB stream: an independent manifest chain under a per-stream
namespace prefix (``<run>/streams/<name>/...``).

A stream is structurally a complete single-stream BatchWeave run — its own
producers, DAC state, commit protocol, watermarks, trim marker, and reclaimer
— which is what lets every existing core client (Producer, Consumer,
Reclaimer) run unmodified underneath the mixing layer. Only the *watermarks*
written into a stream are special: they are mix-aware stream-step cursors
derived from composite checkpoints, so a stream only reclaims TGBs below the
lowest stream step any mixed reader can still revisit.

Port of ``repro.streams.stream``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.lifecycle import Reclaimer, Watermark, write_watermark
from repro_torch.core.manifest import DatasetView, ManifestStore, open_manifest_store
from repro_torch.core.objectstore import Namespace

__all__ = ["Stream"]


class Stream:
    """Server-side handle on one named stream of a multi-stream run."""

    def __init__(self, parent_ns: Namespace, name: str, weight: float,
                 expected_ranks: int):
        self.name = name
        self.weight = weight
        self.ns = parent_ns.stream(name)
        self.expected_ranks = expected_ranks
        # shard-layout discovery: a sharded stream transparently yields the
        # merged read view; legacy streams get the plain single-chain store
        self._manifests = open_manifest_store(self.ns)
        self._view = DatasetView()
        self._reclaimer: Optional[Reclaimer] = None

    # -- producers -----------------------------------------------------------
    def manifests(self) -> ManifestStore:
        return self._manifests

    def manifest_view(self) -> DatasetView:
        """Latest committed view. Polls forward from the cached version (the
        same hint/base pattern as Consumer.poll), so repeated lag/frontier
        probes cost O(new versions), not O(history)."""
        latest = self._manifests.latest_version(hint=self._view.version)
        if latest > self._view.version:
            self._view = self._manifests.load_view(latest, base=self._view)
        return self._view

    @property
    def published_steps(self) -> int:
        """Stream steps currently committed (visible) in this stream."""
        return self.manifest_view().total_steps

    # -- mix-aware lifecycle ---------------------------------------------------
    def save_watermark(self, rank: int, version: int, stream_step: int) -> None:
        """Publish rank ``rank``'s mix-aware watermark for this stream: the
        (manifest version, stream step) below which this rank will never read
        again. Called with cursors taken from a composite checkpoint."""
        write_watermark(self.ns, rank, Watermark(version=version,
                                                 step=stream_step))

    def reclaimer(self) -> Reclaimer:
        if self._reclaimer is None:
            self._reclaimer = Reclaimer(self.ns,
                                        expected_ranks=self.expected_ranks)
        return self._reclaimer

    def reclaim_cycle(self) -> int:
        """One watermark-driven reclamation cycle; returns TGBs deleted so far
        for this stream."""
        r = self.reclaimer()
        r.run_cycle()
        return r.stats.tgbs_deleted

    # -- derived streams -------------------------------------------------------
    def derive_cursors(self):
        """The derive-cursor store of this stream (non-empty only when the
        stream is the output of a ``repro_torch.graph`` DeriveWorker)."""
        from repro_torch.graph.cursor import DeriveCursorStore
        return DeriveCursorStore(self.ns)

    def latest_derive_cursor(self):
        """Latest committed DeriveCursor, or None for a raw stream."""
        return self.derive_cursors().latest()

    @property
    def is_derived(self) -> bool:
        """True if any committed TGB of this stream carries provenance."""
        return bool(self.manifest_view().derived_tgbs())

    def __repr__(self) -> str:
        return f"Stream({self.name!r}, weight={self.weight:.3f})"
