"""Checkpoint-aligned lifecycle management (paper §5.3, Fig. 9).

After each successful distributed checkpoint, every consumer rank persists a
watermark ``W_i = (manifest version V, step S)`` alongside the model weights.
The reclaimer derives the global safety boundary

    W_global = min_i(W_i)

and (a) writes a **trim marker** so producers logically trim the TGB list at
their next commit (bounding manifest size), and (b) physically deletes manifest
versions ``v < W_global.version`` and TGB objects whose step `` < W_global.step``
— all idempotent, outside the critical path, restartable at any time.

``max_lag`` throttling on the producer side reads the same trim marker.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import _msgpack as msgpack

from repro_torch.core.manifest import (ManifestStore, ShardedManifestStore,
                                       open_manifest_store)
from repro_torch.core.objectstore import Namespace, NoSuchKey
from repro_torch.obs.registry import COUNTER, StatsView


@dataclass(frozen=True)
class Watermark:
    version: int  # manifest version at checkpoint time
    step: int     # next step the rank will consume after restore

    def pack(self) -> bytes:
        return msgpack.packb({"version": self.version, "step": self.step})

    @staticmethod
    def unpack(raw: bytes) -> "Watermark":
        d = msgpack.unpackb(raw, raw=False)
        return Watermark(d["version"], d["step"])


def write_watermark(ns: Namespace, rank: int, wm: Watermark) -> None:
    """Called by the training framework after a successful checkpoint."""
    ns.store.put(ns.watermark_key(rank), wm.pack())


def read_trim_marker(ns: Namespace) -> Optional[Tuple[int, int]]:
    """Decode the trim marker: ``(safe_step, safe_version)``, or ``None`` if
    the run was never trimmed. The one place the marker's wire format is
    parsed — the reclaimer, the producer's ``max_lag`` throttle, and the ops
    fsck all read through here."""
    try:
        raw = ns.store.get(ns.trim_key())
    except (KeyError, NoSuchKey):
        return None
    d = msgpack.unpackb(raw, raw=False)
    return d["safe_step"], d.get("safe_version", -1)


def read_watermarks(ns: Namespace) -> Dict[int, Watermark]:
    out: Dict[int, Watermark] = {}
    for key in ns.store.list(ns.key("watermarks")):
        rank = int(key.rsplit("rank", 1)[-1].split(".")[0])
        try:
            out[rank] = Watermark.unpack(ns.store.get(key))
        except NoSuchKey:
            pass
    return out


def global_watermark(ns: Namespace, expected_ranks: Optional[int] = None
                     ) -> Optional[Watermark]:
    """W_global = min_i(W_i). Returns None until every expected rank has
    checkpointed at least once (conservative: no reclamation before that)."""
    wms = read_watermarks(ns)
    if not wms:
        return None
    if expected_ranks is not None and len(wms) < expected_ranks:
        return None
    return Watermark(version=min(w.version for w in wms.values()),
                     step=min(w.step for w in wms.values()))


class ReclaimStats(StatsView):
    """Registry-backed reclamation counters (``reclaimer.<instance>.*``)."""

    _FAMILY = "reclaimer"
    _SPEC = {
        "manifests_deleted": COUNTER,
        "tgbs_deleted": COUNTER,
        "bytes_reclaimed": COUNTER,
        "cycles": COUNTER,
        "obs_snaps_deleted": COUNTER,  # flight-recorder snapshots pruned
    }


class Reclaimer:
    """Background reclamation driven by checkpoint watermarks.

    The safety boundary comes from ``watermark_source`` when one is given —
    the RunManifest-aligned path: the run subsystem supplies a closure that
    reads the last *committed* RunManifest entry, so reclamation is tied to
    the unified model+data checkpoint rather than free-floating per-rank
    cursor files. Without a source it falls back to ``W_global = min_i(W_i)``
    over the per-rank watermark objects (the pre-RunManifest protocol, still
    what bare data-plane sessions use).

    Failure of this process delays reclamation but never affects correctness:
    deletions are idempotent, TGB objects immutable, and the trim marker only
    ever advances.
    """

    def __init__(self, ns: Namespace, expected_ranks: Optional[int] = None,
                 physical_delete: bool = True,
                 manifests: Optional[ManifestStore] = None,
                 watermark_source: Optional[
                     Callable[[], Optional[Watermark]]] = None,
                 obs_keep_snaps: int = 8,
                 shard_runway_windows: int = 4):
        self.ns = ns
        self.store = ns.store
        self.expected_ranks = expected_ranks
        self.physical_delete = physical_delete
        self.watermark_source = watermark_source
        # resolve the run's shard layout: a sharded run reclaims through the
        # merged view and per-shard chain GC, a legacy run is unchanged
        self.manifests = manifests if manifests is not None \
            else open_manifest_store(ns)
        # shard-chain GC runway, in snapshot windows behind each chain head.
        # Shard trimming is NOT gated on consumer watermarks (per-shard
        # versions are not derivable from the merged watermark scalar), so
        # the runway is what keeps warm readers' probe hints valid: a reader
        # stale past it re-syncs via latest_version's GC-hole LIST fallback
        # rather than decoding incrementally — pick the window count by how
        # long readers may realistically pause versus per-shard commit rate
        self.shard_runway_windows = max(1, shard_runway_windows)
        # telemetry retention rides the data lifecycle: each cycle keeps the
        # newest N flight-recorder snapshots per component (0 = keep all)
        self.obs_keep_snaps = obs_keep_snaps
        self.stats = ReclaimStats()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- trim marker ------------------------------------------------------------
    def read_trim(self) -> Tuple[int, int]:
        """Returns (safe_step, safe_version); (0, -1) if never trimmed."""
        t = read_trim_marker(self.ns)
        return t if t is not None else (0, -1)

    def _write_trim(self, safe_step: int, safe_version: int) -> None:
        self.store.put(self.ns.trim_key(), msgpack.packb(
            {"safe_step": safe_step, "safe_version": safe_version}))

    # -- one reclamation cycle --------------------------------------------------
    def run_cycle(self) -> Optional[Watermark]:
        self.stats.cycles += 1
        if self.watermark_source is not None:
            wg = self.watermark_source()
        else:
            wg = global_watermark(self.ns, self.expected_ranks)
        if wg is None:
            return None
        prev_step, prev_version = self.read_trim()
        safe_step = max(prev_step, wg.step)
        safe_version = max(prev_version, wg.version)
        if safe_step > prev_step or safe_version > prev_version:
            self._write_trim(safe_step, safe_version)  # logical trim signal
        if not self.physical_delete:
            return wg
        # -- telemetry retention: prune old flight-recorder snapshots ------------
        if self.obs_keep_snaps > 0:
            # late import: repro_torch.obs.recorder is reachable from core
            # client modules that import lifecycle during repro_torch.core
            # initialization
            from repro_torch.obs.recorder import prune_snaps
            self.stats.obs_snaps_deleted += prune_snaps(
                self.ns, keep=self.obs_keep_snaps)
        # -- physical deletion: TGB objects below the safe step ------------------
        latest = self.manifests.latest_version()
        if latest < 0:
            return wg
        view = self.manifests.load_view(latest)
        # TGBs still listed whose step < safe_step (not yet logically trimmed by
        # producers) must survive in-manifest but their *objects* are only
        # deletable once no live checkpoint can re-read them: step < safe_step.
        deletable_keys: List[Tuple[str, int]] = []
        for i, t in enumerate(view.tgbs):
            step = view.base_step + i
            if step < safe_step:
                deletable_keys.append((t.object_key, t.size_bytes))
        # plus: anything under tgb/ whose descriptor no longer appears anywhere
        # reachable — handled implicitly because trimmed manifests are deleted
        # below and object keys embed producer offsets covered by safe_step.
        for key, nbytes in deletable_keys:
            if self.store.exists(key):
                self.store.delete(key)
                self.stats.tgbs_deleted += 1
                self.stats.bytes_reclaimed += nbytes
        if isinstance(self.manifests, ShardedManifestStore):
            self._reclaim_sharded_manifests(safe_step)
            return wg
        # -- physical deletion: manifest versions below W_global.version ---------
        # Delta-format guard: versions >= safe_version may need the chain back
        # to their snapshot; keep everything from the newest snapshot at or
        # below safe_version onward.
        delete_below = safe_version
        if self.manifests.format != "flat":
            v = safe_version
            while v >= 0:
                try:
                    doc = self.manifests.read_doc(v)
                except (KeyError, NoSuchKey):
                    break
                if "snapshot_tgbs" in doc or doc.get("format") == "flat" \
                        or doc.get("parent_version", -1) < 0:
                    break
                v -= 1
            delete_below = max(0, v)
        # direct-children only: a prefix list of manifest/ on a run that was
        # ever sharded also matches shards.cfg, shard subchains, and compact
        # segments — none of which belong to this chain's version space
        prefix = self.ns.key("manifest") + "/"
        for mkey in self.store.list(prefix):
            rest = mkey[len(prefix):]
            if "/" in rest or not rest.endswith(".manifest"):
                continue
            stem = rest[: -len(".manifest")]
            if not stem.isdigit():
                continue
            if int(stem) < delete_below:
                try:
                    nbytes = self.store.head(mkey)
                except NoSuchKey:
                    continue
                self.store.delete(mkey)
                self.stats.manifests_deleted += 1
                self.stats.bytes_reclaimed += nbytes
        return wg

    def _reclaim_sharded_manifests(self, safe_step: int) -> None:
        """Sharded-run GC: trim each shard chain back to the newest snapshot
        at least ``shard_runway_windows`` snapshot windows behind its head
        (stale warm readers keep an incremental-decode runway), and drop
        compacted segments wholly below the safe step — except the newest
        segment, whose cumulative fold counts are the compactor's
        crash-recovery bookkeeping.

        A reader that pauses longer than the runway is still safe: its next
        ``latest_version(hint)`` probe lands in the GC hole, detects the
        missing hint, and re-syncs via LIST + snapshot decode instead of
        concluding the chain is idle."""
        m = self.manifests
        for shard in m.shards:
            head = shard.latest_version(hint=-1)
            horizon = head - self.shard_runway_windows * shard.snapshot_every
            if horizon <= 0:
                continue
            keep_from = None
            v = horizon
            while v >= 0:
                try:
                    doc = shard.read_doc(v)
                except (KeyError, NoSuchKey):
                    break
                if "snapshot_tgbs" in doc or doc.get("format") == "flat" \
                        or doc.get("parent_version", -1) < 0:
                    keep_from = v
                    break
                v -= 1
            if keep_from is None:
                continue
            for ver in shard.list_versions():
                if ver >= keep_from:
                    break
                mkey = shard.manifest_key(ver)
                try:
                    nbytes = self.store.head(mkey)
                except NoSuchKey:
                    continue
                self.store.delete(mkey)
                self.stats.manifests_deleted += 1
                self.stats.bytes_reclaimed += nbytes
        seqs = m.segments.seqs()
        for seq in seqs[:-1]:
            try:
                seg = m.segments.read(seq)
            except NoSuchKey:
                continue
            if seg.end_step <= safe_step:
                skey = m.segments.seg_key(seq)
                try:
                    nbytes = self.store.head(skey)
                except NoSuchKey:
                    continue
                self.store.delete(skey)
                self.stats.manifests_deleted += 1
                self.stats.bytes_reclaimed += nbytes

    # -- background thread --------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.run_cycle()
                except Exception:
                    pass  # reclamation is best-effort; next cycle retries
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="bw-reclaimer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
