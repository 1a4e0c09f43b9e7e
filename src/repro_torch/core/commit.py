"""Commit & rebase protocol (paper §5.1).

A producer commits by (1) starting from its current local view ``M_v``,
(2) constructing candidate ``M_{v+1}`` appending its local TGB references plus
updated producer metadata, (3) attempting a conditional put on
``(v+1).manifest``. On conflict it fetches the winner, **rebases** (append-only
union merge, deduplicating its own already-committed TGBs via the persisted
producer state map — the exactly-once invariant), and retries later (cadence is
the commit policy's job, not this module's).

Version numbers are strictly monotone and never reused: no ABA hazard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.errors import TransientStoreError, retry_transient
from repro_torch.core.manifest import (DatasetView, ManifestStore,
                                       ProducerState, ShardedManifestStore)
from repro_torch.core.objectstore import NoSuchKey
from repro_torch.core.tgb import TGBDescriptor
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView
from repro_torch.obs.tracer import trace_span


@dataclass
class CommitResult:
    success: bool
    version: int            # committed version on success; latest known otherwise
    tau_obs: float          # fragile-window observation (read->write-attempt time)
    n_producers: int        # producer-pool size read from committed state
    committed_tgbs: int = 0
    manifest_bytes: int = 0


class CommitProtocol:
    """Stateful commit client for one producer."""

    #: bounded retry budget for control-plane reads hit by transient faults
    READ_RETRIES = 4

    def __init__(self, manifests: ManifestStore, producer_id: str,
                 epoch: int = 0, active_window: Optional[int] = None):
        self.manifests = manifests
        self.producer_id = producer_id
        self.epoch = epoch
        #: when set, ``n_producers`` reported to the commit policy counts only
        #: producers whose last commit landed within this many versions of the
        #: chain head (a storage-only recency window) — on sharded runs this
        #: is what keeps DAC's dynamic N per-shard instead of global
        self.active_window = active_window
        self.view: DatasetView = DatasetView()
        self.clock = manifests.store.clock

    def n_active(self) -> int:
        """Producer-pool size as seen by the commit policy (paper's dynamic
        N): all producers ever seen, or only recently committing ones when
        ``active_window`` is set."""
        producers = self.view.producers
        if self.active_window is None:
            return max(1, len(producers))
        floor = self.view.version - self.active_window
        return max(1, sum(1 for st in producers.values()
                          if st.last_commit_version >= floor))

    # ------------------------------------------------------------------
    def _retrying(self, fn: Callable):
        """Run a read-only storage closure, retrying transient store errors
        and stale-read misses (a NoSuchKey for a version the probe just saw)
        with short backoff. Reads are idempotent, so this never changes
        protocol semantics — it only rides out 5xx/staleness windows."""
        return retry_transient(fn, self.clock, attempts=self.READ_RETRIES,
                               retry_on=(TransientStoreError, NoSuchKey))

    def refresh(self) -> DatasetView:
        """Catch up the local view to the latest committed manifest."""
        latest = self._retrying(
            lambda: self.manifests.latest_version(hint=self.view.version))
        if latest > self.view.version:
            self.view = self._retrying(
                lambda: self.manifests.load_view(latest, base=self.view))
        return self.view

    def _dedup_pending(self, pending: List[TGBDescriptor]) -> List[TGBDescriptor]:
        """Drop pending TGBs already visible in the committed view (their
        producer_seq <= our committed offset). This is what makes rebase
        exactly-once: a TGB that made it into a winner manifest is never
        appended twice."""
        committed = self.view.producer_offset(self.producer_id)
        return [t for t in pending if t.producer_seq > committed]

    def try_commit(self, pending: List[TGBDescriptor],
                   trim_to_step: Optional[int] = None) -> Tuple[CommitResult, List[TGBDescriptor]]:
        """One commit attempt, per Algorithm 1: READ the current manifest
        version, construct the candidate, submit via conditional put.

        Returns (result, still_pending). The fragile window tau spans from the
        version read through completion of the conditional write (Alg. 1
        l.6-8) — the read-at-attempt-start matters: attempting from a stale
        cached view after a DAC gap would conflict almost surely regardless of
        cadence (the paper notes staleness only costs extra failed writes;
        the ALGORITHM reads first)."""
        t0 = self.clock.now()
        with trace_span("commit.refresh", cat="commit"):
            self.refresh()
        pending = self._dedup_pending(pending)
        if not pending:
            # nothing to publish; treat as trivially successful with zero I/O
            return (CommitResult(True, self.view.version, 0.0,
                                 self.n_active()), [])
        new_offset = max(t.producer_seq for t in pending)
        producers = dict(self.view.producers)
        producers[self.producer_id] = ProducerState(
            committed_offset=new_offset,
            last_commit_version=self.view.version + 1,
            epoch=self.epoch)
        with trace_span("commit.encode", cat="commit"):
            version, raw = self.manifests.encode_candidate(
                self.view, pending, producers, trim_to_step=trim_to_step)
        try:
            with trace_span("commit.cput", cat="commit", version=version,
                            bytes=len(raw)):
                ok = self.manifests.try_put_version(version, raw)
        except TransientStoreError:
            with trace_span("commit.resolve", cat="commit", version=version):
                ok = self._resolve_ambiguous_put(version, new_offset)
        tau = self.clock.now() - t0
        if ok:
            # our candidate is now the authoritative state: update local view
            self.view = self._retrying(
                lambda: self.manifests.load_view(version, base=self.view))
            return (CommitResult(True, version, tau, self.n_active(),
                                 committed_tgbs=len(pending),
                                 manifest_bytes=len(raw)), [])
        # conflict: rebase onto the winner(s)
        with trace_span("commit.rebase", cat="commit", version=version):
            self.refresh()
            still = self._dedup_pending(pending)
        return (CommitResult(False, self.view.version, tau,
                             self.n_active(),
                             manifest_bytes=len(raw)), still)

    def _resolve_ambiguous_put(self, version: int, new_offset: int) -> bool:
        """A conditional put raised a transient error: the write may or may
        not have landed (lost ack). The version object is immutable once
        named, so re-reading it resolves the ambiguity exactly:

          * version exists and its producer map records our id at
            ``new_offset`` -> our put won before the error (success);
          * version exists but is someone else's candidate -> ordinary
            conflict (rebase path);
          * version absent -> the request never reached the store (also the
            conflict path: rebase finds nothing new and the next attempt
            simply retries the same version).

        Even if this probe itself keeps failing, correctness holds: we report
        a conflict, and ``_dedup_pending`` after a later ``refresh`` drops
        any TGBs that did land — exactly-once never depends on this answer
        being right, only commit-attempt accounting does.
        """
        def probe() -> bool:
            try:
                doc = self.manifests.read_doc(version)
            except (KeyError,):  # NoSuchKey: the put never landed
                return False
            row = doc.get("producers", {}).get(self.producer_id)
            if row is None:
                return False
            st = ProducerState.unpack(row)
            return (st.committed_offset == new_offset
                    and st.epoch == self.epoch
                    and st.last_commit_version == version)

        try:
            return bool(self._retrying(probe))
        except TransientStoreError:
            return False

    def heartbeat(self) -> bool:
        """Advance this chain by one EMPTY commit: no entries, producer map
        unchanged. Sharded producers use this to bump lagging shard chains so
        the stable frontier (min over shard head versions) keeps moving — an
        idle shard must not stall global visibility. Deliberately does NOT
        add this producer to the chain's map, so per-shard active-producer
        counts (DAC's N, the shard chooser's load signal) stay clean."""
        self.refresh()
        version, raw = self.manifests.encode_candidate(
            self.view, [], dict(self.view.producers))
        try:
            ok = self.manifests.try_put_version(version, raw)
        except TransientStoreError:
            ok = False
        if ok:
            self.view = self._retrying(
                lambda: self.manifests.load_view(version, base=self.view))
        return ok

    # ------------------------------------------------------------------
    def recover_offset(self) -> int:
        """Producer restart: read the durable resumption state for our
        producer_id from the latest manifest (paper §5.3)."""
        self.refresh()
        return self.view.producer_offset(self.producer_id)


# ---------------------------------------------------------------------------
# Sharded commit protocol (ROADMAP item 4)
# ---------------------------------------------------------------------------

class ShardStats(StatsView):
    """Registry-backed shard-commit counters (``manifest.shard.<id>.*``)."""

    _FAMILY = "manifest.shard"
    _SPEC = {
        "commits": COUNTER,        # successful data commits on the home shard
        "conflicts": COUNTER,      # lost conditional puts (before rebase)
        "heartbeats": COUNTER,     # empty commits issued to lagging shards
        "switches": COUNTER,       # DAC shard-choice moves
        "merged_dedups": COUNTER,  # pending TGBs dropped by cross-shard dedup
        "frontier_lag": GAUGE,     # home-shard head minus stable frontier
        "shard_id": GAUGE,         # current home shard index
    }


class ShardedCommitProtocol:
    """Commit client over K shard chains: same surface as CommitProtocol.

    Each producer commits to ONE home shard at a time (hash-by-producer
    default), chosen and re-chosen by the DAC shard extension
    (:class:`repro.core.dac.ShardChooser`) from observed per-shard conflict
    and load stats — never from inter-producer communication. Cross-shard
    exactly-once: pending TGBs are pre-deduplicated against the max committed
    offset across ALL shard maps (refreshed on recover and on every shard
    switch, cached monotonically in between), so a batch that landed on the
    old home shard is never re-appended to the new one.

    Logical trim is the compactor's job on sharded runs; ``trim_to_step`` is
    accepted for interface parity and ignored.
    """

    #: max empty commits per shard per frontier sync (liveness, not a quota)
    HEARTBEAT_ATTEMPTS = 8

    def __init__(self, manifests: ShardedManifestStore, producer_id: str,
                 epoch: int = 0, active_window: Optional[int] = 16,
                 chooser=None, heartbeat_every: int = 4,
                 sync_interval_s: float = 1.0,
                 stats: Optional[ShardStats] = None):
        from repro_torch.core.dac import ShardChooser  # local: avoid import cycle

        self.manifests = manifests
        self.producer_id = producer_id
        self.epoch = epoch
        self.active_window = active_window
        self.clock = manifests.store.clock
        self.chooser = chooser if chooser is not None else ShardChooser(
            manifests.n_shards, producer_id)
        self.heartbeat_every = max(1, heartbeat_every)
        self.sync_interval_s = sync_interval_s
        self.stats = stats or ShardStats(producer_id)
        self.stats.shard_id = float(self.chooser.shard)
        self._subs: Dict[int, CommitProtocol] = {}
        self._merged_offset = -1   # monotone max across shards (cross-shard dedup)
        # (commit version, shard index) that carried our newest committed
        # entry: the merge sort key our NEXT data commit must exceed, so the
        # global order stays a merge of per-producer streams across shard
        # switches (fsck audits this as step-sequence-regression)
        self._last_key: Tuple[int, int] = (-1, -1)
        self._successes = 0
        self._synced_successes = 0
        self._last_sync = self.clock.now()
        # shard head versions as of the previous frontier sweep: a shard that
        # moved on its own since then has live committers and needs no
        # heartbeat from us (the frontier is advancing without our help)
        self._last_seen: Dict[int, int] = {}

    # -- plumbing -----------------------------------------------------------
    def _sub(self, shard: int) -> CommitProtocol:
        sub = self._subs.get(shard)
        if sub is None:
            sub = CommitProtocol(self.manifests.shards[shard],
                                 self.producer_id, epoch=self.epoch,
                                 active_window=self.active_window)
            self._subs[shard] = sub
        return sub

    @property
    def shard(self) -> int:
        return self.chooser.shard

    @property
    def view(self) -> DatasetView:
        """The home shard's view (per-shard DAC inputs read through here)."""
        return self._sub(self.shard).view

    def visible_steps(self) -> int:
        """Global steps known committed: the sum of every shard chain's entry
        count (trimmed + live) as of the last refresh of each sub-protocol.
        A lower bound — shards this producer has not probed recently may be
        ahead — which is the safe direction for max_lag throttling."""
        return sum(sub.view.total_steps for sub in self._subs.values())

    def refresh(self) -> DatasetView:
        return self._sub(self.shard).refresh()

    # -- commits ------------------------------------------------------------
    def try_commit(self, pending: List[TGBDescriptor],
                   trim_to_step: Optional[int] = None
                   ) -> Tuple[CommitResult, List[TGBDescriptor]]:
        del trim_to_step  # sharded trim is compactor-owned
        t0 = self.clock.now()
        before = len(pending)
        pending = [t for t in pending if t.producer_seq > self._merged_offset]
        self.stats.merged_dedups += before - len(pending)
        shard = self.chooser.shard
        sub = self._sub(shard)
        if pending and shard != self._last_key[1] and self._last_key[0] >= 0:
            try:
                self._pad_for_order(sub, shard)
            except TransientStoreError:
                # couldn't establish ordering; surface as a conflict so the
                # caller retries (the pad resumes on the next attempt).
                # tau_obs is the real elapsed attempt time, never 0.0: an
                # EMA fed zeros here would SHRINK the DAC gap exactly when
                # the destination chain is unhealthy — the opposite of
                # backing off.
                self.stats.conflicts += 1
                return (CommitResult(False, sub.view.version,
                                     self.clock.now() - t0,
                                     sub.n_active()), pending)
        result, still = sub.try_commit(pending)
        self.chooser.observe(result.success)
        if result.success:
            self.stats.commits += 1
            self._successes += 1
            self._merged_offset = max(
                self._merged_offset, sub.view.producer_offset(self.producer_id))
            if result.committed_tgbs > 0:
                self._last_key = max(self._last_key, (result.version, shard))
            # frontier maintenance is paced by the CLOCK, not the commit
            # count: with many live producers the frontier advances from
            # their data commits alone, and per-commit sweeps (K-1 refreshes
            # each) would eat the very throughput sharding buys
            now = self.clock.now()
            if (self._successes - self._synced_successes >= self.heartbeat_every
                    and now - self._last_sync >= self.sync_interval_s):
                self._frontier_sync(target=sub.view.version)
                self._synced_successes = self._successes
                self._last_sync = now
        else:
            self.stats.conflicts += 1
            self._maybe_switch()
        return result, still

    def _shard_load(self, k: int) -> int:
        """Active-producer count of shard ``k`` from its latest doc alone
        (both codecs carry the full producer map) — never a view
        reconstruction, which on delta chains would walk the whole gap."""
        store_k = self.manifests.shards[k]
        sub = self._sub(k)
        try:
            head = store_k.latest_version(
                hint=max(self._last_seen.get(k, -1), sub.view.version))
            if head < 0:
                return 1
            doc = store_k.read_doc(head)
        except (TransientStoreError, KeyError):
            return sub.n_active()  # stale load estimate is acceptable
        self._last_seen[k] = max(self._last_seen.get(k, -1), head)
        producers = doc.get("producers", {})
        if self.active_window is None:
            return max(1, len(producers))
        floor = head - self.active_window
        return max(1, sum(
            1 for row in producers.values()
            if ProducerState.unpack(row).last_commit_version >= floor))

    def _maybe_switch(self) -> None:
        if not self.chooser.should_probe():
            return
        loads = [self._shard_load(k) for k in range(self.manifests.n_shards)]
        new = self.chooser.choose(loads)
        if new == self.chooser.shard:
            return
        # the old home shard may still be absorbing an ambiguous put of
        # ours: re-derive the cross-shard committed offset BEFORE homing on
        # the new shard — moving first would leave a window where a commit
        # lands on the new home with a stale dedup floor and re-appends
        # TGBs the old shard already absorbed. If the sweep keeps failing,
        # stay put: the next conflict re-probes and retries the move.
        try:
            merged = retry_transient(
                lambda: self.manifests.merged_producer_offset(
                    self.producer_id),
                self.clock, attempts=CommitProtocol.READ_RETRIES,
                retry_on=(TransientStoreError, NoSuchKey))
        except (TransientStoreError, NoSuchKey):
            return
        self._merged_offset = max(self._merged_offset, merged)
        self.chooser.move_to(new)
        self.stats.switches += 1
        self.stats.shard_id = float(new)

    def _pad_for_order(self, sub: CommitProtocol, shard: int) -> None:
        """Make the next candidate key sort after our newest committed entry.

        The merged view orders entries by (commit version, shard index).
        After a shard switch the new home's chain can be BEHIND the version
        that carried our last entry, which would merge our next batch before
        it — breaking the per-producer order fsck audits. Pad the destination
        chain with empty commits until ``(head + 1, shard)`` exceeds the
        recorded key. Every round advances the head by at least one (our
        empty commit or a concurrent winner's), so this terminates within
        the inter-shard version skew — which the frontier sweeps keep small.
        """
        floor = self._last_key
        if (sub.view.version + 1, shard) > floor:
            return
        sub.refresh()
        budget = max(16, 2 * (floor[0] - sub.view.version))
        while (sub.view.version + 1, shard) <= floor:
            if budget <= 0:
                raise TransientStoreError(
                    f"shard {shard} chain not advancing toward order floor "
                    f"{floor}")
            budget -= 1
            if sub.heartbeat():
                self.stats.heartbeats += 1

    # -- frontier maintenance ------------------------------------------------
    def _frontier_sync(self, target: int, drive: bool = False) -> None:
        """Advance the stable frontier toward ``target``.

        Periodic sweeps (``drive=False``) are cheap by design: one HEAD
        gallop per shard to learn its chain head (never a view
        reconstruction — on delta chains that would download every doc of
        every shard), and an empty commit only for a shard that is both
        lagging and IDLE (its head has not moved since our previous sweep).
        A shard with live committers reaches ``target`` from data commits
        alone — heartbeating it would just burn its conditional-put
        bandwidth and pad its chain. ``drive=True`` (finalize) pushes every
        lagging shard all the way to ``target`` so a quiesced run is fully
        consumable."""
        own = self.chooser.shard
        for k in range(self.manifests.n_shards):
            if k == own:
                continue
            sub = self._sub(k)
            seen = self._last_seen.get(k, -1)
            try:
                if drive:
                    sub.refresh()
                    head = sub.view.version
                else:
                    head = self.manifests.shards[k].latest_version(
                        hint=max(seen, sub.view.version))
            except TransientStoreError:
                continue
            idle = head <= seen
            self._last_seen[k] = max(seen, head)
            if head >= target:
                continue
            budget = self.HEARTBEAT_ATTEMPTS if drive else (1 if idle else 0)
            attempts = 0
            while attempts < budget and head < target:
                try:
                    # heartbeat() refreshes internally, so the view (and our
                    # head estimate) is current whether or not the put wins
                    if sub.heartbeat():
                        self.stats.heartbeats += 1
                except TransientStoreError:
                    break
                head = sub.view.version
                self._last_seen[k] = max(self._last_seen[k], head)
                attempts += 1
        own_head = self._sub(own).view.version
        heads = [self._last_seen.get(k, -1) for k in
                 range(self.manifests.n_shards) if k != own]
        if heads and min(heads) >= 0:
            self.stats.frontier_lag = float(own_head - min(min(heads),
                                                           own_head))

    def flush_frontier(self) -> None:
        """Bring every shard chain up to the global head version so ALL
        committed entries are stable — producers call this at finalize, which
        is what makes a quiesced run fully consumable."""
        for k in range(self.manifests.n_shards):
            try:
                self._sub(k).refresh()
            except TransientStoreError:
                pass
        target = max(sub.view.version for sub in self._subs.values())
        self._frontier_sync(target=target, drive=True)
        # _frontier_sync skips the home shard; it may itself be the laggard
        own = self._sub(self.chooser.shard)
        attempts = 0
        while own.view.version < target and attempts < self.HEARTBEAT_ATTEMPTS:
            if own.heartbeat():
                self.stats.heartbeats += 1
            else:
                own.refresh()
            attempts += 1

    # -- recovery ------------------------------------------------------------
    def recover_offset(self) -> int:
        """Producer restart: the durable resumption offset is the MAX across
        every shard chain's producer map (the dead incarnation may have been
        committing to any shard). Also restores the merge-order floor: the
        (commit version, shard) that carried the newest entry, so the first
        post-restart commit pads correctly if it lands on a different shard.
        """
        best = -1
        floor = (-1, -1)
        for k, shard in enumerate(self.manifests.shards):
            latest = shard.latest_version(hint=-1)
            if latest < 0:
                continue
            row = shard.read_doc(latest).get(
                "producers", {}).get(self.producer_id)
            if row is None:
                continue
            st = ProducerState.unpack(row)
            if st.committed_offset > best:
                best = st.committed_offset
                floor = (st.last_commit_version, k)
        self._merged_offset = max(self._merged_offset, best)
        self._last_key = max(self._last_key, floor)
        self._sub(self.chooser.shard).refresh()
        return best
