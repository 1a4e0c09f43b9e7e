"""Producer client (paper §3.1 stages 1-2, §5).

Embedded in preprocessing workers. Responsibilities:

  * Stage 1 — TGB materialization: serialize preprocessing output into immutable
    TGB objects (uncoordinated, parallel across producers).
  * Stage 2 — manifest commit: publish accumulated TGBs via the conditional-put
    commit protocol, with cadence governed by a ``CommitPolicy`` (DAC by default).
  * Exactly-once: resumption state (stream offset) is persisted in lockstep with
    committed TGBs inside the manifest; a replacement process with the same
    ``producer_id`` recovers it and resumes with no duplicates and no gaps.
  * ``max_lag``: bounds how far ahead of the global watermark the producer pool
    may run, bounding peak storage even if checkpointing stalls (paper §7.5).
"""
from __future__ import annotations

import threading
import uuid
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.core.commit import CommitProtocol, ShardedCommitProtocol
from repro_torch.core.dac import CommitPolicy, DACPolicy
from repro_torch.core.errors import TransientStoreError, retry_transient
from repro_torch.core.lifecycle import read_trim_marker
from repro_torch.core.manifest import (ManifestStore, ShardedManifestStore,
                                       open_manifest_store)
from repro_torch.core.objectstore import IOPool, Namespace
from repro_torch.core.tgb import TGBBuilder, TGBDescriptor, build_uniform_tgb
from repro_torch.obs.registry import COUNTER, GAUGE, HISTOGRAM, StatsView
from repro_torch.obs.tracer import trace_span


class ProducerStats(StatsView):
    """Registry-backed producer/commit counters (``producer.<id>.*``).

    Same fields as the old dataclass, now registered in the process metrics
    registry (and therefore in flight-recorder snapshots). ``gap_samples``
    — the DAC policy's commit-gap trace — is a bounded registry histogram
    instead of an unbounded list.
    """

    _FAMILY = "producer"
    _SPEC = {
        "tgbs_written": COUNTER,
        "bytes_written": COUNTER,
        "puts_skipped": COUNTER,  # content-addressed uploads already in store
        "commit_attempts": COUNTER,
        "commit_successes": COUNTER,
        "commit_conflicts": COUNTER,
        "tgbs_committed": COUNTER,
        "bytes_committed": COUNTER,
        "manifest_bytes_written": COUNTER,
        "tau_sum": GAUGE,
        "gap_samples": HISTOGRAM,
        "throttled_time": GAUGE,
        # degraded-mode (store outage) survival
        "tgbs_spilled": COUNTER,
        "spill_replayed": COUNTER,
        "commits_deferred": COUNTER,
        "store_degraded": GAUGE,
    }

    @property
    def success_rate(self) -> float:
        return self.commit_successes / max(1, self.commit_attempts)


class Producer:
    """One preprocessing worker's BatchWeave producer client."""

    def __init__(self, ns: Namespace, producer_id: str,
                 dp: int, cp: int,
                 policy: Optional[CommitPolicy] = None,
                 manifests: Optional[ManifestStore] = None,
                 max_lag: Optional[int] = None,
                 epoch: int = 0,
                 pipeline_commits: bool = False,
                 io_pool: Optional[IOPool] = None,
                 obs_snap_interval_s: Optional[float] = None,
                 spill_limit: Optional[int] = None):
        self.ns = ns
        self.store = ns.store
        self.clock = self.store.clock
        self.producer_id = producer_id
        self.dp = dp
        self.cp = cp
        self.policy = policy or DACPolicy()
        # default resolves the run's shard layout from storage: a sharded run
        # yields a ShardedManifestStore, a legacy run the byte-identical
        # single-chain ManifestStore
        self.manifests = manifests if manifests is not None \
            else open_manifest_store(ns)
        # a sharded manifest plane gets the sharded protocol (same surface):
        # home-shard commits, DAC shard choice, cross-shard exactly-once
        if isinstance(self.manifests, ShardedManifestStore):
            self.protocol: CommitProtocol = ShardedCommitProtocol(
                self.manifests, producer_id, epoch=epoch)
        else:
            self.protocol = CommitProtocol(self.manifests, producer_id,
                                           epoch=epoch)
        self.max_lag = max_lag
        self.stats = ProducerStats(producer_id)
        # optional flight recorder: periodic registry snapshots published to
        # <ns>/obs/<scope>/ so operators can read this producer's counters
        # from storage alone (including post-mortem). Never on the data path:
        # snap errors are swallowed and counted by the recorder itself.
        self._recorder = None
        if obs_snap_interval_s is not None:
            from repro_torch.obs.recorder import FlightRecorder
            self._recorder = FlightRecorder(ns, self.stats.metric_scope,
                                            interval_s=obs_snap_interval_s)
        # stream offset of the next TGB this producer will create
        self.next_offset = 0
        # TGBs written to the store but not yet visible in a committed manifest
        self.pending: List[TGBDescriptor] = []
        # Commit pipelining: run the manifest conditional-put on a pool thread
        # so the next TGB builds/uploads while it is in flight. Cadence (DAC
        # gap) semantics are unchanged: the policy is still fed each attempt's
        # outcome at its completion time, and at most one attempt is ever in
        # flight.
        self.pipeline_commits = pipeline_commits
        self._io_pool = io_pool
        self._commit_future: Optional[Future] = None
        self._commit_lock = threading.Lock()
        # Degraded-mode survival (store outage): built TGBs whose upload (or
        # whose predecessors' uploads) failed wait here as (key, blob, desc,
        # content_addressed) and are replayed strictly in producer_seq order
        # once the store answers again — descriptors only enter ``pending``
        # after their bytes are durable, so commit order and exactly-once are
        # preserved across the outage. ``spill_limit=None`` disables spilling
        # (original fail-on-upload behavior).
        self.spill_limit = spill_limit
        self._spill: Deque[Tuple[str, bytes, TGBDescriptor, bool]] = deque()
        # last successfully read trim marker, reused when the probe is flaky
        self._last_safe_step = 0

    @property
    def io_pool(self) -> IOPool:
        if self._io_pool is None:
            self._io_pool = IOPool.default()
        return self._io_pool

    # ------------------------------------------------------------------
    def recover(self) -> int:
        """Restart path: resume from the durable resumption state (§5.3).

        Returns the stream offset to resume from. Any objects this incarnation's
        predecessor wrote beyond the committed offset are orphans (invisible,
        reclaimed later); we simply re-produce from offset+1 — exactly-once
        *visibility* is what matters and the manifest enforces it.
        """
        committed = self.protocol.recover_offset()
        self.next_offset = committed + 1
        self.pending = []
        return self.next_offset

    # ------------------------------------------------------------------
    def write_tgb(self, slice_payloads=None, uniform_slice_bytes: Optional[int] = None,
                  num_samples: int = 0, token_count: int = 0,
                  provenance: Optional[dict] = None,
                  content_token: Optional[str] = None) -> TGBDescriptor:
        """Stage 1: materialize one TGB object (no coordination).

        ``provenance`` (derived streams, see ``repro.graph``) embeds the
        derivation record in the footer and the descriptor. ``content_token``
        makes the object key *content-addressed*: the key becomes a pure
        function of (producer, offset, token), so a replayed derivation lands
        on the same key — an existence probe then skips the upload entirely
        (exactly-once derivation as a storage property, not a worker one).
        """
        offset = self.next_offset
        tgb_id = f"{self.producer_id}-{offset:012d}"
        token = content_token or uuid.uuid4().hex[:8]
        key = self.ns.tgb_key(self.producer_id, offset, token)
        with trace_span("producer.build", cat="commit", offset=offset):
            if slice_payloads is not None:
                b = TGBBuilder(tgb_id, self.dp, self.cp, self.producer_id,
                               offset, num_samples=num_samples,
                               token_count=token_count, provenance=provenance)
                for (d, c), payload in slice_payloads.items():
                    b.add_slice(d, c, payload)
                blob = b.build()
            else:
                blob = build_uniform_tgb(tgb_id, self.dp, self.cp,
                                         self.producer_id, offset,
                                         uniform_slice_bytes or 1024,
                                         num_samples=num_samples,
                                         token_count=token_count)
        desc = TGBDescriptor(
            tgb_id=tgb_id, object_key=key, size_bytes=len(blob),
            dp=self.dp, cp=self.cp, num_samples=num_samples,
            token_count=token_count, producer_id=self.producer_id,
            producer_seq=offset, provenance=provenance)
        content_addressed = content_token is not None
        self._try_replay_spill()
        if self._spill:
            # earlier TGBs are still waiting on the store: this one must queue
            # behind them (descriptors enter ``pending`` in seq order)
            self._enqueue_spill(key, blob, desc, content_addressed, None)
            self.next_offset = offset + 1
            return desc
        try:
            self._upload_blob(key, blob, offset, content_addressed)
        except TransientStoreError as e:
            if self.spill_limit is None:
                # without spilling the offset is NOT consumed: the caller may
                # retry write_tgb and reuse it (no gap in the stream)
                raise
            self._enqueue_spill(key, blob, desc, content_addressed, e)
            self.next_offset = offset + 1
            return desc
        self._accept(desc, len(blob))
        self.next_offset = offset + 1
        return desc

    def _upload_blob(self, key: str, blob: bytes, offset: int,
                     content_addressed: bool) -> None:
        # TGB objects are immutable and keyed by (producer, offset, token), so
        # retrying the same PUT after a transient 5xx is idempotent — "lost"
        # writes are simply written again. Content-addressed objects are
        # additionally *deduplicated*: if the key already exists the bytes are
        # byte-identical by construction, so the upload is skipped.
        if content_addressed and \
                retry_transient(lambda: self.store.exists(key), self.clock):
            self.stats.puts_skipped += 1
        else:
            with trace_span("producer.upload", cat="commit", offset=offset,
                            bytes=len(blob)):
                retry_transient(lambda: self.store.put(key, blob), self.clock)

    def _accept(self, desc: TGBDescriptor, nbytes: int) -> None:
        """The TGB's bytes are durable: it may now be offered for commit."""
        self.pending.append(desc)
        self.stats.tgbs_written += 1
        self.stats.bytes_written += nbytes

    def _enqueue_spill(self, key: str, blob: bytes, desc: TGBDescriptor,
                       content_addressed: bool,
                       cause: Optional[Exception]) -> None:
        if self.spill_limit is not None and \
                len(self._spill) >= self.spill_limit:
            # bounded queue full: surface the storage failure as backpressure
            raise TransientStoreError(
                f"{self.producer_id}: spill queue full "
                f"({self.spill_limit} TGBs)") from cause
        self._spill.append((key, blob, desc, content_addressed))
        self.stats.tgbs_spilled += 1
        self.stats.store_degraded = 1.0

    @property
    def spill_full(self) -> bool:
        return self.spill_limit is not None and \
            len(self._spill) >= self.spill_limit

    @property
    def spilled(self) -> int:
        return len(self._spill)

    def _try_replay_spill(self) -> bool:
        """Replay spilled TGBs strictly in producer_seq order; stop at the
        first upload that still fails. Returns True iff the queue drained."""
        while self._spill:
            key, blob, desc, content_addressed = self._spill[0]
            try:
                self._upload_blob(key, blob, desc.producer_seq,
                                  content_addressed)
            except TransientStoreError:
                return False
            self._spill.popleft()
            self._accept(desc, len(blob))
            self.stats.spill_replayed += 1
        if self.stats.store_degraded:
            self.stats.store_degraded = 0.0
        return True

    # ------------------------------------------------------------------
    def maybe_commit(self, trim_to_step: Optional[int] = None, force: bool = False) -> bool:
        """Attempt a commit if the policy's cadence allows. Returns True iff a
        commit attempt completed successfully during this call (in pipelined
        mode a freshly scheduled attempt reports on a later call)."""
        if self._recorder is not None:
            self._recorder.maybe_snap()
        if self._spill:
            self._try_replay_spill()
        try:
            if self.pipeline_commits:
                ok = self._maybe_commit_pipelined(trim_to_step, force)
            else:
                ok = self._commit_sync(self.pending, trim_to_step, force)
            if ok and not self._spill and self.stats.store_degraded:
                self.stats.store_degraded = 0.0
            return ok
        except TransientStoreError:
            # Degraded mode: the manifest put (or its read-back) is failing
            # against a browning-out store. With spilling enabled the commit
            # is *deferred*, not fatal — pending TGBs stay queued and the next
            # cadence tick retries; without spilling the caller keeps the
            # original fail-loud behavior.
            if self.spill_limit is None:
                raise
            self.stats.commits_deferred += 1
            self.stats.store_degraded = 1.0
            return False

    def _commit_sync(self, batch: List[TGBDescriptor],
                     trim_to_step: Optional[int], force: bool) -> bool:
        now = self.clock.now()
        if not force and not self.policy.should_attempt(len(batch), now):
            return False
        if not batch:
            return False
        result, still_pending = self.protocol.try_commit(
            batch, trim_to_step=trim_to_step)
        with self._commit_lock:
            self.stats.commit_attempts += 1
            self.stats.tau_sum += result.tau_obs
            self.stats.manifest_bytes_written += result.manifest_bytes
            if result.success:
                self.stats.commit_successes += 1
                self.stats.tgbs_committed += result.committed_tgbs
                self.stats.bytes_committed += sum(t.size_bytes for t in batch)
                if batch is self.pending:
                    self.pending = []
            else:
                self.stats.commit_conflicts += 1
                if batch is self.pending:
                    self.pending = still_pending
                else:  # pipelined snapshot: re-queue ahead of newer TGBs
                    self.pending[:0] = still_pending
            self.policy.on_outcome(result.success, result.tau_obs,
                                   result.n_producers, self.clock.now())
            if isinstance(self.policy, DACPolicy):
                self.stats.gap_samples.append(self.policy.gap)
        return result.success

    def _maybe_commit_pipelined(self, trim_to_step: Optional[int],
                                force: bool) -> bool:
        """Schedule the conditional-put on the IOPool and return immediately;
        TGB build/upload for the next batch overlaps the in-flight commit."""
        reaped = False
        fut = self._commit_future
        if fut is not None:
            if not force and not fut.done():
                return False  # one attempt in flight; keep producing
            reaped = bool(fut.result())  # force waits for the in-flight put
            self._commit_future = None
        if force:
            return self._commit_sync(self.pending, trim_to_step, True) or reaped
        if self.pending and self.policy.should_attempt(len(self.pending),
                                                       self.clock.now()):
            batch, self.pending = self.pending, []
            self._commit_future = self.io_pool.submit(
                self._commit_sync, batch, trim_to_step, True)
        return reaped

    def finalize(self, max_attempts: int = 1000) -> None:
        """Drain remaining uncommitted TGBs before exiting (Alg. 1 finalization)."""
        attempts = 0
        while (self.pending or self._spill) and attempts < max_attempts:
            ok = self.maybe_commit(force=True)
            attempts += 1
            if not ok and (self.pending or self._spill):
                # brief backoff using the policy's current notion of gap
                gap = getattr(self.policy, "gap", 0.01) or 0.01
                self.clock.sleep(min(gap, 0.25))
        if self.pending or self._spill:
            raise RuntimeError(f"{self.producer_id}: finalize failed to drain "
                               f"{len(self.pending)} pending + "
                               f"{len(self._spill)} spilled TGBs")
        if isinstance(self.protocol, ShardedCommitProtocol):
            # make everything this producer committed merge-stable: bump every
            # lagging shard chain up to the global head before exiting
            try:
                self.protocol.flush_frontier()
            except TransientStoreError:
                pass  # consumers catch up on the next heartbeat/compaction
        if self._recorder is not None:
            self._recorder.close()  # last-word snapshot for post-mortems

    # ------------------------------------------------------------------
    def lag_exceeded(self) -> bool:
        """True if production should pause: published-but-unconsumed TGBs exceed
        max_lag relative to the trim marker (W_global surrogate)."""
        if self.max_lag is None:
            return False
        if isinstance(self.protocol, ShardedCommitProtocol):
            steps = self.protocol.visible_steps()
        else:
            steps = self.protocol.view.total_steps
        try:
            trim = read_trim_marker(self.ns)
            self._last_safe_step = trim[0] if trim is not None else 0
        except TransientStoreError:
            # Flaky probe: reuse the last successfully read trim step. The
            # old behavior (treat the read as step 0) silently stalled the
            # pool — with a real trim marker at step N, one 5xx made every
            # producer look max_lag ahead and pause until the next clean read.
            pass
        ahead = (steps + len(self.pending)) - self._last_safe_step
        return ahead >= self.max_lag


def run_producer_loop(producer: Producer, n_tgbs: int,
                      slice_bytes: int,
                      stop: Optional[threading.Event] = None,
                      produce_delay_s: float = 0.0,
                      payload_fn: Optional[Callable[[int], dict]] = None,
                      deadline_s: Optional[float] = None) -> ProducerStats:
    """Drive a producer for ``n_tgbs`` TGBs (benchmark/ingest helper thread body)."""
    clock = producer.clock
    t_start = clock.now()
    produced = 0
    while produced < n_tgbs:
        if stop is not None and stop.is_set():
            break
        if deadline_s is not None and clock.now() - t_start > deadline_s:
            break
        if producer.lag_exceeded() or producer.spill_full:
            t0 = clock.now()
            clock.sleep(0.05)
            producer.stats.throttled_time += clock.now() - t0
            producer.maybe_commit()  # also replays spilled TGBs when possible
            continue
        if produce_delay_s:
            clock.sleep(produce_delay_s)
        if payload_fn is not None:
            producer.write_tgb(slice_payloads=payload_fn(producer.next_offset))
        else:
            producer.write_tgb(uniform_slice_bytes=slice_bytes)
        produced += 1
        producer.maybe_commit()
    producer.finalize()
    return producer.stats
