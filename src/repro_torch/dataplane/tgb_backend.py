"""`tgb` backend: the paper's object-store-native data plane.

Maps the facade onto the BatchWeave clients:

  writer  -> ``repro.core.Producer``  (TGB materialization + DAC-gated
             conditional-put manifest commits; ``__enter__`` recovers the
             durable stream offset, ``__exit__`` finalizes)
  reader  -> ``repro.core.Consumer``  (per-rank range reads, footer cache,
             prefetch, topology remap)
  Checkpoint("tgb", V, S) -> the consumer cursor <V, S>

The session additionally exposes the lifecycle half of the paper:
``save_watermark`` (rank checkpoints publish W_i) and ``reclaim`` (trim
everything below W_global).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.consumer import (Consumer, MeshPosition,
                                       convert_logical_step,
                                       floor_to_data_step)
from repro_torch.core.dac import CommitPolicy
from repro_torch.core.lifecycle import Reclaimer, Watermark, write_watermark
from repro_torch.core.manifest import ManifestStore, open_manifest_store
from repro_torch.core.objectstore import IOPool, Namespace, ObjectStore
from repro_torch.core.producer import Producer
from repro_torch.core.resilience import wrap_store
from repro_torch.dataplane._base import PackingWriterMixin, SessionBase
from repro_torch.dataplane.types import (Batch, Checkpoint, Topology,
                                         UnsupportedOperation)


class TGBWriter(PackingWriterMixin):
    """Context-managed producer: recover on enter, finalize on clean exit."""

    def __init__(self, ns: Namespace, topology: Topology, writer_id: str,
                 policy: Optional[CommitPolicy] = None,
                 max_lag: Optional[int] = None,
                 pipeline_commits: bool = False,
                 io_pool: Optional[IOPool] = None,
                 obs_snap_interval_s: Optional[float] = None,
                 spill_limit: Optional[int] = None,
                 manifests: Optional[ManifestStore] = None):
        self.topology = topology
        self.writer_id = writer_id
        self.producer = Producer(ns, writer_id, dp=topology.dp, cp=topology.cp,
                                 policy=policy,
                                 manifests=manifests or open_manifest_store(ns),
                                 max_lag=max_lag,
                                 pipeline_commits=pipeline_commits,
                                 io_pool=io_pool,
                                 obs_snap_interval_s=obs_snap_interval_s,
                                 spill_limit=spill_limit)
        self.recovered_offset = 0

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "TGBWriter":
        self.recovered_offset = self.producer.recover()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.producer.finalize()
        return False

    # -- writes --------------------------------------------------------------
    def write(self, slices=None, *, uniform_slice_bytes=None,
              num_samples: int = 0, token_count: int = 0) -> int:
        desc = self.producer.write_tgb(
            slice_payloads=slices, uniform_slice_bytes=uniform_slice_bytes,
            num_samples=num_samples, token_count=token_count)
        self.producer.maybe_commit()  # cadence-gated by the commit policy
        return desc.producer_seq

    def flush(self) -> bool:
        return self.producer.maybe_commit(force=True)

    def seek(self, offset: int) -> None:
        """Deterministic-replay support: rewind the stream offset. Already
        committed offsets are deduplicated by the manifest commit protocol, so
        replaying from 0 after a crash is exactly-once by construction."""
        self.producer.next_offset = offset
        self.producer.pending = []

    @property
    def lag_exceeded(self) -> bool:
        return self.producer.lag_exceeded()

    @property
    def stats(self):
        return self.producer.stats


class TGBBatchReader:
    """Facade reader over the per-rank range-read consumer."""

    def __init__(self, ns: Namespace, topology: Topology, dp_rank: int,
                 cp_rank: int, prefetch_depth: int = 4,
                 dense_read: bool = False, verify_crc: bool = True,
                 io_pool: Optional[IOPool] = None,
                 resume: "Checkpoint | str | None" = None,
                 stats_instance: Optional[str] = None,
                 obs_snap_interval_s: Optional[float] = None,
                 manifests: Optional[ManifestStore] = None):
        self.topology = topology
        self.consumer = Consumer(
            ns, MeshPosition(dp_rank, cp_rank, topology.dp, topology.cp),
            manifests=manifests,
            prefetch_depth=prefetch_depth, dense_read=dense_read,
            verify_crc=verify_crc, io_pool=io_pool,
            stats_instance=stats_instance,
            obs_snap_interval_s=obs_snap_interval_s)
        self.dp_rank, self.cp_rank = dp_rank, cp_rank
        ckpt = Checkpoint.coerce(resume)
        if ckpt is not None:
            self.restore(ckpt)

    def next_batch(self, timeout_s: Optional[float] = None) -> Batch:
        step = self.consumer.step
        payload = self.consumer.next_batch(timeout_s=timeout_s)
        return Batch.build(payload, step=step,
                           version=self.consumer.view.version,
                           dp_rank=self.dp_rank, cp_rank=self.cp_rank,
                           topology=self.topology)

    def checkpoint(self) -> Checkpoint:
        v, s = self.consumer.cursor
        return Checkpoint("tgb", version=v, step=s,
                          topology=(self.topology.dp, self.topology.cp),
                          data_dp=self._data_dp())

    def _data_dp(self) -> int:
        """The materialized TGB layout's DP degree (falls back to the
        consuming topology before the first manifest is visible)."""
        if self.consumer.view.tgbs:
            return self.consumer.view.tgbs[0].dp
        return self.topology.dp

    def restore(self, ckpt: "Checkpoint | str") -> None:
        """Resume from a captured cursor — including one captured on a mesh
        whose DP degree differs from this reader's by an integer factor.

        The cursor's logical step is converted through the slice position
        (``step * dp_capture / dp_here``, exact); the per-slice remap itself
        happens inside the core consumer against the *materialized* layout,
        so no data is rewritten. Misaligned or non-integer-factor resizes
        raise ``UnsupportedOperation``.
        """
        ckpt = Checkpoint.coerce(ckpt)
        if ckpt.backend != "tgb":
            raise ValueError(f"cannot restore a {ckpt.backend!r} checkpoint "
                             f"on a tgb reader")
        if ckpt.composite:
            raise ValueError("composite multi-stream checkpoint cannot be "
                             "restored on a single-stream reader (open the "
                             "session with streams={...})")
        step = ckpt.step
        if ckpt.topology is not None:
            # CP changes never move the step cursor (token chunks live inside
            # a step); only the DP degree rescales logical steps.
            cap_dp = ckpt.topology[0]
            if cap_dp != self.topology.dp:
                try:
                    step = convert_logical_step(ckpt.step, cap_dp,
                                                self.topology.dp)
                except ValueError as e:
                    raise UnsupportedOperation(
                        f"cannot restore a dp={cap_dp} checkpoint on a "
                        f"dp={self.topology.dp} reader: {e}. Supported "
                        f"elastic path: integer-factor DP resize with the "
                        f"checkpoint on a global-batch boundary of the new "
                        f"degree") from e
        self.consumer.restore_cursor(ckpt.version, step)

    def poll(self) -> bool:
        """Probe for newly published batches; True if the view advanced."""
        return self.consumer.poll()

    @property
    def published_steps(self) -> int:
        """Global batches currently visible to this reader (backlog probe)."""
        return self.consumer.view.total_steps

    def start_prefetch(self) -> None:
        self.consumer.start_prefetch()

    def stop_prefetch(self) -> None:
        self.consumer.stop_prefetch()

    def close(self) -> None:
        self.consumer.stop_prefetch()

    @property
    def stats(self):
        return self.consumer.stats


class TGBSession(SessionBase):
    backend = "tgb"

    def __init__(self, store: ObjectStore, topology: Topology, *,
                 namespace: str = "runs/dataplane",
                 resume: "Checkpoint | str | None" = None,
                 expected_ranks: Optional[int] = None,
                 io_pool: Optional[IOPool] = None,
                 data_topology: Optional[Topology] = None,
                 obs_snap_interval_s: Optional[float] = None,
                 resilience=None,
                 manifest_shards: Optional[int] = None):
        if not isinstance(store, ObjectStore):
            raise TypeError(f"tgb backend needs an ObjectStore target, got "
                            f"{type(store).__name__}")
        # resilience=True / ResilienceConfig: every client this session vends
        # talks to the store through one shared ResilientStore (backoff +
        # retry budgets, throttle governor, hedged reads, circuit breaker)
        store = wrap_store(store, resilience)
        if resilience and obs_snap_interval_s is not None:
            store.attach_recorder(Namespace(store, namespace),
                                  obs_snap_interval_s)
        self.store = store
        self.topology = topology
        # the layout producers materialize TGBs at; defaults to the consuming
        # topology, but an elastically-resumed run pins it to the run's
        # original D x C so the stream layout stays uniform across restarts
        self.data_topology = data_topology or topology
        self.ns = Namespace(store, namespace)
        # one pool per session: all of this session's readers/writers share
        # its bounded in-flight request budget (None -> the process default)
        self._io_pool = io_pool
        self._resume = Checkpoint.coerce(resume)
        self._expected_ranks = expected_ranks or topology.world
        self._reclaimer: Optional[Reclaimer] = None
        self._readers: List[TGBBatchReader] = []
        # flight-recorder cadence for every client this session vends
        # (None = telemetry snapshots off; the counters still register)
        self._obs_snap_interval_s = obs_snap_interval_s
        # manifest_shards >= 2 claims a sharded manifest layout at session
        # creation (conditional put, first writer wins, immutable for the
        # run's life) so every client vended afterwards discovers it; None
        # adopts whatever the run already is (legacy single chain included)
        if manifest_shards is not None and manifest_shards > 1:
            from repro_torch.core.manifest import write_shard_config
            write_shard_config(self.ns, manifest_shards)

    # -- clients -------------------------------------------------------------
    def writer(self, writer_id: str = "w0", *,
               policy: Optional[CommitPolicy] = None,
               max_lag: Optional[int] = None,
               pipeline_commits: bool = False,
               spill_limit: Optional[int] = None) -> TGBWriter:
        return TGBWriter(self.ns, self.data_topology, writer_id, policy=policy,
                         max_lag=max_lag, pipeline_commits=pipeline_commits,
                         io_pool=self._io_pool,
                         obs_snap_interval_s=self._obs_snap_interval_s,
                         spill_limit=spill_limit)

    def reader(self, dp_rank: int = 0, cp_rank: int = 0, *,
               prefetch_depth: int = 4, dense_read: bool = False,
               verify_crc: bool = True,
               resume: "Checkpoint | str | None" = None) -> TGBBatchReader:
        r = TGBBatchReader(self.ns, self.topology, dp_rank, cp_rank,
                           prefetch_depth=prefetch_depth,
                           dense_read=dense_read, verify_crc=verify_crc,
                           io_pool=self._io_pool,
                           resume=resume if resume is not None
                           else self._resume,
                           obs_snap_interval_s=self._obs_snap_interval_s)
        self._readers.append(r)
        return r

    # -- lifecycle -----------------------------------------------------------
    def save_watermark(self, rank: int, ckpt: "Checkpoint | str") -> None:
        ckpt = Checkpoint.coerce(ckpt)
        if ckpt.composite:
            raise ValueError(
                "composite multi-stream checkpoint cannot be used as a "
                "single-stream watermark (its step is the global mixed step; "
                "use the multi-stream session's save_watermark)")
        # Watermarks gate TGB deletion, so their step must be in the
        # *materialized* layout's units. A token captured on a resized mesh
        # carries its capture topology; convert (flooring is conservative —
        # it can only under-trim).
        step = ckpt.step
        if ckpt.topology is not None and ckpt.data_dp:
            step = floor_to_data_step(ckpt.step, ckpt.topology[0],
                                      ckpt.data_dp)
        write_watermark(self.ns, rank,
                        Watermark(version=ckpt.version, step=step))

    def reclaim(self) -> int:
        """One watermark-driven reclamation cycle; returns TGBs deleted so far."""
        if self._reclaimer is None:
            self._reclaimer = Reclaimer(self.ns,
                                        expected_ranks=self._expected_ranks)
        self._reclaimer.run_cycle()
        return self._reclaimer.stats.tgbs_deleted

    @property
    def reclaim_stats(self):
        if self._reclaimer is None:
            self._reclaimer = Reclaimer(self.ns,
                                        expected_ranks=self._expected_ranks)
        return self._reclaimer.stats

    def manifest_view(self):
        """Latest committed DatasetView (introspection/debugging)."""
        m = open_manifest_store(self.ns)
        return m.load_view(m.latest_version())

    def close(self) -> None:
        for r in self._readers:
            r.close()
        self._readers.clear()


def _factory(target, topology, **opts) -> TGBSession:
    return TGBSession(target, topology, **opts)
