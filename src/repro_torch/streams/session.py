"""MultiStreamSession: one training run owning N named TGB streams.

Opened through the facade::

    session = open_dataplane(store, topo, backend="tgb",
                             streams={"web": 0.7, "code": 0.3}, mix_seed=42,
                             namespace="runs/pretrain")
    with session.writer("w0", stream="web") as w: ...
    reader = session.reader(dp_rank=0, cp_rank=0)   # -> MixedReader

Each stream is an independent manifest chain under ``<run>/streams/<name>``;
producers attach to exactly one stream and are oblivious to the mixing layer.
The deterministic MixPlan (weights, seed) is the *only* cross-stream state,
and it is config, not data — nothing about the schedule is ever persisted.

Lifecycle is mix-aware: ``save_watermark`` splits a composite checkpoint into
per-stream ``(version, stream_step)`` watermarks, so each stream's reclaimer
computes its own W_global over exactly the steps mixed readers can still
revisit, and a stream never reclaims a TGB the mix still needs.

Port of ``repro.streams.session``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from repro_torch.core.dac import CommitPolicy
from repro_torch.core.objectstore import IOPool, Namespace, ObjectStore
from repro_torch.core.resilience import wrap_store
from repro_torch.dataplane._base import SessionBase
from repro_torch.dataplane.tgb_backend import TGBWriter
from repro_torch.dataplane.types import Checkpoint, Topology
from repro_torch.streams.mixed_reader import MixedReader
from repro_torch.streams.mixplan import MixPlan
from repro_torch.streams.stream import Stream

__all__ = ["MultiStreamSession"]


class MultiStreamSession(SessionBase):
    """A handle on one run's multi-stream data plane (tgb transport)."""

    backend = "tgb"

    def __init__(self, store: ObjectStore, topology: Topology, *,
                 streams: Mapping[str, float], mix_seed: int = 0,
                 namespace: str = "runs/dataplane",
                 resume: "Checkpoint | str | None" = None,
                 expected_ranks: Optional[int] = None,
                 io_pool: Optional[IOPool] = None,
                 data_topology: Optional[Topology] = None,
                 resilience=None):
        if not isinstance(store, ObjectStore):
            raise TypeError(f"tgb backend needs an ObjectStore target, got "
                            f"{type(store).__name__}")
        # one shared resilience layer for every stream's clients (same
        # breaker/governor — the whole run backs off together)
        store = wrap_store(store, resilience)
        self.store = store
        self.topology = topology
        # the layout producers materialized (and keep materializing) at; if
        # not given it is discovered from the streams' manifests on first
        # reader/writer, so an elastically-resized session keeps the stream
        # layout uniform and remaps reads instead of rewriting data
        self._data_topology = data_topology
        self.ns = Namespace(store, namespace)
        self.plan = MixPlan(streams, seed=mix_seed)
        self.mix_seed = mix_seed
        self._expected_ranks = expected_ranks or topology.world
        self.streams: Dict[str, Stream] = {
            name: Stream(self.ns, name, self.plan.weights[name],
                         self._expected_ranks)
            for name in self.plan.names
        }
        self._io_pool = io_pool  # shared across every reader's streams
        self._resume = Checkpoint.coerce(resume)
        if self._resume is not None and not self._resume.composite:
            raise ValueError("multi-stream session needs a composite "
                             "checkpoint token (one carrying per-stream "
                             "cursors), got a single-stream token")
        self._readers: List[MixedReader] = []
        self._frontier = 0  # last known contiguous mix frontier (monotone)

    # -- clients -------------------------------------------------------------
    @property
    def stream_names(self):
        return self.plan.names

    @property
    def data_topology(self) -> Topology:
        """The materialized per-stream D x C layout. Discovered from the
        first stream manifest that lists a TGB; before any TGB exists (a
        fresh run) it is the consuming topology."""
        if self._data_topology is None:
            for s in self.streams.values():
                view = s.manifest_view()
                if view.tgbs:
                    t = view.tgbs[0]
                    if (t.dp, t.cp) != (self.topology.dp, self.topology.cp):
                        gb = self.topology.global_batch
                        if gb is not None:
                            gb = gb * t.dp // self.topology.dp
                        self._data_topology = Topology(
                            dp=t.dp, cp=t.cp, global_batch=gb,
                            seq_len=self.topology.seq_len)
                    break
            if self._data_topology is None:
                self._data_topology = self.topology
        return self._data_topology

    def writer(self, writer_id: str = "w0", *, stream: Optional[str] = None,
               policy: Optional[CommitPolicy] = None,
               max_lag: Optional[int] = None,
               pipeline_commits: bool = False,
               spill_limit: Optional[int] = None) -> TGBWriter:
        """A producer handle bound to one named stream."""
        if stream is None or stream not in self.streams:
            raise ValueError(
                f"multi-stream writer needs stream=<name>; available: "
                f"{', '.join(self.plan.names)} (got {stream!r})")
        return TGBWriter(self.streams[stream].ns, self.data_topology,
                         writer_id, policy=policy, max_lag=max_lag,
                         pipeline_commits=pipeline_commits,
                         io_pool=self._io_pool, spill_limit=spill_limit)

    def reader(self, dp_rank: int = 0, cp_rank: int = 0, *,
               prefetch_depth: int = 4, dense_read: bool = False,
               verify_crc: bool = True,
               resume: "Checkpoint | str | None" = None) -> MixedReader:
        r = MixedReader(self.plan,
                        {name: s.ns for name, s in self.streams.items()},
                        self.topology, dp_rank, cp_rank,
                        prefetch_depth=prefetch_depth, dense_read=dense_read,
                        verify_crc=verify_crc, io_pool=self._io_pool,
                        resume=resume if resume is not None else self._resume,
                        data_topology=self.data_topology)
        self._readers.append(r)
        return r

    # -- derived streams -------------------------------------------------------
    def derive_worker(self, graph, output: Optional[str] = None, *,
                      worker_id: str = "derive-0", window_steps: int = 4,
                      verify_crc: bool = True):
        """A ``DeriveWorker`` executing one chain of ``graph`` under this
        run's namespace. The graph's source streams are this session's
        streams (or other derived streams already materialized here); its
        output becomes an ordinary stream that can be listed in a future
        session's mix weights and read by any MixedReader."""
        from repro_torch.graph.worker import DeriveWorker
        return DeriveWorker(self.ns, graph, self.data_topology, output,
                            worker_id=worker_id, window_steps=window_steps,
                            verify_crc=verify_crc, io_pool=self._io_pool)

    # -- mix-aware lifecycle ---------------------------------------------------
    def save_watermark(self, rank: int, ckpt: "Checkpoint | str") -> None:
        """Split a composite checkpoint into per-stream mix-aware watermarks."""
        ckpt = Checkpoint.coerce(ckpt)
        if not ckpt.composite:
            raise ValueError("multi-stream save_watermark needs a composite "
                             "checkpoint (reader.checkpoint() of a "
                             "MixedReader)")
        for name, version, stream_step in ckpt.streams:
            self.streams[name].save_watermark(rank, version, stream_step)

    def reclaim(self) -> int:
        """One reclamation cycle per stream; returns total TGBs deleted so
        far. Each stream trims only below its own mix-aware W_global."""
        return sum(s.reclaim_cycle() for s in self.streams.values())

    @property
    def reclaim_stats(self) -> Dict[str, object]:
        return {name: s.reclaimer().stats for name, s in self.streams.items()}

    # -- introspection ----------------------------------------------------------
    def manifest_view(self, stream: str):
        """Latest committed DatasetView of one stream."""
        return self.streams[stream].manifest_view()

    def published_steps(self) -> int:
        """Contiguous global (mixed) steps currently servable. Published
        counts only grow, so the probe resumes from the last frontier."""
        published = {name: s.published_steps
                     for name, s in self.streams.items()}
        self._frontier = self.plan.frontier(published, start=self._frontier)
        return self._frontier

    def stream_lag(self, upto_global_step: Optional[int] = None
                   ) -> Dict[str, int]:
        """Per-stream published-ahead backlog relative to the mix frontier
        (``published stream steps - steps the mix has scheduled``)."""
        counts = self.plan.stream_counts(
            self.published_steps() if upto_global_step is None
            else upto_global_step)
        return {name: s.published_steps - counts[name]
                for name, s in self.streams.items()}

    def close(self) -> None:
        for r in self._readers:
            r.close()
        self._readers.clear()
