"""MixedReader: one rank's multiplexed view over N named TGB streams.

Implements the facade ``BatchReader`` protocol. Each global step g is routed
to the stream the ``MixPlan`` schedules there; because per-stream steps are
dense and ordered, every underlying single-stream consumer just advances its
normal ``<V, S>`` cursor — the mixing layer adds no new read path, only
routing.

Exactly-once across streams: ``checkpoint()`` emits one composite token
carrying the mix position (in **materialized mix units**, invariant under
topology resize) plus every stream's ``<V, S>`` cursor; ``restore()``
re-validates that the per-stream cursors are exactly what the
(weights, seed) schedule implies at that mix position, so a token captured
under different mix settings can never silently misalign the streams.

Elastic topology restore (§4.1): when the consuming mesh's DP degree differs
from the materialized layout's by an integer factor, the reader runs in
*elastic mode* — the core ``remap_step`` is applied at the mixing layer
(treating the mixed schedule as one virtual TGB stream at the materialized
D x C), so each rank still issues exactly one slice read per logical step
and the concatenated global batch byte sequence is identical to the
un-resized run's. The schedule itself is consumed in materialized units and
therefore never re-interleaves.

Port of ``repro.streams.mixed_reader``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

from repro_torch.core.consumer import (MeshPosition, convert_logical_step,
                                 floor_to_data_step, remap_step)
from repro_torch.core.objectstore import IOPool, Namespace
from repro_torch.dataplane.tgb_backend import TGBBatchReader
from repro_torch.dataplane.types import (Batch, Checkpoint, Topology,
                                   UnsupportedOperation)
from repro_torch.streams.mixplan import MixPlan

__all__ = ["MixedReader"]


class MixedReader:
    """Facade reader multiplexing per-stream consumers via a MixPlan."""

    def __init__(self, plan: MixPlan, stream_namespaces: Mapping[str, Namespace],
                 topology: Topology, dp_rank: int, cp_rank: int, *,
                 prefetch_depth: int = 4, dense_read: bool = False,
                 verify_crc: bool = True,
                 io_pool: Optional[IOPool] = None,
                 resume: "Checkpoint | str | None" = None,
                 data_topology: Optional[Topology] = None):
        self.plan = plan
        self.topology = topology
        self.data_topology = data_topology or topology
        self.dp_rank, self.cp_rank = dp_rank, cp_rank
        self._elastic = self.data_topology.dp != topology.dp
        if self._elastic:
            if self.data_topology.cp != topology.cp:
                raise UnsupportedOperation(
                    "elastic multi-stream restore supports factor DP resize "
                    "only; CP must match the materialized layout "
                    f"(cp={self.data_topology.cp}, got cp={topology.cp})")
            if max(topology.dp, self.data_topology.dp) % \
                    min(topology.dp, self.data_topology.dp):
                raise UnsupportedOperation(
                    f"DP resize {self.data_topology.dp} -> {topology.dp} is "
                    f"not an integer factor")
        # one IOPool shared by every stream's consumer: N streams multiplex
        # one bounded in-flight request budget instead of N independent ones
        self.io_pool = io_pool or IOPool.default()
        # sub-readers run at the MATERIALIZED layout; in elastic mode their
        # (d, c) coordinates are re-derived per read by the mixing-layer remap
        sub_topo = self.data_topology
        self._subs: Dict[str, TGBBatchReader] = {
            name: TGBBatchReader(stream_namespaces[name], sub_topo,
                                 dp_rank if not self._elastic else 0,
                                 cp_rank,
                                 prefetch_depth=prefetch_depth,
                                 dense_read=dense_read,
                                 verify_crc=verify_crc,
                                 io_pool=self.io_pool,
                                 # stream-qualified registry instance so N
                                 # streams of one rank never collide into
                                 # auto-suffixed scopes
                                 stats_instance=f"{name}-d{dp_rank}c{cp_rank}")
            for name in plan.names
        }
        self.global_step = 0  # next mixed step this reader will return
        ckpt = Checkpoint.coerce(resume)
        if ckpt is not None:
            self.restore(ckpt)

    # -- mix-unit position ----------------------------------------------------
    def _mix_pos(self) -> int:
        """The cursor in materialized mix units (== ``global_step`` when the
        consuming topology matches the materialized layout)."""
        if not self._elastic:
            return self.global_step
        try:
            return convert_logical_step(self.global_step, self.topology.dp,
                                        self.data_topology.dp)
        except ValueError as e:
            raise UnsupportedOperation(
                f"mixed cursor at logical step {self.global_step} "
                f"(dp={self.topology.dp}) does not sit on a materialized "
                f"(dp={self.data_topology.dp}) global-batch boundary: {e}"
            ) from e

    # -- reads ----------------------------------------------------------------
    def next_batch(self, timeout_s: Optional[float] = None) -> Batch:
        if self._elastic:
            return self._next_batch_elastic(timeout_s)
        name, stream_step = self.plan.position(self.global_step)
        sub = self._subs[name]
        if sub.consumer.step != stream_step:
            raise RuntimeError(
                f"stream {name!r} cursor {sub.consumer.step} diverged from "
                f"schedule step {stream_step} at global step "
                f"{self.global_step}; restore from a composite checkpoint")
        inner = sub.next_batch(timeout_s=timeout_s)
        batch = Batch.build(inner.payload, step=self.global_step,
                            version=inner.version, dp_rank=self.dp_rank,
                            cp_rank=self.cp_rank, topology=self.topology,
                            stream=name)
        self.global_step += 1
        return batch

    def _next_batch_elastic(self, timeout_s: Optional[float]) -> Batch:
        """One logical step on a factor-resized mesh: remap this rank onto
        the virtual mixed TGB stream, route the resulting materialized
        position through the schedule, and read that one slice."""
        ddp, dcp = self.data_topology.dp, self.data_topology.cp
        m, td, tc = remap_step(
            self.global_step,
            MeshPosition(self.dp_rank, self.cp_rank,
                         self.topology.dp, self.topology.cp),
            ddp, dcp)
        name, stream_m = self.plan.position(m)
        cons = self._subs[name].consumer
        # reposition the materialized-layout consumer at this read's exact
        # (tgb step, slice); its internal remap is then the identity
        cons.pos = MeshPosition(td, tc, ddp, dcp)
        cons.step = stream_m
        payload = cons.next_batch(timeout_s=timeout_s)
        batch = Batch.build(payload, step=self.global_step,
                            version=cons.view.version, dp_rank=self.dp_rank,
                            cp_rank=self.cp_rank, topology=self.topology,
                            stream=name)
        self.global_step += 1
        return batch

    # -- cursor ----------------------------------------------------------------
    def checkpoint(self) -> Checkpoint:
        """Composite token: mix position + every stream's <V, S> cursor.

        Stream cursors and the mix position are emitted in materialized
        units, which makes the token restorable on any integer-factor DP
        resize of the mesh (``step`` stays this reader's logical step)."""
        m = self._mix_pos()
        counts = self.plan.stream_counts(m)
        rows = []
        for name in self.plan.names:
            v = self._subs[name].consumer.view.version
            rows.append((name, v, counts[name]))
        return Checkpoint("tgb", version=-1, step=self.global_step,
                          streams=tuple(rows),
                          topology=(self.topology.dp, self.topology.cp),
                          data_dp=self.data_topology.dp, mix_pos=m)

    def restore(self, ckpt: "Checkpoint | str") -> None:
        ckpt = Checkpoint.coerce(ckpt)
        if ckpt.backend != "tgb":
            raise ValueError(f"cannot restore a {ckpt.backend!r} checkpoint "
                             f"on a tgb mixed reader")
        if not ckpt.composite:
            raise ValueError("single-stream checkpoint cannot be restored on "
                             "a multi-stream reader")
        names = tuple(sorted(row[0] for row in ckpt.streams))
        if names != self.plan.names:
            raise ValueError(
                f"checkpoint streams {names} do not match session streams "
                f"{self.plan.names}")
        # the mix position in materialized units; tokens minted before the
        # elastic-restore work (or hand-built ones) carry it as `step`
        m = ckpt.mix_pos if ckpt.mix_pos is not None else ckpt.step
        # the schedule is pure in (weights, seed, step): per-stream cursors
        # MUST equal the scheduled counts at the mix position, otherwise the
        # token was captured under different mix settings
        expect = self.plan.stream_counts(m)
        for name, _v, s in ckpt.streams:
            if s != expect[name]:
                raise ValueError(
                    f"composite checkpoint is inconsistent with this "
                    f"session's MixPlan: stream {name!r} cursor {s} != "
                    f"scheduled count {expect[name]} at mix step {m} "
                    f"(were weights/seed changed?)")
        try:
            logical = convert_logical_step(m, self.data_topology.dp,
                                           self.topology.dp)
        except ValueError as e:
            raise UnsupportedOperation(
                f"cannot restore mix position {m} "
                f"(dp={self.data_topology.dp} units) on a "
                f"dp={self.topology.dp} mesh: {e}. Supported elastic path: "
                f"integer-factor DP resize with the checkpoint on a "
                f"global-batch boundary of the new degree") from e
        for name, v, _s in ckpt.streams:
            self._subs[name].consumer.restore_cursor(v, expect[name])
        self.global_step = logical

    # -- progress probes --------------------------------------------------------
    def poll(self) -> bool:
        """Probe all streams for newly committed manifests."""
        advanced = False
        for sub in self._subs.values():
            advanced |= sub.poll()
        return advanced

    @property
    def published_steps(self) -> int:
        """Contiguous global steps currently servable: the first global step
        whose owning stream has not yet published the scheduled stream step.
        Anchored at this reader's cursor — everything below it was served.
        In elastic mode the frontier is computed in materialized units and
        floored to logical steps."""
        published = {name: sub.published_steps
                     for name, sub in self._subs.items()}
        m_frontier = self.plan.frontier(published, start=self._mix_floor())
        if not self._elastic:
            return m_frontier
        return floor_to_data_step(m_frontier, self.data_topology.dp,
                                  self.topology.dp)

    def stream_lag(self) -> Dict[str, int]:
        """Per-stream backlog: published-but-unconsumed stream steps (in
        materialized units)."""
        counts = self.plan.stream_counts(self._mix_floor())
        return {name: sub.published_steps - counts[name]
                for name, sub in self._subs.items()}

    def _mix_floor(self) -> int:
        return floor_to_data_step(self.global_step, self.topology.dp,
                                  self.data_topology.dp)

    # -- prefetch / lifecycle ----------------------------------------------------
    def start_prefetch(self) -> None:
        if self._elastic:
            # elastic reads reposition each sub-consumer's (step, slice) per
            # call; the dense-cursor prefetcher would race it
            return
        for sub in self._subs.values():
            sub.start_prefetch()

    def stop_prefetch(self) -> None:
        for sub in self._subs.values():
            sub.stop_prefetch()

    def close(self) -> None:
        for sub in self._subs.values():
            sub.close()

    @property
    def stats(self) -> Dict[str, object]:
        return {name: sub.stats for name, sub in self._subs.items()}
