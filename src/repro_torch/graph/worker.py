"""DeriveWorker: executes one fused op chain, source stream -> derived stream.

The worker is a *consumer* of the source stream (through the ordinary
``Consumer`` read path — footer-indexed slice reads, CRC checks, topology
remap) and a *producer* of the output stream (through the ordinary
``Producer`` commit protocol — DAC cadence, conditional-put manifests,
exactly-once producer state). It adds exactly two things on top:

  * **content-addressed publication** — every output TGB's key token is the
    hash of its provenance record, so a replayed derivation finds the object
    already present and skips the upload;
  * **the derive cursor** — one conditional put per window binding
    {source steps consumed, output offsets published}.

Work proceeds in *windows* of ``window_steps`` source TGBs. Every op's
transient state (packer remainder, dedup seen-set) is flushed/reset at each
window boundary, so no op state ever crosses a cursor commit — a worker
restarted from its committed cursor replays the interrupted window from
scratch and reproduces it byte-identically:

    read window  ->  run ops  ->  upload outputs  ->  commit manifest
                                       |                   |
                                (skip: content         (dedup: producer
                                 address exists)        offset committed)
                                           -> commit derive cursor

A crash at any arrow replays the window; every effectful step downstream of
the cursor is idempotent, so the derived stream observed by consumers is
append-only, duplicate-free, and deterministic.

Port of ``repro.graph.worker``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.consumer import Consumer, MeshPosition
from repro_torch.core.errors import BatchTimeout
from repro_torch.core.objectstore import IOPool, Namespace
from repro_torch.core.producer import Producer
from repro_torch.dataplane.types import Topology
from repro_torch.graph.cursor import DeriveCursorError, DeriveCursorStore
from repro_torch.graph.graph import DeriveChain, GraphError, OpGraph
from repro_torch.graph.provenance import Provenance
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView
from repro_torch.obs.tracer import trace_span

__all__ = ["DeriveStats", "DeriveWorker"]


class DeriveStats(StatsView):
    """Registry-backed derivation counters (``derive.<worker_id>.*``)."""

    _FAMILY = "derive"
    _SPEC = {
        "source_steps": COUNTER,    # source TGBs consumed (this incarnation)
        "rows_in": COUNTER,         # source rows fed to the chain
        "rows_out": COUNTER,        # rows surviving into packed outputs
        "tgbs_derived": COUNTER,    # output TGBs published (incl. store hits)
        "store_hits": COUNTER,      # uploads skipped via content address
        "windows": COUNTER,         # derive quanta completed
        "cursor_commits": COUNTER,
        "resumed_src_step": GAUGE,  # where recover() placed the source cursor
    }


class DeriveWorker:
    """Executes one ``DeriveChain`` of an ``OpGraph`` with durable progress."""

    def __init__(self, ns: Namespace, graph: OpGraph,
                 source_topology: Topology,
                 output: Optional[str] = None, *,
                 worker_id: str = "derive-0",
                 window_steps: int = 4,
                 verify_crc: bool = True,
                 io_pool: Optional[IOPool] = None,
                 obs_snap_interval_s: Optional[float] = None):
        if not source_topology.decodable:
            raise ValueError(
                "DeriveWorker needs Topology(global_batch=..., seq_len=...) "
                "to decode source TGBs into rows")
        outs = graph.outputs
        if output is None:
            if len(outs) != 1:
                raise GraphError(
                    f"graph has outputs {outs}; pass output= to pick one")
            output = outs[0]
        self.graph = graph
        self.chain: DeriveChain = graph.chain(output)
        self.output = output
        self.src_topo = source_topology
        self.ns = ns
        self.src_ns = ns.stream(self.chain.source)
        self.out_ns = ns.stream(output)
        self.worker_id = worker_id
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self.window_steps = window_steps
        pack = self.chain.pack
        self.producer = Producer(self.out_ns, worker_id,
                                 dp=pack.dp, cp=pack.cp, io_pool=io_pool)
        self.cursors = DeriveCursorStore(self.out_ns)
        # position (0, 0) of a 1 x 1 mesh: the DP-halve remap serves one
        # source TGB as src_dp consecutive logical payloads in d-major order,
        # so whole global batches flow through the ordinary read path
        self.consumer = Consumer(self.src_ns, MeshPosition(0, 0, 1, 1),
                                 verify_crc=verify_crc, io_pool=io_pool,
                                 stats_instance=f"{worker_id}-src")
        self.src_step = 0  # next source TGB index to consume
        self.stats = DeriveStats(worker_id)
        self._graph_hash = graph.graph_hash()
        # optional flight recorder into the run root: windows/store-hit/cursor
        # counters become readable from storage for live and post-mortem ops
        self._recorder = None
        if obs_snap_interval_s is not None:
            from repro_torch.obs.recorder import FlightRecorder
            self._recorder = FlightRecorder(ns, self.stats.metric_scope,
                                            interval_s=obs_snap_interval_s)

    # -- recovery -------------------------------------------------------------
    def recover(self) -> int:
        """Resume from the committed derive cursor (crash-restart path).

        The producer offset is rewound to the cursor's ``out_seq`` — *not* to
        the manifest's committed offset — because the interrupted window must
        be replayed from its start: replayed outputs regenerate the same
        content addresses (uploads skip) and already-committed offsets are
        deduplicated by the commit protocol, so the replay publishes exactly
        the missing suffix.
        """
        self.producer.recover()  # loads the committed view + producer state
        dc = self.cursors.latest()
        if dc is not None:
            if dc.graph != self._graph_hash:
                raise DeriveCursorError(
                    f"output stream {self.output!r} was derived by graph "
                    f"{dc.graph[:12]}…, not {self._graph_hash[:12]}… — bump "
                    f"the op version and derive into a fresh stream")
            self.src_step = dc.src_step
            self.producer.next_offset = dc.out_seq
        else:
            self.src_step = 0
            self.producer.next_offset = 0
        self.producer.pending = []
        # load the source view *before* positioning the cursor: remap_step
        # needs the materialized dp, and an empty view falls back to the
        # consumer's own (1 x 1) mesh — which would misplace every read
        self.consumer.poll()
        self.consumer.step = self.src_step * self._src_dp()
        self.stats.resumed_src_step = self.src_step
        return self.src_step

    def _src_dp(self) -> int:
        return self.src_topo.dp

    # -- source reads ---------------------------------------------------------
    def _read_source_step(self, s: int,
                          timeout_s: Optional[float]) -> Tuple[np.ndarray, str]:
        """Read source TGB ``s`` in full and decode it to a row grid."""
        k = self._src_dp()
        assert self.consumer.step == s * k, \
            f"consumer cursor {self.consumer.step} != step {s} * dp {k}"
        parts = [self.consumer.next_batch(timeout_s=timeout_s)
                 for _ in range(k)]
        desc = self.consumer.view.tgb_at_step(s)
        if desc.dp != k:
            raise ValueError(
                f"source stream {self.chain.source!r} is materialized at "
                f"dp={desc.dp}, but source_topology says dp={k}")
        t = self.src_topo
        grid = np.frombuffer(b"".join(parts), dtype=np.int32)
        expect = t.global_batch * t.seq_len
        if grid.size != expect:
            raise ValueError(
                f"source TGB {desc.tgb_id} decodes to {grid.size} tokens, "
                f"expected {t.global_batch} x {t.seq_len} = {expect} — wrong "
                f"source_topology?")
        return grid.reshape(t.global_batch, t.seq_len), desc.tgb_id

    # -- the derive quantum ---------------------------------------------------
    def derive_window(self, end_step: int,
                      timeout_s: Optional[float] = 10.0) -> bool:
        """Process source steps ``[self.src_step, end_step)`` as one quantum:
        run the chain, flush the packer, publish outputs, commit the cursor.

        A ``BatchTimeout`` mid-window closes the window early at the last
        step actually read (source exhausted for now); the cursor then pins
        that boundary durably, so the early close is *not* a determinism
        hazard — replays start after it. Returns False if no source step was
        available at all (no cursor is written).
        """
        with trace_span("derive.window", cat="derive", start=self.src_step,
                        end=end_step):
            done = self._derive_window_inner(end_step, timeout_s)
        if self._recorder is not None:
            self._recorder.maybe_snap()  # window boundary = natural heartbeat
        return done

    def _derive_window_inner(self, end_step: int,
                             timeout_s: Optional[float]) -> bool:
        start = self.src_step
        for op in self.chain.ops:
            op.reset()
        pack = self.chain.pack
        src_ids: List[str] = []
        outputs = []
        s = start
        while s < end_step:
            try:
                rows, tgb_id = self._read_source_step(s, timeout_s)
            except BatchTimeout:
                break
            src_ids.append(tgb_id)
            self.stats.source_steps += 1
            self.stats.rows_in += rows.shape[0]
            for op in self.chain.ops[:-1]:
                rows = op.process(rows)
            self.stats.rows_out += rows.shape[0]
            outputs.extend(pack.pack_rows(rows))
            s += 1
        if s == start:
            return False
        tail = pack.flush()
        if tail is not None:
            outputs.append(tail)
        # publish: content-addressed uploads + ordinary manifest commit
        for idx, batch in enumerate(outputs):
            prov = Provenance(
                src_stream=self.chain.source, src_tgb_ids=tuple(src_ids),
                op=self.chain.signature, params=self.chain.params_hash,
                graph=self._graph_hash, out_index=idx)
            skipped_before = self.producer.stats.puts_skipped
            self.producer.write_tgb(
                slice_payloads=batch.slices,
                num_samples=batch.num_samples,
                token_count=batch.token_count,
                provenance=prov.to_wire(),
                content_token=prov.content_token())
            if self.producer.stats.puts_skipped > skipped_before:
                self.stats.store_hits += 1
            self.stats.tgbs_derived += 1
        if self.producer.pending:
            self.producer.finalize()
        # the cursor is the last commit of the quantum: everything upstream
        # of it is idempotent on replay
        self.src_step = s
        self.cursors.append(src_step=self.src_step,
                            out_seq=self.producer.next_offset,
                            graph=self._graph_hash,
                            op=self.chain.signature,
                            worker_id=self.worker_id)
        self.stats.windows += 1
        self.stats.cursor_commits += 1
        return True

    # -- the run loop ---------------------------------------------------------
    def run(self, max_source_steps: Optional[int] = None,
            timeout_s: float = 10.0) -> DeriveStats:
        """Recover, then derive windows until ``max_source_steps`` source
        TGBs are consumed (bounded job) or the source stops publishing
        within ``timeout_s`` (drain-what's-there mode)."""
        self.recover()
        while True:
            if (max_source_steps is not None
                    and self.src_step >= max_source_steps):
                break
            target = self.src_step + self.window_steps
            if max_source_steps is not None:
                target = min(target, max_source_steps)
            if not self.derive_window(target, timeout_s=timeout_s):
                break
        if self._recorder is not None:
            self._recorder.close()  # last-word snapshot for post-mortems
        return self.stats
