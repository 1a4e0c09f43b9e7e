"""TrainSession: one recoverable training run (model + data, atomically).

Wraps ``open_dataplane`` and the model checkpoint store behind a single
pair of operations:

  * ``session.checkpoint(state)`` — upload model state, then commit **one**
    RunManifest entry binding ``{model pointer, data cursors + mix position,
    topology, step}`` with a conditional put. A crash anywhere between the
    model upload and the commit leaves the previous entry authoritative:
    recovery replays from the last *aligned* checkpoint, exactly-once.
  * ``TrainSession.resume(store, namespace)`` — reopen the run from its last
    committed RunManifest entry, optionally on a **different Topology**
    (integer-factor DP resize): cursors are remapped through the core
    ``(logical step, rank) -> (tgb step, slice)`` machinery, no data is
    rewritten, and the replayed global batch byte sequence is identical.

Reclamation is tied to the RunManifest: the session's reclaimers derive the
safety boundary from the last committed entry (``RunManifestStore.
watermark_source``), so the trim marker can never pass an aligned checkpoint
— not even when readers have raced far ahead of the last save.

Example::

    session = TrainSession(store, Topology(dp=2, cp=1, global_batch=8,
                                           seq_len=128),
                           namespace="runs/job")
    readers = [session.reader(dp_rank=d) for d in range(2)]
    ...train...
    session.checkpoint({"params": params, "opt": opt})
    # -- crash / resize ------------------------------------------------
    resumed = TrainSession.resume(store, "runs/job",
                                  topology=Topology(dp=4, cp=1,
                                                    global_batch=16,
                                                    seq_len=128))
    state = resumed.restore_model({"params": params, "opt": opt})
    step = resumed.resume_step          # in the *new* topology's units

Port of ``repro.run.session``. Model state is a tree of tensors;
``restore_model`` places each leaf on its template leaf's device.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional

from repro_torch.core.consumer import (convert_logical_step,
                                       floor_to_data_step)
from repro_torch.core.lifecycle import Reclaimer
from repro_torch.core.objectstore import Namespace, NoSuchKey, ObjectStore
from repro_torch.dataplane import open_dataplane
from repro_torch.dataplane.types import (Checkpoint, Topology,
                                         UnsupportedOperation)
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView
from repro_torch.obs.tracer import trace_span
from repro_torch.run.manifest import RunManifest, RunManifestStore
from repro_torch.train.checkpoint import (load_model_state,
                                          upload_model_state)

__all__ = ["TrainSession", "TrainStats"]


class TrainStats(StatsView):
    """Registry-backed run-level counters (``train.<run>.*``)."""

    _FAMILY = "train"
    _SPEC = {
        "checkpoints": COUNTER,        # committed RunManifest entries
        "last_checkpoint_step": GAUGE,  # logical step the last entry bound
        "reclaim_cycles": COUNTER,
    }


class TrainSession:
    """A handle on one training run: data plane + model state + RunManifest."""

    def __init__(self, store: ObjectStore, topology: Topology, *,
                 namespace: str = "runs/train",
                 backend: str = "tgb",
                 streams: Optional[Dict[str, float]] = None,
                 mix_seed: int = 0,
                 resume_entry: Optional[RunManifest] = None,
                 **backend_opts):
        if backend != "tgb":
            raise UnsupportedOperation(
                f"TrainSession needs the object-store-native 'tgb' backend "
                f"(the RunManifest lives in the same store as the data "
                f"plane); got {backend!r}")
        if not isinstance(store, ObjectStore):
            raise TypeError(f"TrainSession needs an ObjectStore target, got "
                            f"{type(store).__name__}")
        self.store = store
        self.topology = topology
        self.ns = Namespace(store, namespace)
        self.runs = RunManifestStore(self.ns)
        self._entry = resume_entry
        self.streams_config = dict(streams) if streams else None
        self.mix_seed = mix_seed
        #: logical step (in THIS topology's units) training should resume at
        self.resume_step = 0
        resume_token = None
        data_topology = None
        if resume_entry is not None:
            resume_token = resume_entry.data_token
            data_topology = _data_topology_of(resume_entry)
            try:
                self.resume_step = convert_logical_step(
                    resume_entry.step, resume_entry.topology[0], topology.dp)
            except ValueError as e:
                raise UnsupportedOperation(
                    f"cannot resume the dp={resume_entry.topology[0]} run at "
                    f"dp={topology.dp}: {e}") from e
        extra = dict(backend_opts)
        if data_topology is not None and \
                (data_topology.dp, data_topology.cp) != (topology.dp,
                                                         topology.cp):
            extra["data_topology"] = data_topology
        self.data = open_dataplane(
            store, topology, backend="tgb", namespace=namespace,
            resume=resume_token, streams=self.streams_config,
            mix_seed=mix_seed, **extra)
        self._readers: List[object] = []
        self._reclaimers: Dict[Optional[str], Reclaimer] = {}
        self._cycle_entry: Optional[RunManifest] = None  # set per reclaim()
        self.stats = TrainStats(namespace.rsplit("/", 1)[-1] or "run")

    # -- construction ---------------------------------------------------------
    @classmethod
    def resume(cls, store: ObjectStore, namespace: str, *,
               topology: Optional[Topology] = None,
               streams: Optional[Dict[str, float]] = None,
               mix_seed: Optional[int] = None,
               **backend_opts) -> "TrainSession":
        """Reopen a run from its last committed RunManifest entry.

        ``topology=None`` resumes on the capture topology. Passing a
        different Topology performs an elastic factor-DP-resize restore.
        Multi-stream config (weights + mix seed) is recovered from the entry
        unless overridden.
        """
        runs = RunManifestStore(Namespace(store, namespace))
        entry = runs.latest()
        if entry is None:
            raise NoSuchKey(
                f"no RunManifest under {namespace!r}: nothing to resume "
                f"(fresh runs use TrainSession(...) directly)")
        cap = Topology(dp=entry.topology[0], cp=entry.topology[1],
                       global_batch=entry.global_batch,
                       seq_len=entry.seq_len)
        topo = topology if topology is not None else cap
        return cls(store, topo, namespace=namespace,
                   streams=streams if streams is not None else entry.streams,
                   mix_seed=mix_seed if mix_seed is not None
                   else entry.mix_seed,
                   resume_entry=entry, **backend_opts)

    # -- clients --------------------------------------------------------------
    def writer(self, writer_id: str = "w0", **opts):
        """A producer handle (materializes at the run's original layout even
        after an elastic resume — the stream layout stays uniform)."""
        return self.data.writer(writer_id, **opts)

    def reader(self, dp_rank: int = 0, cp_rank: int = 0, **opts):
        """A rank's reader, positioned at the last aligned checkpoint (or the
        stream start on a fresh run). Readers vended here are the cursors
        ``checkpoint()`` snapshots, in rank order."""
        r = self.data.reader(dp_rank=dp_rank, cp_rank=cp_rank, **opts)
        self._readers.append(r)
        return r

    # -- the aligned checkpoint ----------------------------------------------
    def checkpoint(self, state, *, step: Optional[int] = None) -> RunManifest:
        """Atomically persist model state + every reader's data cursor.

        Ordering is upload-then-commit: model leaves and their MANIFEST go
        up first, then one conditional put publishes the RunManifest entry
        naming them. Per-rank watermarks are refreshed only *after* the
        commit, so reclamation can never pass an aligned checkpoint that a
        restart might still need.
        """
        if not self._readers:
            raise RuntimeError(
                "open this session's readers before checkpoint(): their "
                "cursors are what the RunManifest binds to the model state")
        cks = [r.checkpoint() for r in self._readers]
        data_ck = _canonical_cursor(cks)
        if step is None:
            step = data_ck.step  # logical trainer step == batches consumed
        data_dp = data_ck.data_dp
        if data_dp is None:
            data_dp = getattr(self.data, "data_topology", self.topology).dp
        # upload under the MATERIALIZED step — the unit that is invariant
        # across elastic resizes — into a directory this incarnation CLAIMS
        # atomically first: an earlier RunManifest entry may bind an
        # existing directory (overwriting would rebind its pointer to
        # different bytes), and during a failover overlap two incarnations
        # racing the same step must never interleave leaf uploads
        data_step = floor_to_data_step(step, self.topology.dp, data_dp)
        tag = None
        attempt = 0
        while True:
            dirname = f"{data_step:010d}" + (f"-{tag}" if tag else "")
            mkey_candidate = self.ns.key("checkpoints", dirname,
                                         "MANIFEST.ckpt")
            claim_key = self.ns.key("checkpoints", dirname, "CLAIM")
            if not self.store.exists(mkey_candidate) and \
                    self.store.put_if_absent(claim_key, b"claimed"):
                break
            attempt += 1
            tag = f"r{attempt}"
        with trace_span("checkpoint.upload", cat="checkpoint", step=step):
            model_key = upload_model_state(
                self.ns, data_step, state,
                cursor=(data_ck.version, data_ck.step), tag=tag)
        with trace_span("checkpoint.commit", cat="checkpoint", step=step):
            entry = self.runs.append(
                step=step, model_key=model_key, data_token=data_ck.encode(),
                topology=(self.topology.dp, self.topology.cp),
                data_dp=data_dp,
                global_batch=self.topology.global_batch,
                seq_len=self.topology.seq_len,
                streams=self.streams_config, mix_seed=self.mix_seed)
        self.stats.checkpoints += 1
        self.stats.last_checkpoint_step = step
        for r, ck in zip(self._readers, cks):
            # watermark identity is the mesh position, not discovery order —
            # a subset of ranks must never shadow another rank's file
            rank = r.dp_rank * self.topology.cp + r.cp_rank
            self.data.save_watermark(rank, ck)
        self._entry = entry
        return entry

    def restore_model(self, template):
        """The model state bound by the run's last aligned checkpoint,
        rebuilt into ``template``'s pytree structure."""
        entry = self._entry or self.runs.latest()
        if entry is None:
            raise NoSuchKey("no RunManifest entry: nothing to restore")
        if not entry.model_key:
            raise NoSuchKey(f"RunManifest seq={entry.seq} carries no model "
                            f"checkpoint")
        state, _doc = load_model_state(self.ns, entry.model_key, template)
        return state

    @property
    def last_entry(self) -> Optional[RunManifest]:
        return self._entry

    # -- lifecycle ------------------------------------------------------------
    def _reclaimer(self, stream: Optional[str]) -> Reclaimer:
        rec = self._reclaimers.get(stream)
        if rec is None:
            ns = self.ns if stream is None \
                else self.data.streams[stream].ns

            def source(name=stream):
                entry = self._cycle_entry
                return None if entry is None else entry.watermark(name)

            rec = Reclaimer(ns, watermark_source=source)
            self._reclaimers[stream] = rec
        return rec

    def reclaim(self) -> int:
        """One reclamation cycle bounded by the last *committed* RunManifest
        entry (per stream on multi-stream runs); returns TGBs deleted so
        far across the run."""
        # one RunManifest read serves every stream's cycle this round
        self._cycle_entry = self.runs.latest()
        self.stats.reclaim_cycles += 1
        try:
            if self.streams_config:
                total = 0
                for name in self.data.streams:
                    rec = self._reclaimer(name)
                    rec.run_cycle()
                    total += rec.stats.tgbs_deleted
                return total
            rec = self._reclaimer(None)
            rec.run_cycle()
            return rec.stats.tgbs_deleted
        finally:
            self._cycle_entry = None

    # -- passthrough / lifecycle ----------------------------------------------
    def manifest_view(self, stream: Optional[str] = None):
        if stream is not None:
            return self.data.manifest_view(stream)
        return self.data.manifest_view()

    def close(self) -> None:
        self.data.close()

    def __enter__(self) -> "TrainSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _data_topology_of(entry: RunManifest) -> Topology:
    """The materialized layout a resumed run must keep producing at."""
    cap_dp = entry.topology[0]
    gb = entry.global_batch
    if gb is not None and cap_dp != entry.data_dp:
        gb = gb * entry.data_dp // cap_dp
    return Topology(dp=entry.data_dp, cp=entry.topology[1],
                    global_batch=gb, seq_len=entry.seq_len)


def _canonical_cursor(cks: List[Checkpoint]) -> Checkpoint:
    """Collapse per-reader cursors into the run's single bound cursor.

    All readers must sit on the same logical step (lockstep data parallel);
    manifest versions may differ transiently, so the *minimum* is bound —
    restoring an older version is safe (the consumer polls forward), while
    binding a newer one could outrun a rank's retention.
    """
    base = cks[0]
    if any(c.step != base.step for c in cks):
        raise RuntimeError(
            f"readers are not in lockstep (steps "
            f"{sorted(c.step for c in cks)}): checkpoint() must run at a "
            f"global-batch boundary")
    if base.composite:
        rows = []
        for i, (name, v, s) in enumerate(base.streams):
            vmin = min(c.streams[i][1] for c in cks)
            rows.append((name, vmin, s))
        return replace(base, streams=tuple(rows))
    return replace(base, version=min(c.version for c in cks))
