"""The port's sharded manifest chains and compactor on the CPU.

Twins of every test of ``tests/test_sharded_manifest.py`` on
``repro_torch.core``: galloping head discovery, layout resolution, the
merged view's determinism and cross-shard exactly-once, the frontier, the
compactor's fold, crash window and repair, shard-switch safety, the fsck
audits of a sharded run, chain GC and a tgb session over a sharded run, and
the merge property test (through the hypothesis shim where hypothesis is
not installed). Then across packages: a compact segment written by either
package's compactor is read by the other's merged view, with identical
bytes.
"""
from __future__ import annotations

import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro_torch.core.clock import VirtualClock  # noqa: E402
from repro_torch.core.commit import (CommitProtocol,  # noqa: E402
                                     ShardedCommitProtocol)
from repro_torch.core.compactor import Compactor  # noqa: E402
from repro_torch.core.errors import TransientStoreError  # noqa: E402
from repro_torch.core.lifecycle import Reclaimer, Watermark  # noqa: E402
from repro_torch.core.manifest import (DatasetView,  # noqa: E402
                                       ManifestStore, MANIFEST_FORMAT_DELTA,
                                       MANIFEST_FORMAT_FLAT,
                                       ShardedManifestStore, StepUnavailable,
                                       decode_manifest, encode_flat_manifest,
                                       open_manifest_store, read_shard_config,
                                       write_shard_config)
from repro_torch.core.objectstore import (MemoryObjectStore,  # noqa: E402
                                          Namespace, ZERO_LATENCY)
from repro_torch.core.tgb import TGBDescriptor  # noqa: E402
from repro_torch.ops.fsck import fsck  # noqa: E402


def _ns(name: str = "runs/shardtest") -> Namespace:
    return Namespace(MemoryObjectStore(latency=ZERO_LATENCY), name)


def _tgb(pid: str, seq: int) -> TGBDescriptor:
    return TGBDescriptor(
        tgb_id=f"{pid}-{seq}", object_key=f"tgb/{pid}-{seq}.tgb",
        size_bytes=100, dp=1, cp=1, num_samples=4, token_count=1024,
        producer_id=pid, producer_seq=seq)


def _commit(proto, pending, attempts: int = 200) -> None:
    for _ in range(attempts):
        res, pending = proto.try_commit(pending)
        if res.success:
            return
        proto.refresh()
    raise AssertionError("commit starved out")


def _quiesce(protos) -> None:
    """flush_frontier until every shard chain reaches the same head (each
    flush drives laggards at most HEARTBEAT_ATTEMPTS versions forward)."""
    any_proto = next(iter(protos.values()))
    shards = any_proto.manifests.shards
    for _ in range(100):
        for p in protos.values():
            p.flush_frontier()
        heads = [s.latest_version(hint=-1) for s in shards]
        if len(set(heads)) == 1:
            return
    raise AssertionError(f"frontier never stabilized: {heads}")


def _ids(view) -> list:
    return [t.tgb_id for t in view.tgbs]


def _materialize_tgbs(ns: Namespace) -> None:
    """Back every committed descriptor with a real object so fsck's
    missing-tgb/size audits pass (these tests commit descriptors only)."""
    m = open_manifest_store(ns)
    view = m.load_view(m.latest_version())
    for t in view.tgbs:
        ns.store.put(t.object_key, b"\x00" * t.size_bytes)


# ---------------------------------------------------------------------------
# latest_version discovery: galloping probe, O(log gap) not O(gap)
# ---------------------------------------------------------------------------

class TestGallopingDiscovery:
    def _chain(self, head: int) -> ManifestStore:
        ns = _ns()
        ms = ManifestStore(ns)
        for v in range(head + 1):
            assert ms.try_put_version(v, b"x")
        return ManifestStore(ns)  # fresh instance: no warm probe state

    def test_cold_start_uses_list_not_probes(self):
        ms = self._chain(300)
        assert ms.latest_version(hint=-1) == 300
        assert ms.last_probe_count == 0

    def test_at_head_is_two_probes(self):
        # one GET for head+1 (miss) plus one confirming the hint still
        # exists — the confirm is what lets a GC-stranded reader re-sync
        # instead of stalling at a deleted hint forever
        ms = self._chain(300)
        assert ms.latest_version(hint=300) == 300
        assert ms.last_probe_count == 2

    def test_small_gap_is_cheap(self):
        ms = self._chain(300)
        assert ms.latest_version(hint=299) == 300
        assert ms.last_probe_count <= 3

    def test_gc_hole_resyncs_via_list(self):
        # retention deleted a dense prefix out from under a stale reader:
        # hint+1 AND hint are both gone. The old probe returned the hint
        # (reading the hole as the chain head) and the reader stalled
        # forever; now it falls back to LIST and finds the true head.
        ns = _ns()
        ms = ManifestStore(ns)
        for v in range(301):
            assert ms.try_put_version(v, b"x")
        for v in range(250):  # GC: dense prefix trim
            ns.store.delete(ms.manifest_key(v))
        stale = ManifestStore(ns)
        assert stale.latest_version(hint=100) == 300

    def test_stale_list_never_regresses_below_hint(self):
        # a reader that has LOADED version v can never see the chain report
        # a head below v, even if the backing LIST is stale/empty
        ns = _ns()
        ms = ManifestStore(ns)
        for v in range(4):
            assert ms.try_put_version(v, b"x")
        for v in range(4):  # simulate a fully stale LIST window
            ns.store.delete(ms.manifest_key(v))
        assert ManifestStore(ns).latest_version(hint=3) == 3

    def test_large_gap_is_logarithmic(self):
        head = 1000
        ms = self._chain(head)
        for hint in (0, 7, 500, 937):
            gap = head - hint
            assert ms.latest_version(hint=hint) == head
            bound = 2 * math.ceil(math.log2(gap + 1)) + 4
            assert ms.last_probe_count <= bound, \
                (hint, ms.last_probe_count, bound)
            # the regression this guards: the old linear probe paid one GET
            # per version in the gap
            assert ms.last_probe_count < gap / 4

    def test_empty_chain(self):
        ms = ManifestStore(_ns())
        assert ms.latest_version(hint=-1) == -1


# ---------------------------------------------------------------------------
# layout resolution and K=1 compatibility
# ---------------------------------------------------------------------------

class TestLayoutResolution:
    def test_unsharded_run_stays_legacy(self):
        ns = _ns()
        ms = open_manifest_store(ns)
        assert isinstance(ms, ManifestStore)
        assert ms.format == MANIFEST_FORMAT_FLAT
        proto = CommitProtocol(ms, "p0")
        _commit(proto, [_tgb("p0", 0), _tgb("p0", 1)])
        # byte-compat with pre-sharding builds: the only keys under
        # manifest/ are the version objects, and flat docs carry exactly
        # the legacy field set (no commit_runs, no shard metadata)
        keys = [k for k in ns.store.list(ns.key("manifest") + "/")]
        assert keys == [ns.key("manifest", "00000000.manifest")]
        doc = decode_manifest(ns.store.get(keys[0]))
        assert set(doc) == {"format", "version", "base_step", "tgbs",
                            "producers"}
        assert doc["format"] == MANIFEST_FORMAT_FLAT

    def test_shard_claim_first_writer_wins(self):
        ns = _ns()
        assert open_manifest_store(ns, shards=4).n_shards == 4
        # a lost claim race adopts the committed K — shard count is
        # immutable for the life of a run
        assert open_manifest_store(ns, shards=8).n_shards == 4
        assert read_shard_config(ns) == 4

    def test_sharded_chains_pin_delta_encoding(self):
        ns = _ns()
        ms = open_manifest_store(ns, shards=2)
        assert isinstance(ms, ShardedManifestStore)
        assert ms.format == MANIFEST_FORMAT_DELTA
        # discovery (no fmt argument) resolves to the recorded encoding
        assert open_manifest_store(ns).format == MANIFEST_FORMAT_DELTA

    def test_claim_refused_on_run_with_legacy_history(self):
        # claiming a shard layout over a run with committed single-chain
        # manifests would make the whole history invisible to sharded
        # readers (empty dataset, producers re-commit from offset -1) —
        # refuse loudly instead
        ns = _ns()
        proto = CommitProtocol(open_manifest_store(ns), "p0")
        _commit(proto, [_tgb("p0", 0)])
        with pytest.raises(ValueError, match="single-chain manifest"):
            write_shard_config(ns, 4)
        with pytest.raises(ValueError, match="single-chain manifest"):
            open_manifest_store(ns, shards=4)
        # the run stays readable as the legacy layout it is
        m = open_manifest_store(ns)
        assert isinstance(m, ManifestStore)
        assert m.load_view(m.latest_version()).total_steps == 1

    def test_k1_claim_yields_plain_store(self):
        ns = _ns()
        # shards=1 never claims a layout: the run IS the legacy single chain
        assert isinstance(open_manifest_store(ns, shards=1), ManifestStore)
        assert ns.store.exists(ns.key("manifest", "shards.cfg")) is False
        # and the config writer refuses a degenerate claim outright
        with pytest.raises(ValueError):
            write_shard_config(ns, 1)


# ---------------------------------------------------------------------------
# merged read view: determinism, incrementality, exactly-once
# ---------------------------------------------------------------------------

class TestMergedView:
    def _run(self, n_shards=4, pids=("p0", "p1", "p2"), rounds=12):
        ns = _ns()
        open_manifest_store(ns, shards=n_shards)
        protos = {pid: ShardedCommitProtocol(open_manifest_store(ns), pid)
                  for pid in pids}
        seqs = {pid: 0 for pid in pids}
        warm = open_manifest_store(ns)
        prev_ids: list = []
        for r in range(rounds):
            pid = pids[r % len(pids)]
            batch = [_tgb(pid, seqs[pid] + i) for i in range(1 + r % 3)]
            _commit(protos[pid], batch)
            seqs[pid] += len(batch)
            # warm poll mid-run: the merged step sequence is append-only
            ids = _ids(warm.load_view(warm.latest_version()))
            assert ids[:len(prev_ids)] == prev_ids
            prev_ids = list(ids)
        _quiesce(protos)
        return ns, protos, seqs, warm

    def test_cold_equals_incremental_and_exactly_once(self):
        ns, protos, seqs, warm = self._run()
        warm_ids = _ids(warm.load_view(warm.latest_version()))
        cold = open_manifest_store(ns)
        cold_view = cold.load_view(cold.latest_version())
        assert _ids(cold_view) == warm_ids
        assert len(set(warm_ids)) == len(warm_ids)
        assert cold_view.total_steps == sum(seqs.values())
        for pid, n in seqs.items():
            got = [t.producer_seq for t in cold_view.tgbs
                   if t.producer_id == pid]
            assert got == list(range(n))
            assert cold_view.producer_offset(pid) == n - 1

    def test_cross_shard_switch_is_exactly_once(self):
        ns = _ns()
        open_manifest_store(ns, shards=4)
        proto = ShardedCommitProtocol(open_manifest_store(ns), "p0")
        batch = [_tgb("p0", i) for i in range(5)]
        _commit(proto, list(batch))
        home = proto.shard
        proto.chooser.move_to((home + 1) % 4)
        # re-offer a stale suffix plus one genuinely new TGB: the stale part
        # must be dropped by the cross-shard committed-offset dedup, never
        # re-appended to the new home shard
        _commit(proto, batch[2:] + [_tgb("p0", 5)])
        assert proto.stats.merged_dedups >= 3
        _quiesce({"p0": proto})
        cold = open_manifest_store(ns)
        view = cold.load_view(cold.latest_version())
        assert [t.producer_seq for t in view.tgbs] == list(range(6))
        assert sorted(set(_ids(view))) == sorted(_ids(view))

    def test_flush_frontier_makes_quiesced_run_fully_consumable(self):
        ns = _ns()
        open_manifest_store(ns, shards=4)
        proto = ShardedCommitProtocol(open_manifest_store(ns), "p0")
        for i in range(6):
            _commit(proto, [_tgb("p0", i)])
        # before the flush only min_k(head) bounds stability: idle shards
        # hold the frontier at -1 and the reader may see nothing
        proto.flush_frontier()
        heads = [s.latest_version(hint=-1)
                 for s in proto.manifests.shards]
        assert len(set(heads)) == 1, heads
        cold = open_manifest_store(ns)
        assert cold.load_view(cold.latest_version()).total_steps == 6
        assert proto.stats.heartbeats > 0


# ---------------------------------------------------------------------------
# compactor: fold, crash-window idempotence, repair
# ---------------------------------------------------------------------------

class TestCompactor:
    def _populated(self, total=18):
        ns = _ns()
        open_manifest_store(ns, shards=4)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        seqs = {p: 0 for p in protos}
        for i in range(total):
            pid = "p0" if i % 2 else "p1"
            _commit(protos[pid], [_tgb(pid, seqs[pid])])
            seqs[pid] += 1
        _quiesce(protos)
        reader = open_manifest_store(ns)
        ids = _ids(reader.load_view(reader.latest_version()))
        assert len(ids) == total
        return ns, protos, reader, ids

    def test_fold_preserves_cold_and_warm_views(self):
        ns, protos, reader, ids = self._populated()
        comp = Compactor(ns, reader, min_fold=4)
        summary = comp.run_cycle(safe_step=len(ids))
        assert summary["folded"] == len(ids)
        assert summary["segment"] == 0
        cold = open_manifest_store(ns)
        assert _ids(cold.load_view(cold.latest_version())) == ids
        assert _ids(reader.load_view(reader.latest_version())) == ids

    def test_crash_window_dedups_and_repair_converges(self):
        ns, protos, reader, ids = self._populated()
        comp = Compactor(ns, reader, min_fold=1)
        # crash between segment write and trim commits: the fold exists but
        # every shard chain still carries the folded prefix
        orig = comp._trim_shard
        comp._trim_shard = lambda k, f: False
        summary = comp.run_cycle(safe_step=len(ids))
        comp._trim_shard = orig
        assert summary["segment"] == 0
        cold = open_manifest_store(ns)
        cold_ids = _ids(cold.load_view(cold.latest_version()))
        assert cold_ids == ids  # folds ahead of trims must dedup, not double
        # restart: the next cycle notices folds ahead of trims and re-issues
        repaired = comp.run_cycle(safe_step=len(ids))
        assert repaired["repaired"] > 0
        cold2 = open_manifest_store(ns)
        assert _ids(cold2.load_view(cold2.latest_version())) == ids
        assert _ids(reader.load_view(reader.latest_version())) == ids

    def test_warm_reader_survives_segment_reclaim_gap(self):
        # a warm merged view that lags the fold horizon and then finds its
        # next segment RECLAIMED must treat the hole as trimmed history
        # (StepUnavailable below the retained boundary), not crash with a
        # false 'compaction orphan' — the legacy single-chain degradation
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        protos["p0"].chooser.move_to(0)
        protos["p1"].chooser.move_to(1)
        seqs = {p: 0 for p in protos}

        def push(n):
            for _ in range(n):
                for p in sorted(protos):
                    _commit(protos[p], [_tgb(p, seqs[p])])
                    seqs[p] += 1
            _quiesce(protos)

        push(4)  # 8 steps merged live by the warm reader, then it pauses
        warm = open_manifest_store(ns)
        assert warm.load_view(warm.latest_version()).total_steps == 8
        comp = Compactor(ns, open_manifest_store(ns), min_fold=1)
        push(4)
        comp.run_cycle(safe_step=12)   # segment 0 (covers the warm prefix)
        push(4)
        comp.run_cycle(safe_step=20)   # segment 1
        m = open_manifest_store(ns)
        segs = m.segments.seqs()
        assert len(segs) >= 2
        boundary = m.segments.read(segs[-1]).base_step
        assert boundary > 8  # the retained fold really starts past the pause
        for s in segs[:-1]:  # reclaim everything but the newest segment
            ns.store.delete(m.segments.seg_key(s))
        view = warm.load_view(warm.latest_version())  # must not raise
        assert view.base_step == boundary
        assert view.total_steps == sum(seqs.values())
        with pytest.raises(StepUnavailable):
            view.tgb_at_step(boundary - 1)
        cold = open_manifest_store(ns)
        assert _ids(cold.load_view(cold.latest_version())) == _ids(view)


# ---------------------------------------------------------------------------
# shard switching: dedup-floor ordering, pad-failure tau accounting
# ---------------------------------------------------------------------------

class TestShardSwitchSafety:
    def _proto(self, n_shards=2):
        ns = Namespace(
            MemoryObjectStore(latency=ZERO_LATENCY, clock=VirtualClock()),
            "runs/shardtest")
        open_manifest_store(ns, shards=n_shards)
        return ns, ShardedCommitProtocol(open_manifest_store(ns), "p0")

    def test_switch_aborted_when_offset_sweep_fails(self):
        # the cross-shard committed-offset re-derivation must succeed BEFORE
        # the chooser re-homes: moving first would open a window where a
        # commit lands on the new shard with a stale dedup floor and
        # re-appends TGBs the old shard already absorbed
        ns, proto = self._proto()
        _commit(proto, [_tgb("p0", 0)])
        home = proto.chooser.shard
        other = (home + 1) % 2
        proto.chooser.should_probe = lambda: True
        proto.chooser.choose = lambda loads: other

        def boom(pid):
            raise TransientStoreError("offset sweep down")

        proto.manifests.merged_producer_offset = boom
        proto._maybe_switch()
        assert proto.chooser.shard == home  # stayed put: floor never derived
        assert proto.stats.switches == 0
        del proto.manifests.merged_producer_offset  # store recovers
        proto._maybe_switch()
        assert proto.chooser.shard == other
        assert proto.stats.switches == 1
        assert proto._merged_offset == 0  # floor derived before the move

    def test_pad_failure_reports_elapsed_tau(self):
        # a failed ordering pad is a signal the destination chain is
        # unhealthy: tau_obs must be the real elapsed attempt time so DAC
        # backs off — feeding 0.0 would shrink the gap instead
        ns, proto = self._proto()
        clock = proto.clock

        def slow_pad(sub, shard):
            clock.sleep(0.25)
            raise TransientStoreError("chain not advancing")

        proto._pad_for_order = slow_pad
        proto._last_key = (5, (proto.chooser.shard + 1) % 2)
        batch = [_tgb("p0", 0)]
        res, still = proto.try_commit(list(batch))
        assert not res.success
        assert res.tau_obs >= 0.25
        assert still == batch  # nothing committed; batch stays pending


# ---------------------------------------------------------------------------
# fsck: sharded audits
# ---------------------------------------------------------------------------

class TestFsckSharded:
    def test_clean_sharded_run(self):
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        for i in range(4):
            _commit(protos["p0"], [_tgb("p0", i)])
        _quiesce(protos)
        _materialize_tgbs(ns)
        report = fsck(ns)
        assert not [i for i in report.all_issues() if i.severity == "error"], \
            report.summary()

    def test_crash_window_is_a_lagging_trim_warning(self):
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        seqs = {p: 0 for p in protos}
        for i in range(6):
            pid = "p0" if i % 2 else "p1"
            _commit(protos[pid], [_tgb(pid, seqs[pid])])
            seqs[pid] += 1
        _quiesce(protos)
        reader = open_manifest_store(ns)
        comp = Compactor(ns, reader, min_fold=1)
        comp._trim_shard = lambda k, f: False  # die before any trim lands
        comp.run_cycle(safe_step=6)
        _materialize_tgbs(ns)
        report = fsck(ns)
        kinds = {i.kind for i in report.all_issues()}
        assert "compaction-lagging-trim" in kinds, report.summary()
        # recoverable by a compactor restart, so a warning — not an error
        assert not [i for i in report.all_issues()
                    if i.kind == "compaction-lagging-trim"
                    and i.severity == "error"]

    def test_overtrimmed_shard_is_an_orphan_error(self):
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        seqs = {p: 0 for p in protos}
        for i in range(6):
            pid = "p0" if i % 2 else "p1"
            _commit(protos[pid], [_tgb(pid, seqs[pid])])
            seqs[pid] += 1
        _quiesce(protos)
        reader = open_manifest_store(ns)
        Compactor(ns, reader, min_fold=1).run_cycle(safe_step=6)
        # one post-fold entry per producer, then hand-trim one shard's base
        # past its folded count: that entry is covered by NO segment — a
        # lost prefix, which fsck must flag as an error, not a crash window
        for pid in protos:
            _commit(protos[pid], [_tgb(pid, seqs[pid])])
            seqs[pid] += 1
        _quiesce(protos)
        _materialize_tgbs(ns)  # before the corruption: merged reads refuse it
        m = open_manifest_store(ns)
        victim = next(k for k in range(2)
                      if m.shards[k].load_view(
                          m.shards[k].latest_version(hint=-1)).tgbs)
        shard = m.shards[victim]
        sub = CommitProtocol(shard, "trimmer")
        view = sub.refresh()
        v, raw = shard.encode_candidate(
            view, [], dict(view.producers),
            trim_to_step=view.base_step + 1)
        assert shard.try_put_version(v, raw)
        report = fsck(ns)
        issues = [i for i in report.all_issues()
                  if i.kind == "compaction-orphan"]
        assert issues and issues[0].severity == "error", report.summary()
        assert not report.clean


# ---------------------------------------------------------------------------
# lifecycle: sharded chain GC keeps cold reads reconstructable
# ---------------------------------------------------------------------------

class TestShardedReclaim:
    def test_gc_trims_chains_to_snapshot_and_preserves_view(self):
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        # pin the producers to distinct home shards and push both chains
        # past a snapshot boundary + one snapshot window (the GC horizon)
        protos["p0"].chooser.move_to(0)
        protos["p1"].chooser.move_to(1)
        per = 130  # heads reach 129 > 2 * snapshot_every(=64)
        for i in range(per):
            _commit(protos["p0"], [_tgb("p0", i)])
            _commit(protos["p1"], [_tgb("p1", i)])
        _quiesce(protos)
        rec = Reclaimer(
            ns, watermark_source=lambda: Watermark(version=0, step=0),
            shard_runway_windows=1)
        rec.run_cycle()
        assert rec.stats.manifests_deleted > 0
        m = open_manifest_store(ns)
        for shard in m.shards:
            versions = shard.list_versions()
            # everything below the newest snapshot >= one window behind
            # the head is gone; the snapshot itself survives
            assert versions[0] == 64, versions[:3]
            assert versions[-1] >= per - 1
        view = m.load_view(m.latest_version())
        assert view.total_steps == 2 * per
        assert len(set(_ids(view))) == 2 * per

    def test_default_runway_defers_trim(self):
        # the default multi-window runway must NOT trim a chain whose head
        # is only ~2 windows old — that runway is what keeps warm readers'
        # probe hints valid across realistic consumer pauses
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        protos["p0"].chooser.move_to(0)
        protos["p1"].chooser.move_to(1)
        for i in range(130):
            _commit(protos["p0"], [_tgb("p0", i)])
            _commit(protos["p1"], [_tgb("p1", i)])
        _quiesce(protos)
        rec = Reclaimer(
            ns, watermark_source=lambda: Watermark(version=0, step=0))
        rec.run_cycle()
        assert rec.stats.manifests_deleted == 0

    def test_stale_warm_reader_resyncs_after_chain_gc(self):
        # a warm reader whose cached per-shard probe hints fall into the GC
        # hole must re-sync to the true heads (via the LIST fallback), not
        # conclude the chains are idle and stall the merged frontier forever
        ns = _ns()
        open_manifest_store(ns, shards=2)
        protos = {p: ShardedCommitProtocol(open_manifest_store(ns), p)
                  for p in ("p0", "p1")}
        protos["p0"].chooser.move_to(0)
        protos["p1"].chooser.move_to(1)
        warm = open_manifest_store(ns)
        for i in range(4):
            _commit(protos["p0"], [_tgb("p0", i)])
            _commit(protos["p1"], [_tgb("p1", i)])
        _quiesce(protos)
        seen = warm.load_view(warm.latest_version()).total_steps
        assert seen == 8  # warm reader caches per-shard hints, then pauses
        for i in range(4, 130):
            _commit(protos["p0"], [_tgb("p0", i)])
            _commit(protos["p1"], [_tgb("p1", i)])
        _quiesce(protos)
        Reclaimer(ns, watermark_source=lambda: Watermark(version=0, step=0),
                  shard_runway_windows=1).run_cycle()
        m = open_manifest_store(ns)
        # the GC hole must actually cover the warm reader's cached hints
        assert all(s.list_versions()[0] > max(warm._probed) for s in m.shards)
        view = warm.load_view(warm.latest_version())  # the reader wakes up
        assert view.total_steps == 2 * 130
        assert len(set(_ids(view))) == 2 * 130


# ---------------------------------------------------------------------------
# end to end through the dataplane facade
# ---------------------------------------------------------------------------

class TestSessionEndToEnd:
    def test_tgb_session_claims_and_reads_sharded_run(self):
        import numpy as np
        from repro_torch.dataplane import Topology, open_dataplane

        store = MemoryObjectStore(latency=ZERO_LATENCY)
        topo = Topology(dp=1, cp=1, global_batch=2, seq_len=8)
        sess = open_dataplane(store, topo, backend="tgb",
                              namespace="runs/shardsess", manifest_shards=4)
        ns = Namespace(store, "runs/shardsess")
        assert read_shard_config(ns) == 4
        tokens = (np.arange(8 * topo.global_batch * topo.seq_len)
                  % 251).astype(np.int32)
        with sess.writer("w0") as w:
            w.write_tokens(tokens)
        reader = sess.reader()
        got = []
        for _ in range(8):
            got.append(np.frombuffer(reader.next_batch(timeout_s=10).payload,
                                     dtype=np.int32))
        flat = np.concatenate(got)
        assert np.array_equal(flat, tokens[:flat.size])


# ---------------------------------------------------------------------------
# property: flat-encode <-> delta-chain <-> merged-shard decode round-trip
# ---------------------------------------------------------------------------

N_PIDS, N_SHARDS, MAX_BATCH = 3, 4, 3


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(
    st.integers(min_value=0, max_value=N_PIDS * N_SHARDS * MAX_BATCH - 1),
    min_size=1, max_size=18))
def test_property_shard_merge_roundtrips_dataset_view(ops):
    """Arbitrary interleavings of per-shard commits (delta-encoded chains)
    must merge into a DatasetView that survives a flat-encode round trip
    bit-for-bit in its observable state: step order, producer map, offsets."""
    ns = _ns("runs/prop")
    open_manifest_store(ns, shards=N_SHARDS)
    protos = {}
    seqs = {}
    for op in ops:
        pid = f"p{op % N_PIDS}"
        shard = (op // N_PIDS) % N_SHARDS
        n = (op // (N_PIDS * N_SHARDS)) % MAX_BATCH + 1
        proto = protos.get(pid)
        if proto is None:
            proto = protos[pid] = ShardedCommitProtocol(
                open_manifest_store(ns), pid)
            seqs[pid] = 0
        if proto.chooser.shard != shard:
            proto.chooser.move_to(shard)
        batch = [_tgb(pid, seqs[pid] + i) for i in range(n)]
        _commit(proto, batch)
        seqs[pid] += n
    _quiesce(protos)

    cold = open_manifest_store(ns)
    merged = cold.load_view(cold.latest_version())
    total = sum(seqs.values())
    assert merged.total_steps == total
    assert len(set(_ids(merged))) == total
    for pid, n in seqs.items():
        got = [t.producer_seq for t in merged.tgbs if t.producer_id == pid]
        assert got == list(range(n))
        assert merged.producer_offset(pid) == n - 1

    # warm == cold: a second reader decoding from scratch sees the identical
    # globally-ordered step sequence (deterministic shard merge)
    cold2 = open_manifest_store(ns)
    assert _ids(cold2.load_view(cold2.latest_version())) == _ids(merged)

    # flat round trip: re-encode the merged state with the paper-faithful
    # flat codec, reload through a plain ManifestStore, compare observables
    flat_view = DatasetView(version=0, base_step=merged.base_step,
                            tgbs=list(merged.tgbs),
                            producers=dict(merged.producers))
    ns2 = _ns("runs/prop-rt")
    ms2 = ManifestStore(ns2)
    assert ms2.try_put_version(0, encode_flat_manifest(flat_view))
    rt = ms2.load_view(0)
    assert _ids(rt) == _ids(merged)
    assert rt.base_step == merged.base_step
    assert set(rt.producers) == set(merged.producers)
    for pid in seqs:
        assert rt.producer_offset(pid) == merged.producer_offset(pid)
    assert [t.producer_id for t in rt.tgbs] == \
           [t.producer_id for t in merged.tgbs]


# ---------------------------------------------------------------------------
# Across packages: a compact segment written by either package
# ---------------------------------------------------------------------------

def _twin_ns(ns, core, objects=None):
    """``core``'s Namespace over ``ns``'s objects (or over ``objects``)."""
    twin = core.MemoryObjectStore(latency=core.ZERO_LATENCY)
    if objects is None:
        twin._objects, twin._lock = ns.store._objects, ns.store._lock
    else:
        twin._objects = objects
    return core.Namespace(twin, ns.prefix)


@pytest.mark.parametrize("folder", ["repro", "repro_torch"])
def test_a_compact_segment_reads_back_in_the_other_package(folder):
    pytest.importorskip("msgpack")
    import repro.core as jcore
    import repro.core.manifest as jmanifest
    import repro_torch.core as tcore
    import repro_torch.core.manifest as tmanifest

    cores = {"repro": jcore, "repro_torch": tcore}
    ns, protos, reader, ids = TestCompactor()._populated(total=18)
    before = dict(ns.store._objects)
    segs = {}
    for name, core in cores.items():
        fns = _twin_ns(ns, core, objects=dict(before))
        comp = core.Compactor(fns, core.open_manifest_store(fns), min_fold=1)
        summary = comp.run_cycle(safe_step=12)
        assert summary == {"folded": 12, "repaired": 0, "segment": 0}
        segs[name] = fns
    key = tmanifest.SegmentStore(ns).seg_key(0)
    raw = {name: bytes(fns.store.get(key)) for name, fns in segs.items()}
    assert raw["repro"] == raw["repro_torch"]   # one fold, one byte string
    assert tmanifest.CompactSegment.unpack(raw["repro"]).pack() == \
        jmanifest.CompactSegment.unpack(raw["repro"]).pack() == raw["repro"]
    # the folder's run, read cold and warm by both packages' merged views
    folded = segs[folder]
    for core in cores.values():
        rns = _twin_ns(folded, core)
        cold = core.open_manifest_store(rns)
        view = cold.load_view(cold.latest_version())
        assert _ids(view) == ids
        assert view.seg_seq == 0 and view.base_step == 0
        heads = [s.latest_version(hint=-1) for s in cold.shards]
        bases = [s.load_view(h).base_step for s, h in zip(cold.shards, heads)]
        assert sum(bases) == 12
    # a later fold by the other package continues the folder's chain
    other = cores["repro" if folder == "repro_torch" else "repro_torch"]
    ons = _twin_ns(folded, other)
    assert other.Compactor(ons, other.open_manifest_store(ons),
                           min_fold=1).run_cycle(safe_step=18)["segment"] == 1
    cold = tcore.open_manifest_store(_twin_ns(folded, tcore))
    assert _ids(cold.load_view(cold.latest_version())) == ids
