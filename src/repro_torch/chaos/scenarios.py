"""Named kill/restart scenarios at the protocol points that matter.

Each scenario kills (or degrades) exactly one component at a named point in
the commit/read/reclaim protocol, recovers it the way an operator would, and
asserts the §5 guarantees: exactly-once delivery, atomic all-rank
visibility, and a clean ``fsck`` after repair. See ``harness.py`` for the
shared machinery and ``docs/OPERATIONS.md`` for the matching playbooks.

Protocol points covered:

  producer_precommit_kill        crash *before* the conditional manifest put
  producer_post_upload_kill      crash after a TGB upload, before its commit
  consumer_midstep_kill          reader dies past its last checkpoint
  mixed_reader_midstep_kill      same, across weighted multi-stream mixing
  reclaimer_midtrim_kill         reclaimer dies halfway through deletion
  cput_conflict_storm            3 producers × injected 5xx/lost-ack commits
  flaky_reads                    consumer under 5xx / short / stale reads
  trainer_midcheckpoint_kill     trainer dies between model upload and its
                                 RunManifest commit (aligned recovery)
  derive_worker_midpublish_kill  derive worker dies between publishing its
                                 outputs and committing the derive cursor
  producer_kill_obs_postmortem   killed producer diagnosed post-mortem from
                                 its flight-recorder snapshots alone
  brownout_throttle_storm        producers + consumer ride out a scripted 503
                                 SlowDown storm behind the ResilientStore
  store_outage_resume            full store outage mid-run: consumer serves
                                 prefetched TGBs, producer spills and replays
  shard_conflict_storm           6 producers × injected 5xx over a 4-shard
                                 manifest plane (rebase + shard choice +
                                 cross-shard dedup)
  compactor_midfold_kill         compactor dies between segment write and
                                 shard trims; readers dedup, repair is
                                 idempotent

Port of ``repro.chaos.scenarios``, copied as it is but for its imports:
the model state stays a numpy leaf, so no scenario allocates a tensor.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import (BrownoutPhase, Consumer, FaultPolicy,
                              FaultyObjectStore, InjectedCrash, ManifestStore,
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, Reclaimer, ResilienceConfig,
                              ResilientStore, Watermark, write_watermark)
from repro_torch.dataplane import Topology
from repro_torch.run import TrainSession
from repro_torch.chaos.harness import (CHAOS_PREFIX, ScenarioResult,
                                       assert_all_ranks_converge,
                                       assert_exactly_once, audit_and_repair,
                                       deterministic_payload, drain, fresh_ns,
                                       latest_view, make_slices, now,
                                       produce_range, reader, scenario)
from repro_torch.ops import fsck

N_TGBS = 10


def _killed_producer_run(ns: Namespace, crash_op: str, crash_sub: str,
                         nth: int, phase: str, dp: int = 2) -> None:
    """Drive a producer into an injected crash at the named protocol point."""
    ns.store.faults.crash_on(crash_op, key_substr=crash_sub, nth=nth,
                             phase=phase)
    p = Producer(ns, "P", dp=dp, cp=1)
    p.recover()
    try:
        produce_range(p, N_TGBS)
    except InjectedCrash:
        return
    raise AssertionError(f"crash rule ({crash_op}, {crash_sub!r}, nth={nth}, "
                         f"{phase}) never fired")


def _recover_and_verify(ns: Namespace, name: str, dp: int = 2
                        ) -> ScenarioResult:
    """Shared back half of the producer-kill scenarios: replace the producer,
    resume from durable state, and check every guarantee."""
    ns.store.faults = None  # the kill happened; the replacement runs clean
    t0 = now()
    replacement = Producer(ns, "P", dp=dp, cp=1, epoch=1)
    resume = replacement.recover()
    assert resume >= 0, "recover() must yield a resumable offset"
    produce_range(replacement, N_TGBS)
    recovery_latency = now() - t0

    # exactly-once, per rank, byte-identical payloads
    consumers = [reader(ns, d, 0, dp, 1) for d in range(dp)]
    for d, cons in enumerate(consumers):
        assert_exactly_once(drain(cons, N_TGBS), "P", d, 0, N_TGBS)
    assert_all_ranks_converge(consumers)

    # the crashed incarnation's uncommitted TGB must surface as a safe
    # orphan, and the namespace must audit clean once repaired
    orphans, clean = audit_and_repair(ns)
    assert orphans >= 1, "expected the killed incarnation to leave an orphan"
    assert clean, "fsck not clean after repair"
    return ScenarioResult(name=name, passed=True,
                          steps_delivered=N_TGBS * dp,
                          recovery_latency_s=recovery_latency,
                          orphans_detected=orphans, fsck_clean_after=True)


@scenario("producer_precommit_kill")
def producer_precommit_kill(seed: int = 0) -> ScenarioResult:
    """Kill the producer right before its 3rd conditional manifest put: two
    offsets are durable, one TGB is uploaded but unpublished."""
    ns = fresh_ns()
    _killed_producer_run(ns, "cput", ".manifest", nth=3, phase="before")
    return _recover_and_verify(ns, "producer_precommit_kill")


@scenario("producer_post_upload_kill")
def producer_post_upload_kill(seed: int = 0) -> ScenarioResult:
    """Kill the producer right after its 4th TGB upload (post-upload,
    pre-manifest): the object exists but no manifest ever names it."""
    ns = fresh_ns()
    _killed_producer_run(ns, "put", "/tgb/", nth=4, phase="after")
    return _recover_and_verify(ns, "producer_post_upload_kill")


@scenario("producer_kill_obs_postmortem")
def producer_kill_obs_postmortem(seed: int = 0) -> ScenarioResult:
    """Kill a producer mid-run and diagnose it from storage alone: the
    flight recorder published a snapshot per commit attempt, so ``top``
    renders the dead incarnation's counters with no process left to ask.
    Recovery then proceeds exactly like the plain post-upload kill —
    telemetry must never perturb the data path."""
    import io

    from repro_torch.obs.recorder import latest_snapshot
    from repro_torch.ops.obs import component_summary, obs_summary, render_top

    ns = fresh_ns()
    # 6th TGB upload lands, then the process dies before committing it
    ns.store.faults.crash_on("put", key_substr="/tgb/", nth=6, phase="after")
    p = Producer(ns, "P", dp=2, cp=1, obs_snap_interval_s=0.0)
    comp = p.stats.metric_scope  # registry may suffix across scenarios
    p.recover()
    try:
        produce_range(p, N_TGBS)
        raise AssertionError("crash rule (put, '/tgb/', nth=6) never fired")
    except InjectedCrash:
        pass
    del p  # the incarnation is gone; only the object store remains

    # post-mortem: storage is the only witness left
    snap = latest_snapshot(ns, comp)
    assert snap is not None, "dead producer left no readable snapshot"
    written = snap["metrics"].get(f"{comp}.tgbs_written", 0)
    assert written >= 1, f"last snapshot shows no work: {snap['metrics']}"
    row = component_summary(ns, comp)
    assert row["family"] == "producer" and row["snaps"] >= 2, row
    assert "conflict_rate" in row, row
    summary = obs_summary(ns)
    assert comp in {r["component"] for r in summary["components"]}
    buf = io.StringIO()
    render_top(summary, buf)
    assert comp in buf.getvalue(), buf.getvalue()

    return _recover_and_verify(ns, "producer_kill_obs_postmortem")


@scenario("consumer_midstep_kill")
def consumer_midstep_kill(seed: int = 0) -> ScenarioResult:
    """Kill a reader two steps past its last checkpoint; a replacement
    restores the <V, S> cursor and replays the lost window byte-identically
    (exactly-once relative to checkpointed training state)."""
    ns = fresh_ns()
    p = Producer(ns, "P", dp=1, cp=1)
    produce_range(p, 12)
    cons = reader(ns, 0, 0, 1, 1)
    seen = drain(cons, 5)
    v, s = cons.cursor                       # checkpointed at step 5
    lost = drain(cons, 2)                    # consumed past the checkpoint...
    del cons                                 # ...then killed
    t0 = now()
    cons2 = reader(ns, 0, 0, 1, 1)
    cons2.restore_cursor(v, s)
    replay = drain(cons2, 7)
    recovery_latency = now() - t0
    assert replay[:2] == lost, "post-checkpoint window did not replay " \
                               "byte-identically"
    assert_exactly_once(seen + replay, "P", 0, 0, 12)
    report = fsck(ns)
    assert report.clean, report.summary()
    return ScenarioResult(name="consumer_midstep_kill", passed=True,
                          steps_delivered=12,
                          recovery_latency_s=recovery_latency,
                          fsck_clean_after=True)


@scenario("mixed_reader_midstep_kill")
def mixed_reader_midstep_kill(seed: int = 0) -> ScenarioResult:
    """Kill a multi-stream MixedReader mid-step; a replacement restores the
    composite checkpoint (mix position + every stream's cursor) and the
    deterministic schedule replays identically."""
    from repro_torch.dataplane import Topology, open_dataplane

    store = MemoryObjectStore()
    session = open_dataplane(store, Topology(dp=1, cp=1), backend="tgb",
                             namespace=CHAOS_PREFIX,
                             streams={"a": 2.0, "b": 1.0}, mix_seed=seed)
    total = 12
    counts = session.plan.stream_counts(total)
    for name in session.stream_names:
        with session.writer(f"w-{name}", stream=name) as w:
            for off in range(counts[name]):
                w.write(slices={(0, 0): deterministic_payload(name, off)})
    expected = []
    for g in range(total):
        name, s_step = session.plan.position(g)
        expected.append(deterministic_payload(name, s_step))

    r = session.reader()
    seen = [r.next_batch(timeout_s=10.0) for _ in range(5)]
    token = r.checkpoint()                   # composite: mix pos + cursors
    lost = [r.next_batch(timeout_s=10.0) for _ in range(2)]
    r.close()                                # killed mid-step
    t0 = now()
    r2 = session.reader(resume=token)
    replay = [r2.next_batch(timeout_s=10.0) for _ in range(total - 5)]
    recovery_latency = now() - t0
    got = [b.payload for b in seen + replay]
    assert [b.payload for b in replay[:2]] == [b.payload for b in lost], \
        "post-checkpoint mixed window did not replay identically"
    assert got == expected, "mixed exactly-once violated (payload mismatch)"
    sched = [session.plan.position(g)[0] for g in range(total)]
    assert [b.stream for b in seen + replay] == sched, \
        "stream routing diverged from the deterministic schedule"
    report = fsck(Namespace(store, CHAOS_PREFIX))
    assert report.clean, report.summary()
    session.close()
    return ScenarioResult(name="mixed_reader_midstep_kill", passed=True,
                          steps_delivered=total,
                          recovery_latency_s=recovery_latency,
                          fsck_clean_after=True)


@scenario("reclaimer_midtrim_kill")
def reclaimer_midtrim_kill(seed: int = 0) -> ScenarioResult:
    """Kill the reclaimer halfway through physical deletion; a restarted
    reclaimer completes idempotently and every checkpoint-needed step
    survives."""
    ns = fresh_ns()
    p = Producer(ns, "P", dp=1, cp=1)
    produce_range(p, 12)
    v_latest = ManifestStore(ns).latest_version()
    write_watermark(ns, 0, Watermark(version=v_latest, step=8))
    ns.store.faults.crash_on("delete", "/tgb/", nth=3)
    crashed = False
    try:
        Reclaimer(ns, expected_ranks=1).run_cycle()
    except InjectedCrash:
        crashed = True
    assert crashed, "delete crash rule never fired"
    ns.store.faults = None
    t0 = now()
    r2 = Reclaimer(ns, expected_ranks=1)
    r2.run_cycle()
    recovery_latency = now() - t0
    # steps >= 8 survive and replay exactly from the checkpoint cursor
    cons = reader(ns, 0, 0, 1, 1)
    cons.restore_cursor(v_latest, 8)
    got = drain(cons, 4)
    want = [deterministic_payload("P", off, 0, 0) for off in range(8, 12)]
    assert got == want, "checkpoint-needed steps were damaged by the trim"
    # everything below the watermark is gone (both cycles together)
    remaining = ns.store.list(ns.key("tgb"))
    assert len(remaining) == 4, f"expected 4 surviving TGBs, found " \
                                f"{len(remaining)}"
    report = fsck(ns)
    assert report.clean, report.summary()
    return ScenarioResult(name="reclaimer_midtrim_kill", passed=True,
                          steps_delivered=4,
                          recovery_latency_s=recovery_latency,
                          fsck_clean_after=True)


@scenario("cput_conflict_storm")
def cput_conflict_storm(seed: int = 0) -> ScenarioResult:
    """Three producers force-committing every TGB while the store injects
    conditional-put 5xx — 60% of them *lost acks* (the put landed before the
    'failure'). The rebase + ambiguity-resolution machinery must keep every
    stream gap-free and duplicate-free."""
    inner = MemoryObjectStore()
    store = FaultyObjectStore(inner, FaultPolicy(
        seed=seed, cput_error_rate=0.3, cput_lost_ack_rate=0.6,
        key_filter=".manifest", max_faults=24))
    ns = Namespace(store, CHAOS_PREFIX)
    n_producers, per = 3, 6
    producers = [Producer(ns, f"P{i}", dp=1, cp=1) for i in range(n_producers)]
    errs = []

    def body(p: Producer):
        try:
            produce_range(p, per)
        except Exception as e:  # surfaced after join
            errs.append((p.producer_id, e))

    t0 = now()
    threads = [threading.Thread(target=body, args=(p,)) for p in producers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    recovery_latency = now() - t0
    assert not errs, f"producers died in the storm: {errs}"

    clean_ns = Namespace(inner, CHAOS_PREFIX)
    view = latest_view(clean_ns)
    for i in range(n_producers):
        seqs = [t.producer_seq for t in view.tgbs
                if t.producer_id == f"P{i}"]
        assert seqs == list(range(per)), \
            f"P{i} stream corrupted under the storm: {seqs}"
    # drain everything; per-producer payload order must be exact
    cons = Consumer(clean_ns, MeshPosition(0, 0, 1, 1))
    per_pid: dict = {}
    for _ in range(n_producers * per):
        payload = cons.next_batch(timeout_s=10.0)
        pid, off = bytes(payload).split(b"|", 1)[0].decode().split(":")[:2]
        per_pid.setdefault(pid, []).append((int(off), payload))
    for i in range(n_producers):
        pid = f"P{i}"
        offs = [o for o, _ in per_pid[pid]]
        assert offs == list(range(per)), f"{pid} delivered {offs}"
        for off, payload in per_pid[pid]:
            assert payload == deterministic_payload(pid, off), \
                f"{pid}@{off} payload corrupted"
    report = fsck(clean_ns)
    assert report.clean, report.summary()
    conflicts = sum(p.stats.commit_conflicts for p in producers)
    return ScenarioResult(name="cput_conflict_storm", passed=True,
                          steps_delivered=n_producers * per,
                          recovery_latency_s=recovery_latency,
                          faults_injected=store.fault_stats.total,
                          fsck_clean_after=True,
                          detail=f"{conflicts} conflicts rebased")


@scenario("flaky_reads")
def flaky_reads(seed: int = 0) -> ScenarioResult:
    """Consumer survives 5xx, truncated range-GETs, slow reads, and stale
    windows: bounded retries + CRC verification deliver every batch
    byte-perfect."""
    inner = MemoryObjectStore()
    store = FaultyObjectStore(inner, FaultPolicy(
        seed=seed, get_error_rate=0.12, short_read_rate=0.12,
        slow_get_rate=0.1, slow_get_s=0.001, stale_read_rate=0.25,
        stale_depth=3, max_faults=80))
    ns = Namespace(store, CHAOS_PREFIX)
    produce_range(Producer(ns, "P", dp=1, cp=1), N_TGBS)
    t0 = now()
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    got = drain(cons, N_TGBS)
    elapsed = now() - t0
    assert_exactly_once(got, "P", 0, 0, N_TGBS)
    report = fsck(Namespace(inner, CHAOS_PREFIX))
    assert report.clean, report.summary()
    return ScenarioResult(name="flaky_reads", passed=True,
                          steps_delivered=N_TGBS,
                          recovery_latency_s=elapsed,
                          faults_injected=store.fault_stats.total,
                          fsck_clean_after=True,
                          detail=f"{cons.stats.read_retries} read retries")


@scenario("trainer_midcheckpoint_kill")
def trainer_midcheckpoint_kill(seed: int = 0) -> ScenarioResult:
    """Kill the trainer *between* the model-state upload and the RunManifest
    commit — the exact window that silently broke exactly-once when model
    and data cursors were two separate saves. The RunManifest makes the
    commit the atom: recovery resumes from the previous *aligned* checkpoint
    (old model + old cursor together), replays the lost window
    byte-identically, and the half-uploaded model surfaces as a safe orphan
    once a later aligned checkpoint supersedes it."""
    from repro_torch.core import FaultInjector

    n = 12
    store = MemoryObjectStore(faults=FaultInjector())
    ns = Namespace(store, CHAOS_PREFIX)
    p = Producer(ns, "P", dp=1, cp=1)
    p.recover()
    produce_range(p, n)

    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=CHAOS_PREFIX)
    r = sess.reader(0, 0)
    seen = [r.next_batch(timeout_s=10).payload for _ in range(4)]
    state1 = {"w": np.arange(8, dtype=np.float32) + seed}
    entry = sess.checkpoint(state1)            # aligned @ step 4 (seq 0)
    assert entry.step == 4
    lost = [r.next_batch(timeout_s=10).payload for _ in range(2)]  # steps 4,5

    # the fatal window: model for step 6 uploads, the RunManifest put dies
    store.faults.crash_on("cput", key_substr=".rm", nth=1, phase="before")
    try:
        sess.checkpoint({"w": state1["w"] * -1.0})
        raise AssertionError("crash between upload and commit never fired")
    except InjectedCrash:
        pass
    store.faults = None

    t0 = now()
    sess2 = TrainSession.resume(store, CHAOS_PREFIX)
    assert sess2.resume_step == 4, \
        f"resume landed at {sess2.resume_step}, not the aligned step 4"
    state = sess2.restore_model({"w": np.zeros(8, dtype=np.float32)})
    assert np.array_equal(np.asarray(state["w"]), state1["w"]), \
        "restored model is not the aligned (pre-crash) state"
    r2 = sess2.reader(0, 0)
    replay = [r2.next_batch(timeout_s=10).payload for _ in range(n - 4)]
    recovery_latency = now() - t0

    assert replay[:2] == lost, "post-checkpoint window did not replay " \
                               "byte-identically"
    assert_exactly_once(seen + replay, "P", 0, 0, n)

    # a later aligned checkpoint supersedes the torn step-6 upload; fsck then
    # flags it as a safe orphan and repairs to clean
    sess2.checkpoint(state)
    orphans, clean = audit_and_repair(ns)
    assert orphans >= 1, "expected the torn model upload to surface as orphan"
    assert clean, "fsck not clean after repair"
    return ScenarioResult(name="trainer_midcheckpoint_kill", passed=True,
                          steps_delivered=n,
                          recovery_latency_s=recovery_latency,
                          orphans_detected=orphans, faults_injected=1,
                          fsck_clean_after=True)


def _derive_fixture(store, seed: int):
    """Deterministic source stream + two-op graph (filter -> pack) under a
    chaos namespace; returns (ns, graph, source_topology)."""
    from repro_torch.data.packing import GlobalBatchPacker
    from repro_torch.graph import FilterOp, OpGraph, PackOp

    gb, sl, dp = 8, 16, 2
    ns = Namespace(store, CHAOS_PREFIX)
    packer = GlobalBatchPacker(gb, sl, dp, 1)
    p = Producer(ns.stream("raw"), "P", dp=dp, cp=1)
    p.recover()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 1 << 15, gb * sl * 6, dtype=np.int64).astype(np.int32)
    for batch in packer.add_tokens(toks):
        p.write_tgb(slice_payloads=batch.slices,
                    num_samples=batch.num_samples,
                    token_count=batch.token_count)
        p.maybe_commit(force=True)
    p.finalize()
    g = OpGraph("chaos-derive")
    g.add(FilterOp("evens", lambda rows: rows[:, 0] % 2 == 0),
          source="raw", output="rows")
    g.add(PackOp("pack", global_batch=4, seq_len=sl, dp=1, cp=1),
          source="rows", output="filtered")
    return ns, g, Topology(dp=dp, cp=1, global_batch=gb, seq_len=sl)


def _derived_objects(ns: Namespace) -> dict:
    """{relative tgb key: bytes} of the derived stream (byte-identity probe)."""
    sns = ns.stream("filtered")
    prefix = sns.key("tgb") + "/"
    return {k[len(prefix):]: bytes(sns.store.get(k))
            for k in sns.store.list(prefix)}


@scenario("derive_worker_midpublish_kill")
def derive_worker_midpublish_kill(seed: int = 0) -> ScenarioResult:
    """Kill the DeriveWorker *between* publishing a window's outputs (uploads
    + manifest commit done) and committing the derive cursor — the widest
    torn-progress window the protocol allows. The restarted worker replays
    the interrupted window from the previous cursor: every replayed output
    lands on its content address (upload skipped, counted as a store hit)
    and its manifest offset deduplicates, so the derived stream ends
    byte-identical to an uncrashed run with zero duplicates and zero
    re-derived TGBs persisted, and fsck audits clean."""
    from repro_torch.core import FaultInjector
    from repro_torch.graph import DeriveWorker

    n_src = 6
    # reference: the same derivation with no fault, in a pristine store
    ref_store = MemoryObjectStore()
    ref_ns, ref_g, topo = _derive_fixture(ref_store, seed)
    DeriveWorker(ref_ns, ref_g, topo, window_steps=2).run(
        max_source_steps=n_src, timeout_s=10)
    want = _derived_objects(ref_ns)

    store = MemoryObjectStore(faults=FaultInjector())
    ns, g, topo = _derive_fixture(store, seed)
    # 2nd derive-cursor conditional put dies before reaching the store:
    # window 2's outputs are fully published but its progress is not
    store.faults.crash_on("cput", key_substr=".dc", nth=2, phase="before")
    w = DeriveWorker(ns, g, topo, window_steps=2)
    try:
        w.run(max_source_steps=n_src, timeout_s=10)
        raise AssertionError("mid-publish crash never fired")
    except InjectedCrash:
        pass
    store.faults = None

    t0 = now()
    w2 = DeriveWorker(ns, g, topo, window_steps=2)
    stats = w2.run(max_source_steps=n_src, timeout_s=10)
    recovery_latency = now() - t0
    assert stats.resumed_src_step == 2, \
        f"restart resumed at src_step {stats.resumed_src_step}, expected 2"
    assert stats.store_hits >= 1, \
        "replayed window re-uploaded outputs instead of hitting the store"

    got = _derived_objects(ns)
    assert got == want, \
        f"derived stream diverged from the uncrashed run: " \
        f"{sorted(got)} vs {sorted(want)}"
    view = latest_view(ns.stream("filtered"))
    offs = [t.producer_seq for t in view.tgbs]
    assert offs == list(range(len(offs))), \
        f"derived offsets not contiguous/unique: {offs}"
    assert len(view.derived_tgbs()) == len(view.tgbs), \
        "derived TGB lost its provenance record"
    delivered = len(drain(reader(ns.stream("filtered"), 0, 0, 1, 1),
                          len(offs)))

    orphans, clean = audit_and_repair(ns)
    assert clean, "fsck not clean after derive-worker crash recovery"
    return ScenarioResult(name="derive_worker_midpublish_kill", passed=True,
                          steps_delivered=delivered,
                          recovery_latency_s=recovery_latency,
                          orphans_detected=orphans, faults_injected=1,
                          fsck_clean_after=True)


@scenario("brownout_throttle_storm")
def brownout_throttle_storm(seed: int = 0) -> ScenarioResult:
    """Two producers and a live consumer ride out a scripted 503 SlowDown
    storm behind the ``ResilientStore``: throttles feed the shared AIMD
    governor (collective backoff), Retry-After is honored, spilling absorbs
    retry-budget exhaustion, and the streams stay gap-free and
    duplicate-free."""
    inner = MemoryObjectStore()
    faulty = FaultyObjectStore(inner, FaultPolicy(seed=seed))
    store = ResilientStore(faulty, ResilienceConfig(
        seed=seed, base_delay_s=0.002, backoff_cap_s=0.05,
        breaker_failure_threshold=8, breaker_cooldown_s=0.05,
        governor_min_rate=20.0, governor_ai_per_s=100.0))
    ns = Namespace(store, CHAOS_PREFIX)
    n_producers, per = 2, 6
    producers = [Producer(ns, f"P{i}", dp=1, cp=1, spill_limit=per)
                 for i in range(n_producers)]
    errs: list = []

    def produce_body(p: Producer):
        try:
            p.recover()
            while p.next_offset < per:
                p.write_tgb(slice_payloads=make_slices(
                    p.producer_id, p.next_offset, p.dp, p.cp))
                p.maybe_commit(force=True)
            p.finalize()
        except Exception as e:
            errs.append((p.producer_id, e))

    got: list = []

    def consume_body():
        try:
            cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
            for _ in range(n_producers * per):
                got.append(cons.next_batch(timeout_s=30.0))
        except Exception as e:
            errs.append(("consumer", e))

    # storm covers roughly the first half of the run: 60% of ops rejected
    # with Retry-After while it lasts
    faulty.script_brownout([BrownoutPhase(0.0, 0.4, throttle_rate=0.6,
                                          retry_after_s=0.004)])
    t0 = now()
    threads = [threading.Thread(target=produce_body, args=(p,))
               for p in producers]
    threads.append(threading.Thread(target=consume_body))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    elapsed = now() - t0
    assert not errs, f"clients died in the storm: {errs}"

    throttled = faulty.fault_stats.counts.get("throttled", 0)
    assert throttled > 0, "storm never actually throttled anything"
    assert store.resilience.throttled > 0, \
        "resilience layer did not observe the throttles"
    assert store.governor.throttle_events > 0, \
        "AIMD governor never engaged during the storm"

    # per-producer stream integrity + exactly-once delivery
    clean_ns = Namespace(inner, CHAOS_PREFIX)
    view = latest_view(clean_ns)
    for i in range(n_producers):
        seqs = [t.producer_seq for t in view.tgbs
                if t.producer_id == f"P{i}"]
        assert seqs == list(range(per)), \
            f"P{i} stream corrupted by the storm: {seqs}"
    per_pid: dict = {}
    for payload in got:
        pid, off = bytes(payload).split(b"|", 1)[0].decode().split(":")[:2]
        per_pid.setdefault(pid, []).append(int(off))
    for i in range(n_producers):
        offs = per_pid.get(f"P{i}", [])
        assert offs == list(range(per)), f"P{i} delivered {offs}"
    report = fsck(clean_ns)
    assert report.clean, report.summary()
    spilled = sum(p.stats.tgbs_spilled for p in producers)
    replayed = sum(p.stats.spill_replayed for p in producers)
    assert spilled == replayed, \
        f"spill not fully replayed: {spilled} spilled, {replayed} replayed"
    return ScenarioResult(
        name="brownout_throttle_storm", passed=True,
        steps_delivered=n_producers * per, recovery_latency_s=elapsed,
        faults_injected=faulty.fault_stats.total, fsck_clean_after=True,
        detail=f"{throttled} throttles, {store.resilience.retries} retries, "
               f"{spilled} spilled")


@scenario("store_outage_resume")
def store_outage_resume(seed: int = 0) -> ScenarioResult:
    """The store disappears entirely mid-run. The shared circuit breaker
    flips both clients into degraded mode: the consumer keeps serving
    already-prefetched TGBs (zero store round trips), the producer spills
    built TGBs into its bounded queue; on recovery the spill replays in
    producer_seq order, commits dedup exactly-once, and fsck is clean."""
    inner = MemoryObjectStore()
    faulty = FaultyObjectStore(inner, FaultPolicy(seed=seed))
    store = ResilientStore(faulty, ResilienceConfig(
        seed=seed, read_attempts=2, write_attempts=2, base_delay_s=0.002,
        backoff_cap_s=0.02, breaker_failure_threshold=3,
        breaker_cooldown_s=0.05))
    ns = Namespace(store, CHAOS_PREFIX)
    pre, during, total = 3, 4, 7

    p = Producer(ns, "P", dp=1, cp=1, spill_limit=during)
    p.recover()
    for _ in range(pre):
        p.write_tgb(slice_payloads=make_slices("P", p.next_offset, 1, 1))
        p.maybe_commit(force=True)

    cons = Consumer(ns, MeshPosition(0, 0, 1, 1), prefetch_depth=4)
    cons.poll()
    cons.start_prefetch()
    deadline = now() + 10.0
    while now() < deadline:
        with cons._prefetch_lock:
            if len(cons._prefetched) >= pre:
                break
        inner.clock.sleep(0.002)
    with cons._prefetch_lock:
        warm = len(cons._prefetched)
    assert warm >= pre, f"prefetch only warmed {warm}/{pre} steps"

    # lights out: every op fails until the script is cleared
    faulty.script_brownout([BrownoutPhase(0.0, 3600.0, outage=True)])
    t0 = now()
    for _ in range(during):
        p.write_tgb(slice_payloads=make_slices("P", p.next_offset, 1, 1))
        p.maybe_commit()
    assert p.spilled == during, \
        f"expected {during} spilled TGBs, got {p.spilled}"
    assert p.stats.store_degraded == 1.0
    got = drain(cons, pre, timeout_s=30.0)  # served from prefetch, store down
    assert store.degraded, "breaker never opened during the outage"
    assert cons.stats.degraded_batches > 0, \
        "degraded-mode service not surfaced in consumer obs"
    assert cons.stats.store_degraded == 1.0

    # recovery: clear the script, replay the spill, drain the rest
    faulty.clear_brownout()
    p.finalize()
    recovery_latency = now() - t0
    assert p.spilled == 0 and p.stats.spill_replayed == during, \
        f"spill replay incomplete: {p.spilled} left, " \
        f"{p.stats.spill_replayed} replayed"
    got += drain(cons, total - pre, timeout_s=30.0)
    cons.stop_prefetch()
    assert_exactly_once(got, "P", 0, 0, total)

    clean_ns = Namespace(inner, CHAOS_PREFIX)
    view = latest_view(clean_ns)
    seqs = [t.producer_seq for t in view.tgbs]
    assert seqs == list(range(total)), \
        f"replayed stream not in producer_seq order: {seqs}"
    report = fsck(clean_ns)
    assert report.clean, report.summary()
    outages = faulty.fault_stats.counts.get("outage", 0)
    return ScenarioResult(
        name="store_outage_resume", passed=True, steps_delivered=total,
        recovery_latency_s=recovery_latency, faults_injected=outages,
        fsck_clean_after=True,
        detail=f"{during} spilled+replayed, "
               f"{cons.stats.degraded_batches} degraded batches, "
               f"breaker opened {store.breaker.opens}x")


@scenario("shard_conflict_storm")
def shard_conflict_storm(seed: int = 0) -> ScenarioResult:
    """Six producers force-committing onto a 4-shard manifest plane while the
    store injects conditional-put 5xx (60% lost acks). The per-shard rebase
    machinery, the DAC shard chooser, and the cross-shard dedup must keep the
    merged global step sequence gap-free and duplicate-free."""
    from repro_torch.core import write_shard_config

    inner = MemoryObjectStore()
    store = FaultyObjectStore(inner, FaultPolicy(
        seed=seed, cput_error_rate=0.3, cput_lost_ack_rate=0.6,
        key_filter=".manifest", max_faults=32))
    ns = Namespace(store, CHAOS_PREFIX)
    write_shard_config(ns, 4)  # claim the layout before any client starts
    n_producers, per = 6, 5
    producers = [Producer(ns, f"P{i}", dp=1, cp=1) for i in range(n_producers)]
    errs = []

    def body(p: Producer):
        try:
            produce_range(p, per)
        except Exception as e:  # surfaced after join
            errs.append((p.producer_id, e))

    t0 = now()
    threads = [threading.Thread(target=body, args=(p,)) for p in producers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    recovery_latency = now() - t0
    assert not errs, f"producers died in the storm: {errs}"

    clean_ns = Namespace(inner, CHAOS_PREFIX)
    view = latest_view(clean_ns)
    for i in range(n_producers):
        seqs = [t.producer_seq for t in view.tgbs
                if t.producer_id == f"P{i}"]
        assert seqs == list(range(per)), \
            f"P{i} stream corrupted under the storm: {seqs}"
    ids = [t.tgb_id for t in view.tgbs]
    assert len(set(ids)) == len(ids), "duplicate TGB in the merged sequence"
    # drain everything through the merged view; per-producer payload order
    # must be exact (the merged order interleaves producers, the per-producer
    # subsequences may not)
    cons = Consumer(clean_ns, MeshPosition(0, 0, 1, 1))
    per_pid: dict = {}
    for _ in range(n_producers * per):
        payload = cons.next_batch(timeout_s=10.0)
        pid, off = bytes(payload).split(b"|", 1)[0].decode().split(":")[:2]
        per_pid.setdefault(pid, []).append((int(off), payload))
    for i in range(n_producers):
        pid = f"P{i}"
        offs = [o for o, _ in per_pid[pid]]
        assert offs == list(range(per)), f"{pid} delivered {offs}"
        for off, payload in per_pid[pid]:
            assert payload == deterministic_payload(pid, off), \
                f"{pid}@{off} payload corrupted"
    report = fsck(clean_ns)
    assert report.clean, report.summary()
    conflicts = sum(p.stats.commit_conflicts for p in producers)
    switches = sum(int(p.protocol.stats.switches) for p in producers)
    return ScenarioResult(name="shard_conflict_storm", passed=True,
                          steps_delivered=n_producers * per,
                          recovery_latency_s=recovery_latency,
                          faults_injected=store.fault_stats.total,
                          fsck_clean_after=True,
                          detail=f"{conflicts} conflicts rebased, "
                                 f"{switches} shard switches")


@scenario("compactor_midfold_kill")
def compactor_midfold_kill(seed: int = 0) -> ScenarioResult:
    """Kill the compactor between writing a segment and issuing the shard
    trim commits (the mid-fold crash window). Readers must deduplicate the
    folded-but-untrimmed prefix (no duplicate steps, no gaps), fsck must
    report the lagging trims as a repairable warning — not an error — and a
    restarted compactor must repair idempotently to a clean state."""
    from repro_torch.core import (Compactor, open_manifest_store,
                                  write_shard_config)

    ns = fresh_ns()
    write_shard_config(ns, 4)
    n_producers, per = 3, 8
    producers = [Producer(ns, f"P{i}", dp=1, cp=1) for i in range(n_producers)]
    for p in producers:
        produce_range(p, per)
    total = n_producers * per

    manifests = open_manifest_store(ns)
    comp = Compactor(ns, manifests, min_fold=1)
    first = comp.run_cycle(safe_step=total // 2)
    assert first["segment"] == 0 and first["folded"] > 0, first

    # arm the kill: the next conditional put on any shard chain (= the first
    # trim commit of the next cycle) crashes; the segment (under manifest/
    # compact/) is already durable at that point
    ns.store.faults.crash_on("cput", "shard-", nth=1, phase="before")
    t0 = now()
    crashed = False
    try:
        comp.run_cycle(safe_step=total)
    except InjectedCrash:
        crashed = True
    assert crashed, "trim crash rule never fired"
    ns.store.faults = None

    # crash window: folds are ahead of every shard base. A cold reader must
    # still see each step exactly once, and fsck must call it repairable.
    cold = open_manifest_store(ns)
    mv = cold.load_view(cold.latest_version())
    ids = [t.tgb_id for t in mv.tgbs]
    assert mv.total_steps == total, (mv.total_steps, total)
    assert len(set(ids)) == len(ids), "crash window duplicated steps"
    report = fsck(ns)
    kinds = {i.kind for i in report.issues}
    assert "compaction-lagging-trim" in kinds, sorted(kinds)
    assert not any(i.severity == "error" for i in report.issues), \
        report.summary()

    # operator restart: a fresh compactor's repair pass re-issues the trims
    comp2 = Compactor(ns, open_manifest_store(ns), min_fold=1)
    s = comp2.run_cycle(safe_step=total)
    recovery_latency = now() - t0
    assert s["repaired"] > 0, s
    report2 = fsck(ns)
    assert report2.clean, report2.summary()
    assert "compaction-lagging-trim" not in {i.kind for i in report2.issues}

    # full drain after repair: the global sequence is intact end to end
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    per_pid: dict = {}
    for _ in range(total):
        payload = cons.next_batch(timeout_s=10.0)
        pid, off = bytes(payload).split(b"|", 1)[0].decode().split(":")[:2]
        per_pid.setdefault(pid, []).append(int(off))
    for i in range(n_producers):
        assert per_pid[f"P{i}"] == list(range(per)), per_pid
    return ScenarioResult(name="compactor_midfold_kill", passed=True,
                          steps_delivered=total,
                          recovery_latency_s=recovery_latency,
                          fsck_clean_after=True,
                          detail=f"fold crashed after segment "
                                 f"{first['segment'] + 1} write, "
                                 f"{s['repaired']} shards repaired")
