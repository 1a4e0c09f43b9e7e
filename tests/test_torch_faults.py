"""The port's fault machinery on the CPU: twins of ``tests/test_faults.py``
(``FaultyObjectStore`` and the clients' resilience to it),
``tests/test_exactly_once.py`` (crash replay at any storage operation),
``tests/test_reclaimer_edges.py`` and the tracer tests of
``tests/test_obs.py:176-230`` (the span tracer ``python -m repro_torch.chaos
--trace`` writes), run against ``repro_torch``.

Last, the breaker fault the chaos harness's ``store_outage_resume`` found
(ROADMAP Queue 3): a half-open probe answered by a miss. The port's breaker
closes on it; the reference's stays half-open, and the case holds both.
"""
import json
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import (Consumer, FaultInjector,  # noqa: E402
                              FaultPolicy, FaultyObjectStore, InjectedCrash,
                              ManifestStore, MemoryObjectStore, MeshPosition,
                              Namespace, NoSuchKey, Producer, Reclaimer,
                              TransientStoreError, Watermark,
                              write_watermark)
from repro_torch.obs.tracer import (TRACER, disable_tracing,  # noqa: E402
                                    enable_tracing, trace_span)
from repro_torch.ops import fsck  # noqa: E402


@pytest.fixture
def ns():
    """The port's namespace (shadows the reference's in conftest)."""
    return Namespace(MemoryObjectStore(), "runs/test")


# ---------------------------------------------------------------------------
# twins of tests/test_faults.py
# ---------------------------------------------------------------------------

def faulty(policy, inner=None):
    inner = inner or MemoryObjectStore()
    return FaultyObjectStore(inner, policy), inner


# ---------------------------------------------------------------------------
# wrapper semantics
# ---------------------------------------------------------------------------

def test_same_seed_replays_identical_faults():
    def run(seed):
        store, _ = faulty(FaultPolicy(seed=seed, get_error_rate=0.3,
                                      put_error_rate=0.3))
        for i in range(40):
            try:
                store.put(f"k{i}", b"x" * 8)
            except TransientStoreError:
                pass
            try:
                store.get(f"k{i}")
            except (TransientStoreError, KeyError):
                pass
        return dict(store.fault_stats.counts)

    assert run(7) == run(7)
    assert run(7) != run(8)  # astronomically unlikely to collide


def test_lost_ack_cput_applies_then_raises():
    store, inner = faulty(FaultPolicy(cput_error_rate=1.0,
                                      cput_lost_ack_rate=1.0, max_faults=1))
    with pytest.raises(TransientStoreError):
        store.put_if_absent("m/1", b"payload")
    # the write landed server-side before the "failure"
    assert inner.get("m/1") == b"payload"
    # budget exhausted: the retry observes the ordinary conflict
    assert store.put_if_absent("m/1", b"other") is False


def test_timeout_cput_never_applies():
    store, inner = faulty(FaultPolicy(cput_error_rate=1.0,
                                      cput_lost_ack_rate=0.0, max_faults=1))
    with pytest.raises(TransientStoreError):
        store.put_if_absent("m/1", b"payload")
    assert not inner.exists("m/1")
    assert store.put_if_absent("m/1", b"payload") is True


def test_short_read_truncates_range_get():
    store, _ = faulty(FaultPolicy(short_read_rate=1.0, max_faults=1))
    store.put("k", b"A" * 100)
    assert len(store.get_range("k", 0, 100)) == 50  # injected
    assert len(store.get_range("k", 0, 100)) == 100  # budget spent


def test_stale_read_window_hides_recent_keys():
    store, _ = faulty(FaultPolicy(stale_read_rate=1.0, stale_depth=2,
                                  max_faults=3))
    store.put("old", b"x")
    store.put("new1", b"y")
    store.put("new2", b"z")
    with pytest.raises(NoSuchKey):
        store.get("new2")                # fault 1
    listing = store.list("")             # faults 2+3: both recent keys hidden
    assert "old" in listing
    assert "new1" not in listing and "new2" not in listing
    assert store.get("new2") == b"z"     # budget exhausted: visible again


def test_key_filter_limits_blast_radius():
    store, _ = faulty(FaultPolicy(get_error_rate=1.0, key_filter="/manifest/"))
    store.put("runs/x/tgb/a", b"1")
    store.put("runs/x/manifest/00000001.manifest", b"2")
    assert store.get("runs/x/tgb/a") == b"1"  # not eligible
    with pytest.raises(TransientStoreError):
        store.get("runs/x/manifest/00000001.manifest")


def test_max_faults_budget_is_global():
    store, _ = faulty(FaultPolicy(get_error_rate=1.0, max_faults=3))
    store.put("k", b"x")
    fired = 0
    for _ in range(10):
        try:
            store.get("k")
        except TransientStoreError:
            fired += 1
    assert fired == 3


# ---------------------------------------------------------------------------
# client resilience
# ---------------------------------------------------------------------------

def test_commit_protocol_resolves_lost_ack_as_win():
    store, _ = faulty(FaultPolicy(cput_error_rate=1.0, cput_lost_ack_rate=1.0,
                                  key_filter=".manifest", max_faults=1))
    ns = Namespace(store, "runs/t")
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    p.write_tgb(uniform_slice_bytes=32)
    assert p.maybe_commit(force=True) is True  # ambiguity resolved by re-read
    assert p.stats.commit_successes == 1
    assert p.stats.commit_conflicts == 0
    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    assert [t.producer_seq for t in view.tgbs] == [0]


def test_commit_protocol_treats_unapplied_timeout_as_conflict():
    store, _ = faulty(FaultPolicy(cput_error_rate=1.0, cput_lost_ack_rate=0.0,
                                  key_filter=".manifest", max_faults=1))
    ns = Namespace(store, "runs/t")
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    p.write_tgb(uniform_slice_bytes=32)
    assert p.maybe_commit(force=True) is False  # nothing landed
    assert len(p.pending) == 1                  # TGB still queued
    assert p.maybe_commit(force=True) is True   # clean retry commits it
    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    assert [t.producer_seq for t in view.tgbs] == [0]


def test_producer_retries_transient_tgb_upload():
    store, _ = faulty(FaultPolicy(put_error_rate=1.0, key_filter="/tgb/",
                                  max_faults=2))
    ns = Namespace(store, "runs/t")
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    desc = p.write_tgb(uniform_slice_bytes=32)  # retried past 2 faults
    assert store.exists(desc.object_key)


def test_consumer_retries_flaky_and_short_reads():
    inner = MemoryObjectStore()
    ns_clean = Namespace(inner, "runs/t")
    p = Producer(ns_clean, "P", dp=1, cp=1, manifests=ManifestStore(ns_clean))
    for _ in range(4):
        p.write_tgb(uniform_slice_bytes=128)
        p.maybe_commit(force=True)
    p.finalize()
    store = FaultyObjectStore(inner, FaultPolicy(
        get_error_rate=0.5, short_read_rate=0.5, key_filter="/tgb/",
        max_faults=6, seed=1))
    cons = Consumer(Namespace(store, "runs/t"), MeshPosition(0, 0, 1, 1))
    batches = [cons.next_batch(timeout_s=5) for _ in range(4)]
    assert all(len(b) == 128 for b in batches)
    assert cons.stats.read_retries >= 1


def test_consumer_gives_up_after_bounded_retries():
    store, _ = faulty(FaultPolicy(get_error_rate=1.0, key_filter="/tgb/"))
    ns = Namespace(store, "runs/t")
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    p.write_tgb(uniform_slice_bytes=32)
    p.maybe_commit(force=True)
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1), read_retries=2)
    with pytest.raises(TransientStoreError):
        cons.next_batch(timeout_s=5)
    assert cons.stats.read_retries == 2


# ---------------------------------------------------------------------------
# twins of tests/test_exactly_once.py
# ---------------------------------------------------------------------------

def _produce_until_crash(ns, n_target, crash_op, crash_sub, crash_nth):
    faults = ns.store.faults
    faults.crash_on(crash_op, key_substr=crash_sub, nth=crash_nth)
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    p.recover()
    made = 0
    try:
        while p.next_offset < n_target:
            p.write_tgb(uniform_slice_bytes=64)
            p.maybe_commit(force=True)
        p.finalize()
    except InjectedCrash:
        return False
    return True


@pytest.mark.parametrize("crash_op,crash_sub,crash_nth", [
    ("put", "/tgb/", 3),        # mid TGB materialization
    ("cput", ".manifest", 2),   # during the conditional manifest write
    ("cput", ".manifest", 5),
    ("put", "/tgb/", 7),
    ("get", ".manifest", 2),    # during rebase/catch-up reads
])
def test_crash_replay_no_dups_no_gaps(crash_op, crash_sub, crash_nth):
    store = MemoryObjectStore(faults=FaultInjector())
    ns = Namespace(store, "runs/eo")
    n_target = 10
    finished = _produce_until_crash(ns, n_target, crash_op, crash_sub,
                                    crash_nth)
    # replacement process (same producer_id) resumes from durable state
    if not finished:
        store.faults = None  # the injected fault fired already
        p2 = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
        resume = p2.recover()
        while p2.next_offset < n_target:
            p2.write_tgb(uniform_slice_bytes=64)
            p2.maybe_commit(force=True)
        p2.finalize()
        assert resume >= 0

    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    seqs = [t.producer_seq for t in view.tgbs if t.producer_id == "P"]
    assert seqs == list(range(n_target)), f"stream corrupted: {seqs}"
    # every committed TGB object is readable
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    for _ in range(n_target):
        assert cons.next_batch(1.0)


def test_consumer_rollback_no_skip_no_double(ns):
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    for _ in range(8):
        p.write_tgb(uniform_slice_bytes=64)
        p.maybe_commit(force=True)
    p.finalize()
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    first = [cons.next_batch(1.0) for _ in range(8)]
    v, _s = cons.cursor
    # rollback to step 3 (as a checkpoint restore would)
    cons.restore_cursor(v, 3)
    replay = [cons.next_batch(1.0) for _ in range(5)]
    assert replay == first[3:]


def test_two_incarnations_cannot_both_win(ns):
    """The conditional write prevents two processes sharing a producer_id from
    both advancing state for the same offsets."""
    a = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    b = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    a.write_tgb(uniform_slice_bytes=16)
    b.write_tgb(uniform_slice_bytes=16)  # same offset 0, different object
    assert a.maybe_commit(force=True)
    ok_b = b.maybe_commit(force=True)   # conflicts, rebases, dedups
    if not ok_b:
        b.finalize()
    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    seqs = [t.producer_seq for t in view.tgbs if t.producer_id == "P"]
    assert seqs == [0]


# ---------------------------------------------------------------------------
# twins of tests/test_reclaimer_edges.py
# ---------------------------------------------------------------------------

def _publish(ns, n, manifests=None):
    p = Producer(ns, "P", dp=1, cp=1, manifests=manifests or ManifestStore(ns))
    for _ in range(n):
        p.write_tgb(uniform_slice_bytes=64)
        p.maybe_commit(force=True)
    p.finalize()
    return p


def test_missing_rank_watermark_stalls_trim(ns):
    """One rank never checkpointing must pin the whole namespace: no trim
    marker movement, no deletion, until every expected rank reports."""
    _publish(ns, 8)
    write_watermark(ns, 0, Watermark(version=7, step=6))
    before = ns.store.total_bytes()
    r = Reclaimer(ns, expected_ranks=2)  # rank 1 is missing
    for _ in range(3):
        assert r.run_cycle() is None
    assert r.read_trim() == (0, -1)          # marker never written
    assert r.stats.tgbs_deleted == 0
    assert r.stats.manifests_deleted == 0
    assert ns.store.total_bytes() >= before
    # the moment the straggler reports, trim resumes
    write_watermark(ns, 1, Watermark(version=7, step=4))
    wg = r.run_cycle()
    assert wg == Watermark(version=7, step=4)
    assert r.stats.tgbs_deleted == 4


def test_trim_never_passes_snapshot_needed_by_restore(ns):
    """Delta format: a restoring checkpoint at version V needs the chain back
    to the newest snapshot <= V, so the reclaimer must retain from that
    snapshot even when the watermark version is higher."""
    manifests = ManifestStore(ns, fmt="delta", snapshot_every=4)
    _publish(ns, 10, manifests=manifests)  # versions 0..9, snapshots v4, v8
    wm = Watermark(version=9, step=6)
    write_watermark(ns, 0, wm)
    r = Reclaimer(ns, expected_ranks=1, manifests=manifests)
    r.run_cycle()
    retained = sorted(int(k.rsplit("/", 1)[-1].split(".")[0])
                      for k in ns.store.list(ns.key("manifest")))
    # nothing at or above the newest snapshot <= safe_version may be deleted
    assert retained[0] == 8, f"retained {retained}"
    # every version a checkpoint can restore still reconstructs
    fresh = ManifestStore(ns, fmt="delta", snapshot_every=4)
    view = fresh.load_view(wm.version)
    assert view.total_steps == 10
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1), manifests=fresh)
    cons.restore_cursor(wm.version, wm.step)
    for _ in range(4):  # steps 6..9 survive the trim
        cons.next_batch(1.0)
    assert fsck(ns).clean


def test_run_cycle_under_concurrent_producer_commit(ns):
    """The reclaimer races a live producer: cycles interleave with commits
    and watermark advances. Nothing may crash, nothing a checkpoint needs
    may disappear, and the final namespace must audit clean."""
    p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
    r = Reclaimer(ns, expected_ranks=1)
    stop = threading.Event()
    errs = []

    def reclaim_loop():
        while not stop.is_set():
            try:
                r.run_cycle()
            except Exception as e:
                errs.append(e)
                return

    t = threading.Thread(target=reclaim_loop)
    t.start()
    try:
        for i in range(30):
            p.write_tgb(uniform_slice_bytes=64)
            p.maybe_commit(force=True)
            if i and i % 5 == 0:
                v = ManifestStore(ns).latest_version()
                write_watermark(ns, 0, Watermark(version=v, step=i - 3))
        p.finalize()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errs, f"reclaimer crashed during concurrent commits: {errs}"
    r.run_cycle()  # settle
    assert r.stats.cycles >= 2
    safe_step, _v = r.read_trim()
    assert safe_step == 22  # last advertised watermark step (i=25, step=22)
    # everything from the last checkpoint onward is intact and readable
    v = ManifestStore(ns).latest_version()
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    cons.restore_cursor(v, safe_step)
    for _ in range(30 - safe_step):
        cons.next_batch(1.0)
    assert fsck(ns).clean


# ---------------------------------------------------------------------------
# twins of the tracer tests, tests/test_obs.py:176-230
# ---------------------------------------------------------------------------

def test_tracer_disabled_is_shared_noop():
    disable_tracing()
    TRACER.clear()
    assert trace_span("a", cat="x") is trace_span("b", cat="y")
    with trace_span("consumer.fetch", cat="read"):
        pass
    assert len(TRACER) == 0


def test_tracer_nesting_and_chrome_roundtrip(tmp_path):
    enable_tracing()
    TRACER.clear()
    try:
        with trace_span("outer", cat="read", step=3):
            with trace_span("inner", cat="read"):
                pass
        with trace_span("train.step", cat="compute"):
            pass
    finally:
        disable_tracing()
    spans = TRACER.spans()
    assert [s.name for s in spans] == ["inner", "outer", "train.step"]
    inner, outer = spans[0], spans[1]
    assert inner.t0 >= outer.t0
    assert inner.t0 + inner.dur <= outer.t0 + outer.dur + 1e-6
    assert outer.args == {"step": 3}

    path = str(tmp_path / "trace.json")
    assert TRACER.write_chrome_trace(path) == 3
    doc = json.loads(open(path).read())
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"X"}
    by_name = {e["name"]: e for e in evs}
    assert by_name["outer"]["args"] == {"step": 3}
    assert by_name["outer"]["dur"] >= by_name["inner"]["dur"]

    report = TRACER.stall_report()
    assert "outer" in report and "data-plane" in report
    TRACER.clear()


def test_tracer_records_spans_that_raise():
    enable_tracing()
    TRACER.clear()
    try:
        with pytest.raises(RuntimeError):
            with trace_span("commit.cput", cat="commit"):
                raise RuntimeError("5xx")
    finally:
        disable_tracing()
    assert [s.name for s in TRACER.spans()] == ["commit.cput"]
    TRACER.clear()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the breaker's half-open probe (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["repro_torch", "repro"])
def test_a_half_open_probe_that_misses_closes_the_breaker(pkg):
    """An outage opens the breaker; once it has passed and the cooldown is
    over, the first call is the half-open probe. When that probe is a GET
    of a key that does not exist (a reader polling for the next manifest),
    the store has answered: the port's breaker closes and the next PUT
    goes through. The reference records nothing for a miss, so its probe
    never ends and every later call fails fast, however long one waits:
    the fault behind ``store_outage_resume``'s rare failures in both
    packages (its producer's spill replay meets only ``CircuitOpenError``)."""
    import importlib
    if pkg == "repro":
        pytest.importorskip("msgpack")
    core = importlib.import_module(pkg + ".core")
    clock = core.VirtualClock()
    faulty = core.FaultyObjectStore(core.MemoryObjectStore(clock=clock),
                                    core.FaultPolicy())
    rs = core.ResilientStore(faulty, core.ResilienceConfig(
        seed=0, hedge=None, read_attempts=1, write_attempts=1,
        breaker_failure_threshold=1, breaker_cooldown_s=0.05))
    faulty.script_brownout([core.BrownoutPhase(0.0, 3600.0, outage=True)])
    with pytest.raises(core.TransientStoreError):
        rs.put("k", b"x")
    assert rs.degraded
    faulty.clear_brownout()
    clock.sleep(0.1)
    with pytest.raises(KeyError):
        rs.get("missing")                       # the probe, answered
    if pkg == "repro_torch":
        assert not rs.degraded
        rs.put("k", b"x")
        assert rs.get("k") == b"x"
    else:
        for _ in range(3):
            clock.sleep(60.0)
            with pytest.raises(core.CircuitOpenError):
                rs.put("k", b"x")
        assert rs.degraded
