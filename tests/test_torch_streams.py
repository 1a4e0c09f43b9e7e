"""The port's multi-stream data plane (``repro_torch.streams``) on the CPU.

Twins of every test of ``tests/test_streams.py`` (the MixPlan schedule,
mixed reading and composite checkpoints, exactly-once across a producer
and a reader restart, mix-aware per-stream trimming, the bounded latency
stats) and of the mixed-stream cases of ``tests/test_elastic.py`` (factor
DP resizes of a MixedReader). Then across packages: the schedule is the
same function of (weights, seed, step) in both; a mix written by either
package's producers reads back in the other's ``MixedReader`` as the same
(stream, step, payload) sequence; composite Checkpoint tokens are
byte-identical and restore in the other package.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import (FaultInjector, InjectedCrash,  # noqa: E402
                              LatencyWindow, MemoryObjectStore, Namespace)
from repro_torch.dataplane import (Checkpoint, Topology,  # noqa: E402
                                   UnsupportedOperation, open_dataplane)
from repro_torch.streams import (MixPlan, MixedReader,  # noqa: E402
                                 MultiStreamSession)

TOPO = Topology(dp=2, cp=1, global_batch=4, seq_len=8)
WEIGHTS = {"web": 0.6, "code": 0.3, "math-sft": 0.1}


def _fill_stream(session, stream, n_batches, seed, writer_id="w0"):
    """Publish n_batches with a payload pattern unique to (stream, seed)."""
    rng = np.random.default_rng(seed)
    with session.writer(writer_id, stream=stream) as w:
        for _ in range(n_batches):
            w.write_tokens(rng.integers(0, 30_000,
                                        TOPO.global_batch * TOPO.seq_len))
            w.flush()


def _open(store, streams=WEIGHTS, seed=7, **kw):
    return open_dataplane(store, TOPO, backend="tgb", streams=streams,
                          mix_seed=seed, namespace="runs/mix", **kw)


# ---------------------------------------------------------------------------
# MixPlan: deterministic, weight-faithful, dense per-stream substeps
# ---------------------------------------------------------------------------

def test_mixplan_pure_function_of_weights_seed_step():
    a = MixPlan(WEIGHTS, seed=13)
    b = MixPlan(dict(reversed(list(WEIGHTS.items()))), seed=13)  # order-free
    assert a.schedule(500) == b.schedule(500)
    # positions are recomputable out of order (restore path: no stored state)
    fresh = MixPlan(WEIGHTS, seed=13)
    assert fresh.position(321) == a.schedule(500)[321]
    assert MixPlan(WEIGHTS, seed=14).schedule(500) != a.schedule(500)


def test_mixplan_counts_track_weights_with_bounded_deviation():
    plan = MixPlan(WEIGHTS, seed=3)
    n = 1000
    counts = plan.stream_counts(n)
    assert sum(counts.values()) == n
    for name, w in plan.weights.items():
        assert abs(counts[name] - n * w) <= len(WEIGHTS), (name, counts)
    # per-stream substeps are dense and ordered: k-th visit gets stream_step k
    seen = {name: 0 for name in plan.names}
    for name, sstep in plan.schedule(n):
        assert sstep == seen[name]
        seen[name] += 1


def test_mixplan_rejects_bad_config():
    with pytest.raises(ValueError):
        MixPlan({})
    with pytest.raises(ValueError):
        MixPlan({"a": 0.0})
    with pytest.raises(ValueError):
        MixPlan({"": 1.0})
    with pytest.raises(ValueError):
        Namespace(MemoryObjectStore(), "runs/x").stream("a/b")


# ---------------------------------------------------------------------------
# Mixed reading: schedule-faithful routing, composite checkpoints
# ---------------------------------------------------------------------------

def test_mixed_reader_follows_schedule_and_payloads():
    store = MemoryObjectStore()
    session = _open(store)
    for i, name in enumerate(session.stream_names):
        _fill_stream(session, name, 12, seed=100 + i)
    # reference: read each stream directly through a single-stream session
    # under its per-stream namespace — mixing must only route, never alter
    direct = {}
    for name in session.stream_names:
        s1 = open_dataplane(store, TOPO, backend="tgb",
                            namespace=f"runs/mix/streams/{name}")
        r1 = s1.reader(dp_rank=1, cp_rank=0)
        direct[name] = [r1.next_batch(timeout_s=5).payload for _ in range(12)]
    r = session.reader(dp_rank=1, cp_rank=0)
    for g in range(20):
        want_name, want_sstep = session.plan.position(g)
        b = r.next_batch(timeout_s=5)
        assert (b.step, b.stream) == (g, want_name)
        assert b.payload == direct[want_name][want_sstep]
        assert b.tokens.shape == (TOPO.samples_per_slice, TOPO.seq_per_rank)


def test_composite_checkpoint_token_roundtrip():
    ck = Checkpoint("tgb", version=-1, step=17,
                    streams=(("code", 3, 5), ("web", 8, 12)))
    assert ck.composite
    assert Checkpoint.decode(ck.encode()) == ck
    assert ck.stream_cursor("web") == (8, 12)
    with pytest.raises(KeyError):
        ck.stream_cursor("nope")
    # plain tokens still decode with streams=None
    plain = Checkpoint("tgb", version=4, step=9)
    assert not Checkpoint.decode(plain.encode()).composite


def test_single_and_multi_stream_checkpoints_do_not_cross():
    store = MemoryObjectStore()
    session = _open(store)
    for name in session.stream_names:
        _fill_stream(session, name, 3, seed=1)
    r = session.reader()
    r.next_batch(timeout_s=5)
    composite = r.checkpoint()
    single = open_dataplane(store, TOPO, backend="tgb", namespace="runs/s1")
    with pytest.raises(ValueError, match="composite"):
        single.reader().restore(composite)
    with pytest.raises(ValueError, match="composite"):
        single.save_watermark(0, composite)  # would corrupt W_global
    with pytest.raises(ValueError, match="single-stream"):
        r.restore(Checkpoint("tgb", version=0, step=1))
    with pytest.raises(ValueError, match="composite"):
        _open(store, resume=Checkpoint("tgb", version=0, step=1))


def test_restore_rejects_checkpoint_from_different_mix_config():
    store = MemoryObjectStore()
    session = _open(store, seed=7)
    for name in session.stream_names:
        _fill_stream(session, name, 8, seed=2)
    r = session.reader()
    for _ in range(10):
        r.next_batch(timeout_s=5)
    ck = r.checkpoint()
    # inverted weights -> scheduled counts at step 10 cannot match the cursors
    other = _open(store, streams={"web": 0.1, "code": 0.3, "math-sft": 0.6},
                  seed=7)
    with pytest.raises(ValueError, match="MixPlan"):
        other.reader(resume=ck)


def test_streams_require_tgb_backend():
    with pytest.raises(UnsupportedOperation):
        open_dataplane(None, TOPO, backend="mq", streams=WEIGHTS)
    # single-stream call sites are untouched by the new parameters
    s = open_dataplane(MemoryObjectStore(), TOPO, backend="tgb")
    assert not isinstance(s, MultiStreamSession)
    with pytest.raises(ValueError, match="stream="):
        _open(MemoryObjectStore()).writer("w0")
    with pytest.raises(ValueError, match="stream="):
        _open(MemoryObjectStore()).writer("w0", stream="nope")


# ---------------------------------------------------------------------------
# Exactly-once across streams: kill-and-restore producer AND mixed reader
# ---------------------------------------------------------------------------

def test_exactly_once_across_streams_with_producer_and_reader_restarts():
    """Acceptance: kill one producer mid-commit and the mixed reader mid-run;
    after both restore, the replayed global step sequence equals the full
    deterministic step->(stream, stream_step) schedule with zero duplicated
    and zero skipped steps."""
    store = MemoryObjectStore(faults=FaultInjector())
    session = _open(store)
    total = 20
    # publish exactly what the schedule needs for `total` global steps: the
    # mix frontier then lands on `total` precisely
    need = session.plan.stream_counts(total)
    streams = list(session.stream_names)

    # fill all but the heaviest stream cleanly; crash that one's producer
    crash_stream = max(streams, key=lambda n: need[n])
    for i, name in enumerate(streams):
        if name != crash_stream:
            _fill_stream(session, name, need[name], seed=200 + i)
    n_crash = need[crash_stream]
    crash_tokens = np.random.default_rng(299).integers(
        0, 30_000, n_crash * TOPO.global_batch * TOPO.seq_len)
    store.faults.crash_on("cput", key_substr=f"streams/{crash_stream}/",
                          nth=3)
    with pytest.raises(InjectedCrash):
        with session.writer("wX", stream=crash_stream) as w:
            for chunk in np.split(crash_tokens, n_crash):
                w.write_tokens(chunk)
                w.flush()
    store.faults = None
    # replacement producer with the same id replays from 0: the manifest
    # dedups already-committed offsets (exactly-once on the producer side)
    with session.writer("wX", stream=crash_stream) as w2:
        assert w2.recovered_offset >= 1
        w2.seek(0)
        w2.write_tokens(crash_tokens)
    view = session.manifest_view(crash_stream)
    assert [t.producer_seq for t in view.tgbs] == list(range(n_crash))

    assert session.published_steps() == total

    # reference pass: one uninterrupted reader over the full schedule
    ref_reader = session.reader(dp_rank=0, cp_rank=0)
    ref = [(b.step, b.stream, b.payload)
           for b in (ref_reader.next_batch(5) for _ in range(total))]

    # kill-and-restore pass: consume 7, checkpoint, new session + new reader
    r = session.reader(dp_rank=0, cp_rank=0)
    got = [(b.step, b.stream, b.payload)
           for b in (r.next_batch(5) for _ in range(7))]
    token = r.checkpoint().encode()   # travels through a model checkpoint
    r.close()
    del session, r

    resumed = _open(store, resume=token)
    r2 = resumed.reader(dp_rank=0, cp_rank=0)
    got += [(b.step, b.stream, b.payload)
            for b in (r2.next_batch(5) for _ in range(total - 7))]

    assert got == ref
    steps = [g[0] for g in got]
    assert steps == list(range(total))  # zero skipped, zero duplicated
    sched = resumed.plan.schedule(total)
    assert [g[1] for g in got] == [name for name, _ in sched]


# ---------------------------------------------------------------------------
# Mix-aware lifecycle: trim never reclaims a step the mix still needs
# ---------------------------------------------------------------------------

def test_per_stream_trim_respects_mix_low_watermark():
    store = MemoryObjectStore()
    session = _open(store, expected_ranks=1)
    for i, name in enumerate(session.stream_names):
        _fill_stream(session, name, 10, seed=300 + i)
    r = session.reader(dp_rank=0, cp_rank=0)
    consumed = 11
    for _ in range(consumed):
        r.next_batch(timeout_s=5)
    ck = r.checkpoint()
    session.save_watermark(0, ck)
    deleted = session.reclaim()
    assert deleted > 0  # something below the mix watermark was reclaimed

    # every TGB at/above each stream's mix-aware cursor must still be readable:
    # a second rank restoring from the same composite checkpoint replays fine
    r2 = session.reader(dp_rank=1, cp_rank=0, resume=ck)
    remaining = session.published_steps() - consumed
    for _ in range(remaining):
        assert r2.next_batch(timeout_s=5) is not None

    # and per stream, nothing at/above the checkpoint cursor was deleted
    counts = session.plan.stream_counts(consumed)
    for name in session.stream_names:
        stats = session.reclaim_stats[name]
        view = session.manifest_view(name)
        assert stats.tgbs_deleted <= counts[name]
        live = {t.object_key for t in view.tgbs}
        for sstep in range(counts[name], view.total_steps):
            key = view.tgb_at_step(sstep).object_key
            assert key in live and store.exists(key), (name, sstep)


def test_watermark_requires_composite_checkpoint():
    session = _open(MemoryObjectStore())
    with pytest.raises(ValueError, match="composite"):
        session.save_watermark(0, Checkpoint("tgb", version=0, step=1))


# ---------------------------------------------------------------------------
# Satellite regressions: bounded latency stats
# ---------------------------------------------------------------------------

def test_latency_window_bounds_memory_keeps_exact_totals():
    w = LatencyWindow(maxlen=16)
    for i in range(1000):
        w.append(float(i))
    assert len(w) == 16                      # tail is bounded
    assert w.count == 1000                   # running count stays exact
    assert w.total == sum(range(1000))       # running sum stays exact
    assert sorted(w) == [float(x) for x in range(984, 1000)]
    assert w.mean == pytest.approx(499.5)


def test_consumer_and_mq_latency_stats_are_bounded():
    from repro_torch.core import ConsumerStats
    from repro_torch.data.mq import KafkaSimBroker, KafkaTGBConsumer

    assert isinstance(ConsumerStats().read_latencies, LatencyWindow)
    consumer = KafkaTGBConsumer(KafkaSimBroker(), 0, 0, 1, 1)
    assert isinstance(consumer.read_latencies, LatencyWindow)


# ---------------------------------------------------------------------------
# Multi-stream (MixedReader) resize: twins of tests/test_elastic.py:225-292
# ---------------------------------------------------------------------------

RESIZE_NS = "runs/test_elastic"


def _fill(session, n, nbytes=192, stream=None):
    kw = {} if stream is None else {"stream": stream}
    with session.writer(f"P-{stream or 'single'}", **kw) as w:
        for _ in range(n):
            w.write(uniform_slice_bytes=nbytes)
        w.flush()


def _flat(readers, n_steps):
    """n_steps global batches as one concatenated byte string."""
    out = []
    for _ in range(n_steps):
        batches = [r.next_batch(timeout_s=10) for r in readers]
        assert len({b.step for b in batches}) == 1
        out.append(b"".join(b.payload for b in batches))
    return b"".join(out)


RESIZE_WEIGHTS = {"web": 0.7, "code": 0.3}


def _open_mix(store, dp, resume=None):
    return open_dataplane(store, Topology(dp=dp, cp=1), backend="tgb",
                          namespace=RESIZE_NS, streams=RESIZE_WEIGHTS, mix_seed=11,
                          resume=resume)


@pytest.mark.parametrize("new_dp", [4, 1])
def test_mixed_resize_replays_identical_bytes(new_dp):
    store = MemoryObjectStore()
    sess = _open_mix(store, dp=2)
    for name in RESIZE_WEIGHTS:
        _fill(sess, 12, stream=name)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 6)
    token = readers[0].checkpoint()
    assert token.mix_pos == 6 and token.data_dp == 2
    baseline = _flat(readers, 6)

    resized = _open_mix(store, dp=new_dp, resume=token.encode())
    new_readers = [resized.reader(dp_rank=d) for d in range(new_dp)]
    assert _flat(new_readers, 6 * 2 // new_dp) == baseline


def test_mixed_resized_checkpoint_round_trips_back():
    """A composite token captured on a resized mesh restores on the original
    mesh too (cursors are stored in materialized units)."""
    store = MemoryObjectStore()
    sess = _open_mix(store, dp=2)
    for name in RESIZE_WEIGHTS:
        _fill(sess, 12, stream=name)
    r2 = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(r2, 4)
    token = r2[0].checkpoint()
    baseline = _flat(r2, 8)

    grown = _open_mix(store, dp=4, resume=token.encode())
    g4 = [grown.reader(dp_rank=d) for d in range(4)]
    _flat(g4, 2)                              # four more materialized steps
    regrown_token = g4[0].checkpoint()
    assert regrown_token.mix_pos == 8

    back = _open_mix(store, dp=2, resume=regrown_token.encode())
    b2 = [back.reader(dp_rank=d) for d in range(2)]
    assert _flat(b2, 4) == baseline[len(baseline) // 2:]


def test_mixed_composite_validation_still_guards_mix_config():
    store = MemoryObjectStore()
    sess = _open_mix(store, dp=2)
    for name in RESIZE_WEIGHTS:
        _fill(sess, 8, stream=name)
    r = sess.reader()
    for _ in range(4):
        r.next_batch(timeout_s=10)
    token = r.checkpoint()
    other = open_dataplane(store, Topology(dp=2, cp=1), backend="tgb",
                           namespace=RESIZE_NS,
                           streams={"web": 0.3, "code": 0.7}, mix_seed=11)
    with pytest.raises(ValueError, match="MixPlan"):
        other.reader().restore(token)


# ---------------------------------------------------------------------------
# Across packages: the schedule, the mixed payload sequence, composite tokens
# ---------------------------------------------------------------------------

XWEIGHTS = {"web": 0.5, "code": 0.3, "filtered": 0.2}
XTOPO_ARGS = dict(dp=2, cp=2, global_batch=4, seq_len=16)
XNS = "runs/xmix"
XSTEPS = 14


def _packages():
    pytest.importorskip("msgpack")
    import repro.core as jcore
    import repro.dataplane as jdp
    import repro_torch.core as tcore
    import repro_torch.dataplane as tdp

    return {"repro": (jdp, jcore), "repro_torch": (tdp, tcore)}


def _view(store, core):
    """``core``'s MemoryObjectStore over ``store``'s objects."""
    twin = core.MemoryObjectStore()
    twin._objects, twin._lock = store._objects, store._lock
    return twin


def _write_mix(pkg, core, seed=11):
    """A store holding a 3-stream mix written by ``pkg``'s producers: each
    stream as many token grids as ``stream_counts(XSTEPS)`` names."""
    store = core.MemoryObjectStore()
    sess = pkg.open_dataplane(store, pkg.Topology(**XTOPO_ARGS),
                              namespace=XNS, streams=XWEIGHTS,
                              mix_seed=seed)
    need = sess.plan.stream_counts(XSTEPS)
    per = XTOPO_ARGS["global_batch"] * XTOPO_ARGS["seq_len"]
    for i, name in enumerate(sess.stream_names):
        rng = np.random.default_rng(100 + i)
        with sess.writer(f"w-{name}", stream=name) as w:
            w.write_tokens(rng.integers(0, 49152, need[name] * per)
                           .astype(np.int32))
    sess.close()
    return store


def _read_mix(pkg, core, store, n, resume=None, weights=XWEIGHTS):
    """{(d, c): [(step, stream, payload, token after), ...]} of ``n`` steps
    read by ``pkg``'s MixedReaders."""
    sess = pkg.open_dataplane(_view(store, core), pkg.Topology(**XTOPO_ARGS),
                              namespace=XNS, streams=weights, mix_seed=11,
                              resume=resume)
    out = {}
    for d in range(XTOPO_ARGS["dp"]):
        for c in range(XTOPO_ARGS["cp"]):
            r = sess.reader(dp_rank=d, cp_rank=c)
            rows = []
            for _ in range(n):
                b = r.next_batch(timeout_s=5)
                rows.append((b.step, b.stream, b.payload,
                             r.checkpoint().encode()))
            out[(d, c)] = rows
    sess.close()
    return out


@pytest.mark.parametrize("weights,seed", [
    ({"web": 0.6, "code": 0.3, "math-sft": 0.1}, 7),
    ({"web": 0.5, "code": 0.3, "filtered": 0.2}, 11),
    ({"a": 1.0}, 0),
    ({"a": 3, "b": 1}, 123),
    ({"x": 0.01, "y": 0.99}, 5),
    ({f"s{i}": i + 1 for i in range(7)}, 2),
])
def test_schedule_equals_the_reference(weights, seed):
    pytest.importorskip("msgpack")
    from repro.streams import MixPlan as JaxPlan

    ours, ref = MixPlan(weights, seed=seed), JaxPlan(weights, seed=seed)
    assert ours.schedule(700) == ref.schedule(700)
    assert ours.names == ref.names and ours.weights == ref.weights
    for g in (0, 1, 13, 699, 9000):
        assert ours.position(g) == ref.position(g)
        assert ours.stream_counts(g) == ref.stream_counts(g)
    published = ref.stream_counts(50)
    assert ours.frontier(published) == ref.frontier(published) == 50


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_mix_reads_back_identically_in_both_packages(writer):
    pkgs = _packages()
    store = _write_mix(*pkgs[writer])
    got = {name: _read_mix(pkg, core, store, XSTEPS)
           for name, (pkg, core) in pkgs.items()}
    assert got["repro_torch"] == got["repro"]   # tokens byte-identical too
    plan = MixPlan(XWEIGHTS, seed=11)
    rows = got["repro_torch"][(1, 1)]
    assert [(s, n) for s, n, _, _ in rows] == \
        [(g, plan.position(g)[0]) for g in range(XSTEPS)]
    assert {n for _, n, _, _ in rows} == set(XWEIGHTS)


@pytest.mark.parametrize("minted_by", ["repro", "repro_torch"])
def test_composite_tokens_restore_across_packages(minted_by):
    pkgs = _packages()
    store = _write_mix(*pkgs["repro_torch"])
    full = _read_mix(*pkgs["repro"], store, XSTEPS)
    first = _read_mix(*pkgs[minted_by], store, 6)
    token = first[(0, 0)][-1][3]
    ck = Checkpoint.decode(token)
    assert ck.composite and ck.mix_pos == 6 and ck.step == 6
    assert [s for _, _, s in ck.streams] == \
        [MixPlan(XWEIGHTS, seed=11).stream_counts(6)[n]
         for n in sorted(XWEIGHTS)]
    other = "repro" if minted_by == "repro_torch" else "repro_torch"
    rest = _read_mix(*pkgs[other], store, XSTEPS - 6, resume=token)
    for pos, rows in rest.items():
        assert [r[:3] for r in rows] == [r[:3] for r in full[pos][6:]]
        assert [r[3] for r in rows] == [r[3] for r in full[pos][6:]]
    # a token of a different mix (web and code swapped) is refused by both
    # packages alike
    swapped = {**XWEIGHTS, "web": XWEIGHTS["code"], "code": XWEIGHTS["web"]}
    for pkg, core in pkgs.values():
        with pytest.raises(ValueError, match="MixPlan"):
            _read_mix(pkg, core, store, 1, resume=token, weights=swapped)
